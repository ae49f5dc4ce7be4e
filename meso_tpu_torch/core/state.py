"""The simulation State (port of ``meso_tpu/core/state.py``).

One frozen dataclass of fixed-shape structure-of-arrays tensors, with the
JAX package's field names. ``mask`` marks valid rows; ``tag`` carries
particle identity, so observables and the pair RNG do not depend on row
order.

Unlike the JAX pytree, ``step`` is a Python int: the step loop runs on the
host here, and the kernels take the step as a launch argument, so keeping
it on the host saves a device-to-host copy per step.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from meso_tpu_torch.core.box import Box

# per-particle fields, in the order the rebuild carries them
PER_PARTICLE = ("x", "v", "f", "typ", "tag", "image", "mask", "mol",
                "T", "dTdt", "C", "dCdt")


@dataclass(frozen=True)
class State:
    """Per-particle tensors + box + step counter."""

    x: torch.Tensor        # (N, 3) float32 positions
    v: torch.Tensor        # (N, 3) float32 velocities
    f: torch.Tensor        # (N, 3) float32 forces from the last evaluation
    typ: torch.Tensor      # (N,)  int32 particle type, 0-based
    tag: torch.Tensor      # (N,)  int32 unique id, 1-based (0 = padding)
    image: torch.Tensor    # (N, 3) int32 periodic image flags
    mask: torch.Tensor     # (N,)  bool, False for padding rows
    mol: torch.Tensor      # (N,)  int32 molecule id (0 = none)
    box: Box
    step: int              # timestep counter
    T: Optional[torch.Tensor] = None      # (N,)  eDPD internal temperature
    dTdt: Optional[torch.Tensor] = None   # (N,)  eDPD heat-rate accumulator
    C: Optional[torch.Tensor] = None      # (N, S) tDPD concentrations
    dCdt: Optional[torch.Tensor] = None   # (N, S) tDPD flux accumulator

    @property
    def n(self) -> int:
        """Capacity (padded row count); ``n_valid()`` counts real rows."""
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def n_valid(self) -> torch.Tensor:
        return torch.sum(self.mask.to(torch.int32))

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


def zeros_state(n: int, box: Box, n_species: int = 0,
                with_energy: bool = False) -> State:
    dev = box.lo.device
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return State(
        x=z(n, 3), v=z(n, 3), f=z(n, 3),
        typ=z(n, dtype=i32), tag=z(n, dtype=i32), image=z(n, 3, dtype=i32),
        mask=z(n, dtype=torch.bool), mol=z(n, dtype=i32),
        box=box, step=0,
        T=torch.ones((n,), dtype=f32, device=dev) if with_energy else None,
        dTdt=z(n) if with_energy else None,
        C=z(n, n_species) if n_species else None,
        dCdt=z(n, n_species) if n_species else None,
    )


def create_random(generator: torch.Generator, n: int, box: Box,
                  kt: float = 1.0, mass: float = 1.0, typ: int = 0,
                  n_species: int = 0, with_energy: bool = False) -> State:
    """Uniform-random positions (the standard DPD start: the soft potential
    tolerates overlaps) + Maxwell velocities at ``kt``.

    ``generator`` must live on the box's device. Its draws differ from the
    JAX package's ``jax.random`` draws; the bridge carries JAX states across
    where a test needs the same start."""
    from meso_tpu_torch.core.rng import maxwell_velocities

    dev = box.lo.device
    u = torch.rand((n, 3), generator=generator, dtype=torch.float32,
                   device=dev)
    x = box.lo + u * box.lengths
    v = maxwell_velocities(generator, n, kt, mass, device=dev)
    s = zeros_state(n, box, n_species=n_species, with_energy=with_energy)
    return s.replace(
        x=x, v=v,
        typ=torch.full((n,), typ, dtype=torch.int32, device=dev),
        tag=torch.arange(1, n + 1, dtype=torch.int32, device=dev),
        mask=torch.ones((n,), dtype=torch.bool, device=dev),
    )
