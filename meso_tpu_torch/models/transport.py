"""Configs 3-4 — eDPD slab conduction and tDPD diffusion (port of
``meso_tpu/models/transport.py``; BASELINE.json configs[2], configs[3]).

eDPD slab: periodic box, hot and cold slabs whose particles' internal T is
reset every step (FixRegionT) -> a steady linear Fourier profile between
them.

tDPD diffusion: periodic box, an initial cosine (or step) concentration
along x; the fundamental mode decays exponentially and the total
concentration is conserved exactly.

Both builders size the bucket capacity from the density and raise it where
their random start needs more (``core.system.fit_capacity``). Spill buckets
come with force_path "pallas" only, as in the JAX package; ``pair_kernel``
(a port-only argument; the JAX builders leave it at "v3") picks the
"pallas" kernel before the set-up force evaluation: "v3" (K2, K3) or "v2"
(the fused selector K5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import State, create_random
from meso_tpu_torch.core.system import (System, SystemParams, fit_capacity,
                                        setup)
from meso_tpu_torch.ops.edpd import EDPDParams
from meso_tpu_torch.ops.tdpd import TDPDParams


@dataclass(frozen=True)
class FixRegionT:
    """Clamp the per-particle internal temperature inside two slabs along
    ``axis`` — the eDPD Fourier-slab boundary condition."""

    axis: int = 0
    hot_lo: float = 0.0
    hot_hi: float = 1.0
    cold_lo: float = 0.0
    cold_hi: float = 1.0
    t_hot: float = 1.2
    t_cold: float = 0.8

    def end_of_step(self, system, params, state):
        xa = state.x[:, self.axis]
        in_hot = (xa >= self.hot_lo) & (xa < self.hot_hi) & state.mask
        in_cold = (xa >= self.cold_lo) & (xa < self.cold_hi) & state.mask
        t = torch.where(in_hot, self.t_hot,
                        torch.where(in_cold, self.t_cold, state.T))
        return state.replace(T=t)


def _start(l: float, density: float, kt: float, init_seed: int, device,
           **kw):
    """Random start on ``device`` from a torch.Generator seeded with
    ``init_seed`` (its draws differ from the JAX package's)."""
    box = Box.cubic(l, device=device)
    n = int(round(density * l ** 3))
    gen = torch.Generator(device=device)
    gen.manual_seed(init_seed)
    return n, create_random(gen, n, box, kt=kt, **kw)


def edpd_slab(l: float = 8.0, density: float = 3.0, kt: float = 1.0,
              a: float = 25.0, gamma: float = 4.5, rc: float = 1.0,
              kappa: float = 1.0, cv: float = 100.0, t_hot: float = 1.2,
              t_cold: float = 0.8, slab_w: float = 1.0, dt: float = 0.01,
              seed: int = 331, init_seed: int = 3,
              force_path: str = "dense", skin: float = 0.3,
              device="cuda", pair_kernel: str = "v3"
              ) -> tuple[System, SystemParams, State]:
    """Hot slab at x in [0, w), cold slab at [L/2, L/2 + w): two
    half-channels by periodicity. Returns (system, params, state), forces
    set, on ``device`` (the card unless the caller asks for another)."""
    device = torch.device(device)
    n, state = _start(l, density, kt, init_seed, device,
                           with_energy=True)
    state = state.replace(T=torch.full((n,), kt, dtype=torch.float32,
                                       device=device))
    pair = EDPDParams.build(a=a, gamma=gamma, rc=rc, kappa=kappa, cv=cv,
                            seed=seed, device=device)
    params = SystemParams.build(pair)
    fix = FixRegionT(axis=0, hot_lo=0.0, hot_hi=slab_w,
                     cold_lo=l / 2, cold_hi=l / 2 + slab_w,
                     t_hot=t_hot, t_cold=t_cold)
    system = System.for_fluid([l] * 3, rc=rc, density=density, dt=dt,
                              spill=force_path == "pallas",
                              skin=skin, rng_mode="fast")
    system = system.replace(model="edpd", force_path=force_path, fixes=(fix,),
                            pair_kernel=pair_kernel)
    system = fit_capacity(system, state)
    return system, params, setup(system, params, state)


def tdpd_diffusion(l: float = 8.0, density: float = 3.0, kt: float = 1.0,
                   a: float = 25.0, gamma: float = 4.5, rc: float = 1.0,
                   kappa_c: float = 2.0, eps_c: float = 0.0,
                   rcc: float = 1.0, dt: float = 0.01, seed: int = 441,
                   init_seed: int = 4, force_path: str = "dense",
                   skin: float = 0.3, profile: str = "cosine",
                   device="cuda", pair_kernel: str = "v3"
                   ) -> tuple[System, SystemParams, State]:
    """Single-species tDPD with an initial cosine concentration mode along
    x (``profile="step"``: 1.5 below L/2, 0.5 above). Returns (system,
    params, state), forces set, on ``device`` (the card by default)."""
    device = torch.device(device)
    n, state = _start(l, density, kt, init_seed, device, n_species=1)
    if profile == "cosine":
        c0 = 1.0 + 0.5 * torch.cos(2 * math.pi * state.x[:, 0] / l)
    else:
        c0 = torch.where(state.x[:, 0] < l / 2, 1.5, 0.5)
    state = state.replace(C=c0[:, None])
    pair = TDPDParams.build(a=a, gamma=gamma, rc=rc, kt=kt,
                            kappa_c=[kappa_c], eps_c=[eps_c], rcc=rcc,
                            seed=seed, device=device)
    params = SystemParams.build(pair)
    system = System.for_fluid([l] * 3, rc=rc, density=density, dt=dt,
                              spill=force_path == "pallas",
                              skin=skin, rng_mode="fast")
    system = system.replace(model="tdpd", force_path=force_path,
                            pair_kernel=pair_kernel)
    system = fit_capacity(system, state)
    return system, params, setup(system, params, state)
