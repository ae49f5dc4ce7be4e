"""Config 1 — the classic Groot-Warren DPD fluid (port of
``meso_tpu/models/classic.py``; BASELINE.json configs[0]).

rho=3, a=25, gamma=4.5 (sigma=3 at kT=1), rc=1, cubic box. A 70^3 box holds
1,029,000 particles.
"""

from __future__ import annotations

import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import State, create_random
from meso_tpu_torch.core.system import (System, SystemParams, fit_capacity,
                                        setup)
from meso_tpu_torch.ops.dpd import DPDParams


def classic_fluid(l: float = 32.0, density: float = 3.0, kt: float = 1.0,
                  a: float = 25.0, gamma: float = 4.5, rc: float = 1.0,
                  dt: float = 0.01, seed: int = 928459, init_seed: int = 0,
                  skin: float = 0.3, rebuild_every: int = 10,
                  rng_mode: str = "tea", force_path: str = "nlist",
                  spill: bool | None = None, pair_kernel: str = "v3",
                  rebuild: str = "gather", capacity: int | None = None,
                  wrap_mode: str = "step", z_chunks: int = 0,
                  device="cuda") -> tuple[System, SystemParams, State]:
    """Build (system, params, state) for the classic fluid, forces set, on
    ``device``: the card unless the caller asks for another (the CPU tests
    pass ``device="cpu"``); with no card, torch raises.

    The initial state is drawn from a ``torch.Generator`` seeded with
    ``init_seed`` on ``device``; its draws differ from the JAX package's.
    spill defaults to on for force_path="pallas". With ``capacity`` None
    the bucket capacity is sized from the density and raised, where this
    start needs it, by ``fit_capacity``; a given capacity is kept."""
    device = torch.device(device)
    box = Box.cubic(l, device=device)
    n = int(round(density * l ** 3))
    gen = torch.Generator(device=device)
    gen.manual_seed(init_seed)
    state = create_random(gen, n, box, kt=kt)
    params = SystemParams.build(
        DPDParams.build(a=a, gamma=gamma, rc=rc, kt=kt, seed=seed,
                        device=device))
    if spill is None:
        spill = force_path == "pallas"
    system = System.for_fluid([l] * 3, rc=rc, density=density, dt=dt,
                              skin=skin, rebuild_every=rebuild_every,
                              rng_mode=rng_mode, spill=spill,
                              rebuild=rebuild, capacity=capacity,
                              wrap_mode=wrap_mode, z_chunks=z_chunks)
    if force_path != "nlist":
        system = system.replace(force_path=force_path)
    system = system.replace(pair_kernel=pair_kernel)
    if capacity is None:
        system = fit_capacity(system, state)
    return system, params, setup(system, params, state)
