"""Config 2 — Poiseuille and Couette flow between frozen-particle walls
(port of ``meso_tpu/models/walls.py``; BASELINE.json configs[1]).

Periodic box; wall slabs (type 1, frozen) at y < w and y > H - w, fluid
(type 0) in the channel [w, H - w], bounce-back planes at the two
fluid-wall interfaces. Poiseuille adds a body force g along x on the fluid;
Couette gives the walls velocities -U/2 and +U/2 along x and moves them.
The pair table is 2 x 2, so force_path "pallas" runs K1's general variant.
"""

from __future__ import annotations

import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import State, create_random
from meso_tpu_torch.core.system import (System, SystemParams, fit_capacity,
                                        setup)
from meso_tpu_torch.ops.dpd import DPDParams
from meso_tpu_torch.ops.fixes import FixBodyForce, FixBounceBack, FixWallMove


def _channel(lx: float, h: float, lz: float, wall_width: float,
             density: float, kt: float, a, gamma, rc, dt, seed, init_seed,
             force_path: str, rng_mode: str, skin: float, device):
    """Random start on ``device`` from a torch.Generator seeded with
    ``init_seed`` (its draws differ from the JAX package's), wall beads
    typed 1 and at rest."""
    device = torch.device(device)
    box = Box.orthorhombic(lx, h, lz, device=device)
    n = int(round(density * lx * h * lz))
    gen = torch.Generator(device=device)
    gen.manual_seed(init_seed)
    state = create_random(gen, n, box, kt=kt)
    in_wall = (state.x[:, 1] < wall_width) | (state.x[:, 1] > h - wall_width)
    state = state.replace(typ=in_wall.to(torch.int32),
                          v=torch.where(in_wall[:, None], 0.0, state.v))
    params = SystemParams.build(
        DPDParams.build(a=a, gamma=gamma, rc=rc, kt=kt, seed=seed, n_types=2,
                        device=device))
    system = System.for_fluid([lx, h, lz], rc=rc, density=density, dt=dt,
                              skin=skin, rng_mode=rng_mode,
                              spill=force_path == "pallas")
    if force_path != "nlist":
        system = system.replace(force_path=force_path)
    return state, params, system


def poiseuille(lx: float = 10.0, h: float = 6.0, lz: float = 10.0,
               wall_width: float = 1.0, density: float = 3.0, g: float = 0.1,
               kt: float = 1.0, a: float = 25.0, gamma: float = 4.5,
               rc: float = 1.0, dt: float = 0.01, seed: int = 7771,
               init_seed: int = 1, force_path: str = "nlist",
               rng_mode: str = "fast", skin: float = 0.3,
               device="cuda") -> tuple[System, SystemParams, State]:
    """Body-force-driven channel flow. Returns (system, params, state),
    forces set, on ``device`` (the card unless the caller asks for
    another). Spill buckets for force_path "pallas", and the bucket
    capacity fitted to the start (``fit_capacity``)."""
    state, params, system = _channel(
        lx, h, lz, wall_width, density, kt, a, gamma, rc, dt, seed,
        init_seed, force_path, rng_mode, skin, device)
    system = system.replace(
        frozen_types=(1,),
        fixes=(FixBodyForce(fx=g, typ=0),
               FixBounceBack(axis=1, lo=wall_width, hi=h - wall_width)))
    system = fit_capacity(system, state)
    return system, params, setup(system, params, state)


def couette(u: float = 1.0, lx: float = 10.0, h: float = 6.0,
            lz: float = 10.0, wall_width: float = 1.0, density: float = 3.0,
            kt: float = 1.0, a: float = 25.0, gamma: float = 4.5,
            rc: float = 1.0, dt: float = 0.01, seed: int = 7772,
            init_seed: int = 2, force_path: str = "nlist",
            rng_mode: str = "fast", skin: float = 0.3,
            device="cuda") -> tuple[System, SystemParams, State]:
    """Shear flow: lower wall at -U/2, upper wall at +U/2 along x."""
    state, params, system = _channel(
        lx, h, lz, wall_width, density, kt, a, gamma, rc, dt, seed,
        init_seed, force_path, rng_mode, skin, device)
    wall = state.typ == 1
    lower = wall & (state.x[:, 1] < h * 0.5)
    upper = wall & ~lower
    # the wall beads are at rest: only their x velocity is set
    vx = torch.where(lower, -u / 2, torch.where(upper, u / 2, state.v[:, 0]))
    state = state.replace(v=torch.stack([vx, state.v[:, 1], state.v[:, 2]],
                                        -1))
    system = system.replace(
        frozen_types=(1,),
        fixes=(FixBounceBack(axis=1, lo=wall_width, hi=h - wall_width,
                             u_lo=(-u / 2, 0.0, 0.0),
                             u_hi=(u / 2, 0.0, 0.0)),
               FixWallMove(typ=1)))
    system = fit_capacity(system, state)
    return system, params, setup(system, params, state)
