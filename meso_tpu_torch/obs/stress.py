"""Per-particle virial and local pressure profiles, the ``compute
stress/atom`` + ``fix ave/chunk`` analogs (port of
``meso_tpu/obs/stress.py``).

The 27-offset sweep (``ops/sweep.py``), taken a few cell rows along y at
a time, gives each particle's half-virial sum w_i = 0.5 sum_j r_ij . F_ij,
from which the local pressure follows:
P(bin) = [sum_i m_i v_i^2 + sum_i w_i] / (3 V_bin).

The JAX package always takes the fast RNG tier and type 0's coefficients
here (``classic_pair_fn(params.pair, system.dt)``; ROADMAP Queue 3, R14),
so its virial belongs to another system whenever the system runs TEA,
more than one type or exclusions. This one takes the system's tier, type
table, s_exp and exclusions, as its force path does.
"""

from __future__ import annotations

import torch

from meso_tpu_torch.core.state import State
from meso_tpu_torch.core.system import System, SystemParams, _per_type
from meso_tpu_torch.obs.profiles import profile


# cell rows along y a sweep takes at once (with one ghost row a side): the
# sums do not depend on it, the temporaries' size and the CPU's cache reuse
# do (a sweep over all of a 1M grid at once holds ~12 GB of temporaries)
_Y_BLOCK = 4


def per_particle_virial(system: System, params: SystemParams,
                        state: State) -> torch.Tensor:
    """(N,) half-virial of each bucket row (classic DPD).

    ``state`` must be bucket-resident on the system's strict cells (the
    sweep walks a +-1 cell window); a spill layout, another model or a
    state not in bucket rows raises ValueError."""
    from meso_tpu_torch.neighbor.bucket_layout import n_rows
    from meso_tpu_torch.ops.bucket_dpd import (exclusion_channels,
                                               model_channels,
                                               require_strict)
    from meso_tpu_torch.ops.sweep import classic_pair_fn, sweep

    if system.model != "dpd":
        raise ValueError(f"per_particle_virial takes classic DPD, not "
                         f"{system.model!r}")
    cfg = system.cells
    if cfg is None:
        raise ValueError("per_particle_virial needs the system's cells")
    require_strict(cfg, "per_particle_virial")
    if state.n != n_rows(cfg):
        raise ValueError(f"the state has {state.n} rows, not the "
                         f"{n_rows(cfg)} bucket rows of the system's cells")
    pair = params.pair
    ch = model_channels(state.x, state.v, state.typ, state.tag, state.mask,
                        state.step, pair, cfg, {}, system.rng_mode,
                        system.rng_rounds)
    ch.update(exclusion_channels(state.tag, pair, ch["tag"].shape))
    n_excl = 0 if pair.excl is None else pair.excl.shape[1]
    pair_fn = classic_pair_fn(pair, system.dt, rng_mode=system.rng_mode,
                              step=state.step, rng_rounds=system.rng_rounds,
                              multitype=pair.n_types > 1, n_excl=n_excl)
    nx, ny, nz = cfg.ncell
    out = []
    for y0 in range(0, ny, _Y_BLOCK):
        rows = min(_Y_BLOCK, ny - y0)
        ys = torch.arange(y0 - 1, y0 + rows + 1, device=state.device) % ny
        acc = sweep({k: v[ys] for k, v in ch.items()}, (nx, rows, nz),
                    cfg.capacity, (True, False, False), state.box.lengths,
                    pair_fn, 4)
        out.append(acc[3])
    return torch.cat(out).reshape(state.n)


def pressure_profile(system: System, params: SystemParams, state: State,
                     axis: int, nbins: int):
    """(bin centres, P(bin)): the local pressure along one axis."""
    w = per_particle_virial(system, params, state)
    mass = _per_type(params.mass, state.typ)
    ke2 = mass * torch.sum(state.v ** 2, -1)
    lo = state.box.lo[axis]
    hi = state.box.hi[axis]
    cnt, acc = profile(state.x, ke2 + w, state.mask, axis, lo, hi, nbins)
    v_bin = state.box.volume / nbins
    centers = lo + (torch.arange(nbins, device=state.device) + 0.5) \
        * (hi - lo) / nbins
    return centers, acc[:, 0] / (3.0 * v_bin)
