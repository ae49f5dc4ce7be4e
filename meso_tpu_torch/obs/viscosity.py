"""Mueller-Plathe reverse-NEMD viscosity (port of
``meso_tpu/obs/viscosity.py``; Mueller-Plathe, PRE 59, 4894 (1999)).

Between production chunks the flow velocity of the most negative mover in
slab 0 is swapped with that of the most positive mover in the middle slab,
imposing a known momentum flux; the fluid answers with a linear profile
whose slope gives the shear viscosity eta = j / |dv/dz|, with j = P / (2 t
A) (the flux crosses two slab interfaces under periodicity).
"""

from __future__ import annotations

import numpy as np
import torch

from meso_tpu_torch.core.state import State


def muller_plathe_swap(state: State, mass, flow_axis: int = 0,
                       grad_axis: int = 2, nbins: int = 20):
    """Swap the flow velocity of the most negative mover in slab 0 with the
    most positive mover in the middle slab, when that moves momentum the
    right way. ``mass`` is per particle (N,). Returns (state, dp), dp the
    momentum moved (a 0-d tensor; no host synchronisation)."""
    lo = state.box.lo[grad_axis]
    lz = state.box.lengths[grad_axis]
    z = state.x[:, grad_axis] - lo
    wbin = lz / nbins
    vx = state.v[:, flow_axis]
    in0 = state.mask & (z < wbin)
    inm = state.mask & (z >= lz / 2) & (z < lz / 2 + wbin)
    i0 = torch.argmin(torch.where(in0, vx, 1e30))
    im = torch.argmax(torch.where(inm, vx, -1e30))
    v0, vm = vx[i0], vx[im]
    do = in0[i0] & inm[im] & (vm > v0)
    new_vx = vx.clone()
    new_vx[i0] = torch.where(do, vm, v0)
    new_vx[im] = torch.where(do, v0, vm)
    v = torch.stack([new_vx if c == flow_axis else state.v[:, c]
                     for c in range(3)], -1)
    m = 0.5 * (mass[i0] + mass[im])
    dp = torch.where(do, m * (vm - v0), torch.zeros((), device=vx.device))
    return state.replace(v=v), dp


def run_viscosity_mp(system, params, state, nswaps: int, swap_every: int,
                     flow_axis: int = 0, grad_axis: int = 2,
                     nbins: int = 20, warmup_frac: float = 0.5):
    """Drive the Mueller-Plathe experiment on ``run_bucket_chunked`` and
    return (eta, details); ``swap_every`` steps run between swaps. The
    per-particle masses are read after every chunk, whose rebuild moves
    rows."""
    from meso_tpu_torch.core.system import run_bucket_chunked
    from meso_tpu_torch.obs.profiles import velocity_profile

    every = system.cells.rebuild_every
    nchunks = max(swap_every // every, 1)
    measured = []
    for s in range(nswaps):
        state, _ = run_bucket_chunked(system, params, state, nchunks, every,
                                      thermo_trace=False)
        state, dp = muller_plathe_swap(state, params.mass[state.typ.long()],
                                       flow_axis, grad_axis, nbins)
        if s >= int(nswaps * warmup_frac):
            measured.append(dp)
    p_total = (float(torch.sum(torch.stack(measured).double()))
               if measured else 0.0)
    t_measured = len(measured) * nchunks * every * system.dt
    lens = state.box.lengths.cpu().numpy()
    area = float(np.prod([lens[a] for a in range(3) if a != grad_axis]))
    j = p_total / (2.0 * t_measured * area)

    # slope of the branch between slab 0 (min v) and the middle slab (max
    # v), the swap slabs themselves excluded
    zc, vprof, _ = velocity_profile(state, axis=grad_axis,
                                    flow_axis=flow_axis, nbins=nbins)
    zc, vprof = zc.cpu().numpy(), vprof.cpu().numpy()
    sl = slice(1, nbins // 2)
    slope = np.polyfit(zc[sl], vprof[sl], 1)[0]
    return j / abs(slope), {"flux": j, "slope": float(slope),
                            "p_total": p_total, "t": t_measured,
                            "profile": (zc, vprof)}
