"""Spatial profile observables, the ``fix ave/chunk`` analog (port of
``meso_tpu/obs/profiles.py``).

Particles are binned along one coordinate and per-bin counts and sums of a
weight are accumulated: masked segment sums that stay on the device. They
give the Poiseuille and Couette velocity profiles, the flow-frame
temperature, and the eDPD and tDPD field profiles.
"""

from __future__ import annotations

import torch


def bin_index(x, axis: int, lo, hi, nbins: int) -> torch.Tensor:
    t = (x[:, axis] - lo) / (hi - lo)
    return torch.clamp((t * nbins).to(torch.int32), 0, nbins - 1)


def profile(x, weights, mask, axis: int, lo, hi, nbins: int):
    """Returns (count per bin, sum of weights per bin (nbins, D)).

    ``weights`` may be (N,) or (N, D), e.g. C for concentration."""
    idx = bin_index(x, axis, lo, hi, nbins).long()
    idx = torch.where(mask, idx, nbins)  # masked rows -> overflow bin
    dev = x.device
    cnt = torch.zeros((nbins + 1,), dtype=torch.float32, device=dev)
    cnt.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    w = weights if weights.ndim > 1 else weights[:, None]
    w = torch.where(mask[:, None], w, torch.zeros((), device=dev))
    acc = torch.zeros((nbins + 1, w.shape[1]), dtype=torch.float32,
                      device=dev)
    acc.index_add_(0, idx, w.to(torch.float32))
    return cnt[:nbins], acc[:nbins]


def _centers(lo, hi, nbins: int, device):
    return lo + (torch.arange(nbins, device=device) + 0.5) * (hi - lo) / nbins


def _select(state, typ):
    return state.mask if typ is None else (state.mask & (state.typ == typ))


def velocity_profile(state, axis: int, flow_axis: int, nbins: int,
                     typ: int | None = None):
    """Mean flow velocity vs coordinate. Returns (bin centres, per-bin
    mean, count)."""
    lo, hi = state.box.lo[axis], state.box.hi[axis]
    cnt, acc = profile(state.x, state.v[:, flow_axis], _select(state, typ),
                       axis, lo, hi, nbins)
    return (_centers(lo, hi, nbins, state.device),
            acc[:, 0] / torch.clamp(cnt, min=1.0), cnt)


def temperature_profile(state, mass, axis: int, nbins: int,
                        typ: int | None = None, subtract_flow: bool = True):
    """Per-bin kinetic temperature; ``mass`` is per particle (N,). With
    ``subtract_flow`` each bin's mean velocity is removed first (the
    thermal temperature, not the flow's kinetic energy). Returns (bin
    centres, per-bin kT, count)."""
    mask = _select(state, typ)
    lo, hi = state.box.lo[axis], state.box.hi[axis]
    cnt, mv = profile(state.x, mass[:, None] * state.v, mask, axis, lo, hi,
                      nbins)
    _, mv2 = profile(state.x, mass * torch.sum(state.v ** 2, -1), mask, axis,
                     lo, hi, nbins)
    _, msum = profile(state.x, mass, mask, axis, lo, hi, nbins)
    cnt_safe = torch.clamp(cnt, min=1.0)
    if subtract_flow:
        vbar = mv / torch.clamp(msum, min=1e-9)
        flow2 = torch.sum(vbar ** 2, -1) * msum[:, 0]
        kt = (mv2[:, 0] - flow2) / (3.0 * cnt_safe)
    else:
        kt = mv2[:, 0] / (3.0 * cnt_safe)
    return _centers(lo, hi, nbins, state.device), kt, cnt


def field_profile(state, field, axis: int, nbins: int,
                  typ: int | None = None):
    """Mean of a per-particle field vs coordinate (eDPD T, tDPD C).
    Returns (bin centres, per-bin mean (nbins, D), count)."""
    lo, hi = state.box.lo[axis], state.box.hi[axis]
    cnt, acc = profile(state.x, field, _select(state, typ), axis, lo, hi,
                       nbins)
    return (_centers(lo, hi, nbins, state.device),
            acc / torch.clamp(cnt, min=1.0)[:, None], cnt)
