"""Spatial profile observables, the ``fix ave/chunk`` analog (port of the
parts of ``meso_tpu/obs/profiles.py`` the transport validations use).

Particles are binned along one coordinate and per-bin counts and sums of a
weight are accumulated: masked segment sums that stay on the device. The
velocity and temperature profiles are ROADMAP Queue 1 item 11.
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


def field_profile(state, field, axis: int, nbins: int,
                  typ: int | None = None):
    """Mean of a per-particle field vs coordinate (eDPD T, tDPD C).
    Returns (bin centres, per-bin mean (nbins, D), count)."""
    mask = state.mask if typ is None else (state.mask & (state.typ == typ))
    lo = state.box.lo[axis]
    hi = state.box.hi[axis]
    cnt, acc = profile(state.x, field, mask, axis, lo, hi, nbins)
    centers = lo + (torch.arange(nbins, device=state.device) + 0.5) \
        * (hi - lo) / nbins
    return centers, acc / torch.clamp(cnt, min=1.0)[:, None], cnt
