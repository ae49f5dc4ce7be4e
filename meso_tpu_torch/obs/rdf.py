"""Radial distribution function g(r), the ``compute rdf`` analog (port of
``meso_tpu/obs/rdf.py``).

A dense O(N^2) histogram (validation scale only; per sample, off the hot
loop), normalised by the ideal-gas shell counts so that g(r) -> 1 at large
r.
"""

from __future__ import annotations

import math

import torch

from meso_tpu_torch.core.box import Box


# pairs a block of rows holds: bounds the (rows, N, 3) temporaries
_BLOCK_PAIRS = 1 << 24


def rdf(x, mask, box: Box, r_max: float, nbins: int = 100):
    """Returns (bin centres, g(r)). Minimum image; requires r_max < L/2.

    As in the JAX package, pairs at or beyond r_max and invalid pairs fall
    into an overflow bin ``nbins`` that is dropped. Rows are taken in
    blocks of about 2^24 pairs, so memory stays bounded at any N; the
    counts do not depend on the blocks."""
    n = x.shape[0]
    dev = x.device
    hist = torch.zeros((nbins + 1,), dtype=torch.float32, device=dev)
    rows = max(1, _BLOCK_PAIRS // max(n, 1))
    cols = torch.arange(n, device=dev)
    for i0 in range(0, n, rows):
        xi = x[i0:i0 + rows]
        dr = box.min_image(xi[:, None, :] - x[None, :, :])
        r = torch.sqrt(torch.clamp(torch.sum(dr * dr, -1), min=1e-12))
        not_self = (torch.arange(i0, i0 + xi.shape[0],
                                 device=dev)[:, None] != cols[None, :])
        valid = (mask[i0:i0 + rows, None] & mask[None, :]) & not_self
        idx = torch.clamp((r / r_max * nbins).to(torch.int64), 0, nbins)
        idx = torch.where(valid & (r < r_max), idx, nbins)
        hist.index_add_(0, idx.reshape(-1),
                        torch.ones((idx.numel(),), dtype=torch.float32,
                                   device=dev))
    hist = hist[:nbins]
    n_real = torch.sum(mask.to(torch.float32))
    rho = n_real / box.volume
    edges = torch.arange(nbins + 1, dtype=torch.float32,
                         device=dev) * (r_max / nbins)
    shell = 4.0 / 3.0 * math.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    ideal = rho * shell * n_real
    centers = 0.5 * (edges[1:] + edges[:-1])
    return centers, hist / torch.clamp(ideal, min=1e-12)
