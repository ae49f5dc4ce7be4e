"""Padded full neighbour lists built from cell buckets (port of
``meso_tpu/neighbor/nlist.py``).

Per particle, the candidates of its 27-cell stencil are tested against
(rc + skin)^2 and compacted into a padded (N, M) index matrix by a
cumulative-sum rank and one scatter: no atomics, fixed shapes. The lists
are full (each particle lists every neighbour), so force accumulation has
one writer per particle. Rows with more than M neighbours are counted in
``overflow``. The stencil and candidate order are the JAX package's, so
``idx``, ``n_neigh`` and ``overflow`` are bitwise equal to its lists.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.neighbor.cells import CellConfig, CellList, stencil_cells


@dataclass(frozen=True)
class NeighborList:
    """(N, M) full neighbour matrix in the current sorted order."""

    idx: torch.Tensor       # (N, M) int32 neighbour rows, N where empty
    n_neigh: torch.Tensor   # (N,) int32 neighbour count (may exceed M)
    overflow: torch.Tensor  # () neighbours dropped for want of M

    def replace(self, **kw) -> "NeighborList":
        return dataclasses.replace(self, **kw)


def neighbor_capacity(density: float, rc: float, skin: float) -> int:
    """Static M from mean full-list occupancy with Poisson headroom."""
    mean = density * 4.0 / 3.0 * np.pi * (rc + skin) ** 3
    m = int(np.ceil(mean + 6.0 * np.sqrt(mean) + 4.0))
    return ((m + 7) // 8) * 8


def build_nlist(x: torch.Tensor, mask: torch.Tensor, box: Box,
                cells: CellList, cfg: CellConfig, rc_max: float, m_cap: int,
                block: int = 2048) -> NeighborList:
    """Build the padded neighbour matrix from the cell buckets, ``block``
    particles at a time: a block's candidate tensor is (block, 27 K), which
    bounds the build's memory at a million particles. It runs on the
    rebuild cadence only."""
    n = x.shape[0]
    k = cfg.capacity
    dev = x.device
    cutoff_sq = torch.tensor((rc_max + cfg.skin) ** 2, dtype=torch.float32,
                             device=dev)
    sten = stencil_cells(cells.cid, cfg).long()            # (N, 27)
    bidx = cells.bucket_idx.reshape(-1)
    bmask = cells.bucket_mask.reshape(-1)
    slots = torch.arange(k, device=dev)
    idx = torch.empty((n, m_cap), dtype=torch.int32, device=dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    for b0 in range(0, n, block):
        i_blk = torch.arange(b0, min(b0 + block, n), device=dev)
        nb = i_blk.numel()
        flat = (sten[i_blk][:, :, None] * k + slots).reshape(nb, 27 * k)
        cand = bidx[flat]
        cmask = bmask[flat]
        xj = x[torch.clamp(cand, max=n - 1).long()]           # (B, 27K, 3)
        dr = box.min_image(x[i_blk][:, None, :] - xj)
        r2 = torch.sum(dr * dr, dim=-1)
        hit = cmask & (cand != i_blk[:, None]) & (r2 < cutoff_sq)
        # rank-and-scatter compaction; slot m_cap takes the dropped ones
        pos = torch.cumsum(hit.to(torch.int32), dim=1) - 1
        keep = hit & (pos < m_cap)
        row = torch.full((nb, m_cap + 1), n, dtype=torch.int32, device=dev)
        row.scatter_(1, torch.where(keep, pos, m_cap).long(),
                     torch.where(keep, cand, n))
        idx[b0:b0 + nb] = row[:, :m_cap]
        counts[b0:b0 + nb] = torch.sum(hit, dim=1).to(torch.int32)
    n_neigh = torch.where(mask, counts, 0)
    overflow = torch.sum(torch.clamp(n_neigh - m_cap, min=0))
    return NeighborList(idx=idx, n_neigh=n_neigh, overflow=overflow)
