"""Cell binning with fixed-capacity padded buckets (port of
``meso_tpu/neighbor/cells.py``).

``CellConfig`` sizes the grid for every cell-based path. The neighbour-list
path re-sorts the particles by cell at each rebuild (``sort_state``) and
builds a dense (n_cells + 1, K) bucket index matrix (``build_cells``) with
one stable sort and one scatter, as the JAX package does in XLA; the
trailing bucket row is the trash cell of the padding rows, and particles
that do not fit are counted in ``overflow``. Cell ids, the sort order,
bucket indices and masks, overflow and the 27-cell stencil are bitwise the
JAX package's on the same input."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import PER_PARTICLE, State


@dataclass(frozen=True)
class CellConfig:
    """Static cell-grid configuration; cell sides are >= rc + skin, so a
    27-cell (or, with spill, 45-slot-cell) stencil covers the interaction
    range between rebuilds."""

    ncell: tuple[int, int, int]
    capacity: int          # K: slots per cell
    skin: float = 0.3
    rebuild_every: int = 10
    # right-spill packing: a cell's overflow takes the next x-cell's free
    # slots (slot-cell = true cell or true cell + 1); K ~ 1.6x mean occupancy
    spill: bool = False
    # the JAX package's rebuild engine, "gather" or "sort": accepted and
    # ignored (both engines give the same placement, and the port has one,
    # neighbor/bucket_layout.py::rebuild_buckets)
    rebuild: str = "gather"
    # System.wrap_mode="rebuild": positions are box-wrapped at rebuild time
    # only, and the pair kernel skips the per-candidate minimum image
    wrap_at_rebuild: bool = False

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.ncell
        return nx * ny * nz

    @staticmethod
    def for_box(box_lengths, rc: float, density: float, skin: float = 0.3,
                rebuild_every: int = 10, capacity: int | None = None,
                min_image_safe: bool = True, spill: bool = False,
                rebuild: str = "gather",
                wrap_at_rebuild: bool = False) -> "CellConfig":
        """Choose the grid so the cell side is >= rc + skin (host-side)."""
        l = np.asarray(box_lengths, float)
        ncell = np.maximum(np.floor(l / (rc + skin)).astype(int), 1)
        if min_image_safe:
            # a 27-stencil with periodic wrap visits a cell twice below 3
            ncell = np.maximum(ncell, 3)
        if spill and ncell[0] < 5:
            # the +-2 x-window reaches one cell twice below 5 columns
            spill = False
        if capacity is None:
            side = l / ncell
            mean_occ = density * float(np.prod(side))
            if spill:
                capacity = max(8, int(-(-1.6 * mean_occ // 8)) * 8)
            else:
                cap = int(np.ceil(mean_occ + 5.0 * np.sqrt(mean_occ) + 2.0))
                capacity = ((cap + 3) // 4) * 4
        return CellConfig(ncell=tuple(int(v) for v in ncell),
                          capacity=capacity, skin=skin,
                          rebuild_every=rebuild_every, spill=spill,
                          rebuild=rebuild, wrap_at_rebuild=wrap_at_rebuild)

    def replace(self, **kw) -> "CellConfig":
        return dataclasses.replace(self, **kw)


def max_displacement_sq(x: torch.Tensor, x_ref: torch.Tensor,
                        mask: torch.Tensor, box: Box) -> torch.Tensor:
    """Max squared displacement since rebuild (skin-trigger diagnostic), a
    0-d float32 tensor. On a CUDA tensor the kernel
    ``meso_max_displacement`` of ``csrc/bucket_assign.cu`` (a memset and
    one launch, counted as ``"max_displacement"``), bitwise the plain
    chain's; on any other device the plain chain
    (``max_displacement_sq_plain``)."""
    if x.device.type != "cuda":
        return max_displacement_sq_plain(x, x_ref, mask, box)
    # imported here: kernels.common imports this module
    from meso_tpu_torch.kernels import _build
    from meso_tpu_torch.kernels.common import check_cuda
    x, x_ref, mask = x.contiguous(), x_ref.contiguous(), mask.contiguous()
    n = x.shape[0]
    check_cuda({"x": (x, torch.float32, (n, 3)),
                "x_ref": (x_ref, torch.float32, (n, 3)),
                "mask": (mask, torch.bool, (n,)),
                "box.lo": (box.lo, torch.float32, (3,)),
                "box.hi": (box.hi, torch.float32, (3,))})
    if n >= 2 ** 31:
        raise ValueError("max_displacement_sq: the kernel takes fewer than "
                         "2**31 rows")
    out = torch.empty((), dtype=torch.float32, device=x.device)
    _build.launch("max_displacement", "meso_max_displacement", x.data_ptr(),
                  x_ref.data_ptr(), mask.data_ptr(), box.lo.data_ptr(),
                  box.hi.data_ptr(), out.data_ptr(), n, device=x.device)
    return out


def max_displacement_sq_plain(x: torch.Tensor, x_ref: torch.Tensor,
                              mask: torch.Tensor, box: Box) -> torch.Tensor:
    """``max_displacement_sq`` in plain torch."""
    d = box.min_image(x - x_ref)
    d2 = torch.sum(d * d, dim=-1)
    return torch.max(torch.where(mask, d2, torch.zeros_like(d2)))


@dataclass(frozen=True)
class CellList:
    """What ``build_cells`` produces, valid until the next rebuild."""

    cid: torch.Tensor          # (N,) int32 cell id per sorted row; trash
    #                            cell n_cells for padding rows
    bucket_idx: torch.Tensor   # (n_cells + 1, K) int32 row index, N empty
    bucket_mask: torch.Tensor  # (n_cells + 1, K) bool, a particle's slot
    overflow: torch.Tensor     # () int64 particles that did not fit
    x_ref: torch.Tensor        # (N, 3) positions at the rebuild

    def replace(self, **kw) -> "CellList":
        return dataclasses.replace(self, **kw)


def cell_index(x: torch.Tensor, mask: torch.Tensor, box: Box,
               cfg: CellConfig) -> torch.Tensor:
    """Row-major int32 cell id per particle; masked rows get the trash cell
    n_cells."""
    nx, ny, nz = cfg.ncell
    frac = (x - box.lo) / box.lengths
    c = [torch.clamp((frac[:, d] * float(n)).to(torch.int32), 0, n - 1)
         for d, n in enumerate(cfg.ncell)]
    cid = (c[2] * ny + c[1]) * nx + c[0]
    return torch.where(mask, cid, cfg.n_cells).to(torch.int32)


def sort_state(state: State, cfg: CellConfig) -> tuple[State, torch.Tensor]:
    """Stable-sort every per-particle tensor by cell id. Returns
    (sorted state, sorted cid)."""
    cid = cell_index(state.x, state.mask, state.box, cfg)
    cid_s, order = torch.sort(cid, stable=True)
    return state.replace(**{
        name: None if getattr(state, name) is None
        else getattr(state, name)[order] for name in PER_PARTICLE}), cid_s


def build_cells(state: State, cfg: CellConfig) -> tuple[State, CellList]:
    """Re-sort the particles by cell and build the padded buckets: a
    particle's slot is its rank within its cell, found by a binary search
    for the cell's first sorted row."""
    state, cid = sort_state(state, cfg)
    n, k, n_cells = state.n, cfg.capacity, cfg.n_cells
    dev = state.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(
        cid, torch.arange(n_cells + 1, dtype=cid.dtype, device=dev),
        side="left")
    rank = iota - starts[cid.long()].to(torch.int32)
    fits = rank < k
    overflow = torch.sum(~fits & state.mask)
    last = (n_cells + 1) * k - 1
    slot = cid.long() * k + torch.clamp(rank, max=k - 1).long()
    src = torch.where(fits, iota, n)
    flat = torch.full(((n_cells + 1) * k,), n, dtype=torch.int32, device=dev)
    flat[slot[fits]] = src[fits]
    # the rows that do not fit all write the sentinel to the last trash
    # slot, which a trash row of rank K - 1 may also write: the JAX
    # scatter applies its updates in row order, so the last writer wins
    writers = ~fits | (slot == last)
    final = torch.max(torch.where(writers, iota, -1))
    flat[last] = torch.where(final >= 0, src[torch.clamp(final, min=0)],
                             flat[last])
    bucket_idx = flat.reshape(n_cells + 1, k)
    bucket_mask = bucket_idx < n
    bucket_mask[n_cells] = False
    return state, CellList(cid=cid, bucket_idx=bucket_idx,
                           bucket_mask=bucket_mask, overflow=overflow,
                           x_ref=state.x)


def stencil_cells(cid: torch.Tensor, cfg: CellConfig) -> torch.Tensor:
    """(..., 27) int32 periodic 27-stencil cell ids of each cell id, x
    fastest; the trash cell maps to 27 trash cells, whose buckets are
    empty."""
    nx, ny, nz = cfg.ncell
    is_trash = cid == cfg.n_cells
    c = torch.where(is_trash, 0, cid)
    cx, cy, cz = c % nx, (c // nx) % ny, c // (nx * ny)
    off = torch.arange(-1, 2, dtype=torch.int32, device=cid.device)
    ox = off.repeat(9)
    oy = off.repeat_interleave(3).repeat(3)
    oz = off.repeat_interleave(9)
    sx = torch.remainder(cx[..., None] + ox, nx)
    sy = torch.remainder(cy[..., None] + oy, ny)
    sz = torch.remainder(cz[..., None] + oz, nz)
    s = (sz * ny + sy) * nx + sx
    return torch.where(is_trash[..., None], cfg.n_cells, s).to(torch.int32)
