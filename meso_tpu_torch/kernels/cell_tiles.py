"""The cell tiles of the Hopper pair kernels, one device machinery
(``csrc/cell_tiles.cuh``) under two source policies: over bucket rows,
K1 (``pair_dpd_v3_kernel``), K1's general variant
(``pair_dpd_v3_general_kernel``, also K6 on one card), K2 and K3
(``pair_tdpd_v3_kernel``), all on K1's plan and table (``plan``,
``tile_table``); over a padded brick of channel planes, the brick kernel
(``csrc/pair_brick.cu``, ``pair_brick_kernel``: K4, K5, K7 and K6-halo;
``brick_plan``, ``brick_table``).
Here: their launch plans and the tables each block reads.

A block owns a tile of target cells: one (cy, cz) and a run of up to W
consecutive cx. It stages the sources of its stencil in shared memory: the
3 x 3 (dy, dz) lines, each (W + 2 xr) columns wide (xr = 2 for spill
layouts, 1 for strict ones), every slot-cell compacted to its valid rows.
What the block needs to find them is computed here, on the host, once per
grid: the kernel reads it and does no index arithmetic of its own beyond
``row = line_base + slot * ncx + sx``, so the CPU tests hold the
(target, source, shift) set the table implies against the plain
version's stencil (``_stencil_pairs``).

Row layout: row = ((cy * ncz + cz) * K + slot) * ncx + cx.

The brick (``kernels/_brick.py``) pads every plane by one cell on each
side in y and z and by xr cells on each side in x, so its tiles need no
wrap codes: a brick block stages the same 3 x 3 lines x (W + 2 xr)
columns from the brick's own coordinates, and its table holds, for each
line, the brick index of the block's first source column in slot 0
(``brick_table``). What it stages differs from the bucket rows' (no row
indices: the brick index rides in the position's fourth word, and no
shifts), so its plan sizes W on its own shared-memory layout
(``brick_smem_bytes``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

# Per SM: 228 KB of shared memory, at most 227 KB for one block, and 1 KB
# the hardware keeps for each resident block (H100, sm_90).
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMEM_RESERVED_PER_BLOCK = 1024
MAX_THREADS = 256
# in-range sources a thread collects before it evaluates them; a fuller
# list is evaluated and the walk goes on, so any density is exact
LIST_CAP = 32
# resident blocks per SM the plan sizes the tile for; a capacity too large
# for two takes one (the 227 KB of a block)
BLOCKS_PER_SM = 2
# the 3 x 3 (dy, dz) lines, dy outer: line (dy + 1) * 3 + (dz + 1); the
# target line (0, 0) is line 4
LINES = tuple((dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1))
TARGET_LINE = 4
# table row: cy, cz, cx0, width, then (line base row, y code, z code) of
# the 9 lines, then (sx, x code) of the block's source columns; a code is
# the wrap of that axis: -1 below 0, +1 above n - 1, 0 inside
HEAD = 4
LINE_FIELDS = 3
COL0 = HEAD + LINE_FIELDS * len(LINES)
# brick table row: cy, cz, cx0, width, then the 9 lines' first brick index
BRICK_TABLE_WIDTH = HEAD + len(LINES)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A tile kernel's launch for one grid (K1's or the brick kernel's): W
    target columns a block (the last run of cx may be shorter),
    ``threads`` a block, ``smem_bytes`` of dynamic shared memory, one
    block per (cy, cz, x-run): ``n_blocks``, each reading one row of its
    table: the head, ``line_fields`` int32 for each of the 9 lines and
    ``col_fields`` for each source column."""

    capacity: int
    xr: int
    ncell: tuple[int, int, int]
    width: int
    n_xtiles: int
    threads: int
    list_cap: int
    smem_bytes: int
    line_fields: int
    col_fields: int

    @property
    def ncols(self) -> int:
        """Source columns of a full-width block."""
        return self.width + 2 * self.xr

    @property
    def table_width(self) -> int:
        return (HEAD + self.line_fields * len(LINES)
                + self.col_fields * self.ncols)

    @property
    def n_blocks(self) -> int:
        nx, ny, nz = self.ncell
        return ny * nz * self.n_xtiles

    def blocks_per_sm(self) -> int:
        return SMEM_PER_SM // (self.smem_bytes + SMEM_RESERVED_PER_BLOCK)


def _threads(width: int, k: int) -> int:
    """One thread a target slot of the tile, in whole warps, at most
    MAX_THREADS (more targets take further rounds)."""
    return min(MAX_THREADS, 32 * -(-(width * k) // 32))


def smem_bytes(ncols: int, k: int, threads: int, list_cap: int) -> int:
    """The block's dynamic shared memory over bucket rows, in the kernels'
    order (``tiles::layout_of<BucketRows>`` in csrc/cell_tiles.cuh
    computes the same and the launch refuses a mismatch): staged
    positions (float4: x, y, z, the x wrap shift), each staged source's
    row (int32; v and the hash are gathered from device memory for the
    in-range pairs only), the slot-cells' first staged indices (ncols + 1
    a line, the last the line's end), the slot masks (one 32-bit word a
    32 slots), the block's table row, the 9 lines' (y, z) shifts, the
    lists (uint16)."""
    s = len(LINES) * ncols * k
    words = -(-k // 32)
    b = 16 * s
    b += 4 * s
    b += 4 * len(LINES) * (ncols + 1)
    b += 4 * len(LINES) * ncols * words
    b += 4 * (COL0 + 2 * ncols)
    b += 4 * 2 * len(LINES)
    b += 2 * list_cap * threads
    return -(-b // 16) * 16


def brick_smem_bytes(ncols: int, k: int, threads: int, list_cap: int) -> int:
    """The brick kernel's dynamic shared memory, in its order
    (``tiles::layout_of<BrickPlanes>`` in csrc/cell_tiles.cuh computes the
    same and the launch refuses a mismatch): staged positions (float4: x,
    y, z and the source's brick index as the fourth word; v, tag, the
    hash, the type and the field are gathered from the brick for the
    in-range pairs only), the slot-cells' first staged indices, the slot
    masks, the block's table row, the lists (uint16)."""
    s = len(LINES) * ncols * k
    words = -(-k // 32)
    b = 16 * s
    b += 4 * len(LINES) * (ncols + 1)
    b += 4 * len(LINES) * ncols * words
    b += 4 * BRICK_TABLE_WIDTH
    b += 2 * list_cap * threads
    return -(-b // 16) * 16


@functools.lru_cache(maxsize=64)
def plan(capacity: int, xr: int, ncell: tuple) -> TilePlan:
    """K1's plan, which its general variant and K3 share (they stage the
    same record): the widest W whose block lets BLOCKS_PER_SM blocks share
    an SM, or, where no W does (capacities above ~118 spill, ~190 strict),
    one block an SM; then W evened out over the runs of cx: ceil(ncx / W)
    runs of ceil(ncx / runs). A block has W + 2 xr <= 32 source columns
    (one warp's lanes stage them) and at most 65,536 staged slots (the
    lists' uint16 index). A capacity whose W = 1 block exceeds the 227 KB
    of one block (above ~240 spill, ~400 strict) is refused."""
    return _plan(int(capacity), xr, ncell, smem_bytes, LINE_FIELDS, 2,
                 "K1's")


@functools.lru_cache(maxsize=64)
def brick_plan(capacity: int, xr: int, ncell: tuple) -> TilePlan:
    """The brick kernel's plan, by ``plan``'s rule on its own layout
    (``brick_smem_bytes``), for any target run ncx >= 1 (the halo calls'
    edge groups pass ncx = xr). A capacity whose W = 1 block exceeds the
    227 KB of one block (above ~300 spill, ~500 strict) is refused."""
    return _plan(int(capacity), xr, ncell, brick_smem_bytes, 1, 0,
                 "the brick kernel's")


def _plan(k: int, xr: int, ncell: tuple, smem_fn, line_fields: int,
          col_fields: int, who: str) -> TilePlan:
    nx = int(ncell[0])
    if nx < 1:
        raise ValueError(f"{who} cell tiles: no target column (ncx {nx})")

    def fits(w, budget):
        ncols = w + 2 * xr
        return (ncols <= 32 and len(LINES) * ncols * k <= 1 << 16
                and smem_fn(ncols, k, _threads(w, k), LIST_CAP) <= budget)

    for blocks in (BLOCKS_PER_SM, 1):
        budget = min(SMEM_PER_BLOCK,
                     SMEM_PER_SM // blocks - SMEM_RESERVED_PER_BLOCK)
        w_max = max((w for w in range(1, nx + 1) if fits(w, budget)),
                    default=0)
        if w_max:
            break
    else:
        raise ValueError(f"{who} cell tiles: capacity {k} with x "
                         f"half-window {xr} leaves no tile width that fits "
                         f"the {SMEM_PER_BLOCK} bytes of one block")
    n_xtiles = -(-nx // w_max)
    w = -(-nx // n_xtiles)
    threads = _threads(w, k)
    return TilePlan(capacity=k, xr=xr, ncell=tuple(int(c) for c in ncell),
                    width=w, n_xtiles=n_xtiles, threads=threads,
                    list_cap=LIST_CAP,
                    smem_bytes=smem_fn(w + 2 * xr, k, threads, LIST_CAP),
                    line_fields=line_fields, col_fields=col_fields)


def _wrap(c: torch.Tensor, n: int):
    """(c mod n, the wrap code: -1 below 0, +1 above n - 1, else 0)."""
    code = torch.where(c < 0, -1, torch.where(c >= n, 1, 0))
    return c - code * n, code


def _runs(p: TilePlan):
    """(cy, cz, cx0, width) of every block, block b = (cy * ncz + cz) *
    n_xtiles + tx."""
    nx, ny, nz = p.ncell
    tx = torch.arange(p.n_xtiles)
    cx0 = tx * p.width
    width = torch.clamp(nx - cx0, max=p.width)
    cy = torch.arange(ny).repeat_interleave(nz * p.n_xtiles)
    cz = torch.arange(nz).repeat_interleave(p.n_xtiles).repeat(ny)
    tx = tx.repeat(ny * nz)
    return cy, cz, cx0[tx], width[tx]


def tile_table(p: TilePlan) -> torch.Tensor:
    """(n_blocks, table_width) int32 on the CPU, block b = (cy * ncz + cz)
    * n_xtiles + tx: [cy, cz, cx0, width], then for each line (dy, dz) its
    first row (sy * ncz + sz) * K * ncx with the y and z wrap codes, then
    for each source column c of the block (cx0 - xr + c, c < width + 2 xr)
    its sx with the x wrap code; columns past a short last run hold -1, 0.
    """
    nx, ny, nz = p.ncell
    k, xr = p.capacity, p.xr
    cy, cz, cx0, width = _runs(p)
    cols = []
    for dy, dz in LINES:
        sy, ycode = _wrap(cy + dy, ny)
        sz, zcode = _wrap(cz + dz, nz)
        cols += [(sy * nz + sz) * k * nx, ycode, zcode]
    c = torch.arange(p.ncols)
    sx, xcode = _wrap(cx0[:, None] - xr + c[None, :], nx)
    used = c[None, :] < (width + 2 * xr)[:, None]
    sx = torch.where(used, sx, -1)
    xcode = torch.where(used, xcode, 0)
    head = torch.stack([cy, cz, cx0, width] + cols, 1)
    xcols = torch.stack([sx, xcode], 2).reshape(p.n_blocks, 2 * p.ncols)
    return torch.cat([head, xcols], 1).to(torch.int32)


def brick_table(p: TilePlan) -> torch.Tensor:
    """(n_blocks, BRICK_TABLE_WIDTH) int32 on the CPU, block b = (cy * ncz
    + cz) * n_xtiles + tx: [cy, cz, cx0, width], then for each line (dy,
    dz) of LINES the brick index of its slot 0 at the block's first source
    column: ((cy + 1 + dy) * (ncz + 2) + cz + 1 + dz) * K * (ncx + 2 xr) +
    cx0. Source column c of the block (c < width + 2 xr) is brick column
    cx0 + c and slot s of it lies s * (ncx + 2 xr) further on; target
    column cx0 + c sits in source column c + xr. Nothing wraps: the pads
    hold the periodic copy or the halo layers."""
    nx, ny, nz = p.ncell
    px, pz = nx + 2 * p.xr, nz + 2
    cy, cz, cx0, width = _runs(p)
    lines = [((cy + 1 + dy) * pz + cz + 1 + dz) * p.capacity * px + cx0
             for dy, dz in LINES]
    return torch.stack([cy, cz, cx0, width] + lines, 1).to(torch.int32)


@functools.lru_cache(maxsize=16)
def table_on(p: TilePlan, device: torch.device,
             build=tile_table) -> torch.Tensor:
    """The plan's table, ``build(p)`` (``tile_table`` for K1's plan,
    ``brick_table`` for a brick plan), on ``device``, made once per plan,
    builder and device (one host-to-device copy per grid, none in the step
    loop)."""
    return build(p).to(device)
