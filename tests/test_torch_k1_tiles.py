"""K1's cell tiles (``meso_tpu_torch/kernels/cell_tiles.py``): the launch
plan and the per-block table that the Hopper kernel ``pair_dpd_v3_kernel``
reads, held here on the CPU. The kernel itself runs only on the card
(chip_smoke.py holds it against the plain version there); what it reads
to find its targets, sources and wrap shifts is this table, and the
(target, source, shift) set the table implies must be the plain version's
stencil (``_stencil_pairs``) exactly."""

import dataclasses

import pytest
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import create_random
from meso_tpu_torch.kernels import cell_tiles
from meso_tpu_torch.kernels.pair_dpd_v3 import _stencil_pairs
from meso_tpu_torch.neighbor.bucket_layout import to_bucket_state
from meso_tpu_torch.neighbor.cells import CellConfig
from test_torch_imports import one_torch_thread  # noqa: F401

# the main path's grid: L = 70, 50^3 cells
NCELL_1M = (50, 50, 50)


@pytest.mark.parametrize("k,xr", [(16, 2), (17, 2), (18, 2), (19, 2),
                                  (28, 1)])
def test_plan_fits_two_blocks_an_sm(k, xr):
    """The builders' capacities (16-19 spill, 28 strict): the plan's block
    fits the 227 KB a block may have, two of them an SM, in whole warps."""
    p = cell_tiles.plan(k, xr, NCELL_1M)
    assert p.smem_bytes <= cell_tiles.SMEM_PER_BLOCK
    assert p.blocks_per_sm() >= 2
    assert 2 * (p.smem_bytes + cell_tiles.SMEM_RESERVED_PER_BLOCK) \
        <= cell_tiles.SMEM_PER_SM
    assert p.threads % 32 == 0 and p.threads <= cell_tiles.MAX_THREADS
    assert 1 <= p.width and p.ncols <= 32
    assert 9 * p.ncols * k <= 1 << 16
    # W evened out over the runs of cx: no run more than one column short
    runs = [min(p.width, 50 - c) for c in range(0, 50, p.width)]
    assert len(runs) == p.n_xtiles and max(runs) - min(runs) <= p.width
    assert sum(runs) == 50


def test_plan_main_path_shape():
    """K = 16 spill at 50^3: two runs of 25 columns a row of cells, 256
    threads a block, two blocks an SM."""
    p = cell_tiles.plan(16, 2, NCELL_1M)
    assert (p.width, p.n_xtiles, p.n_blocks, p.threads) == (25, 2, 5000,
                                                           256)
    assert p.blocks_per_sm() == 2


@pytest.mark.parametrize("k,xr,blocks", [
    (118, 2, 2), (119, 2, 1), (128, 2, 1), (237, 2, 1), (189, 1, 2),
    (190, 1, 1), (396, 1, 1)])
def test_plan_large_capacity(k, xr, blocks):
    """A capacity too large for two blocks an SM (a dense fluid, or a
    user's K) takes one block of at most 227 KB, up to K 237 spill and
    396 strict."""
    p = cell_tiles.plan(k, xr, NCELL_1M)
    assert p.blocks_per_sm() == blocks
    assert p.smem_bytes <= cell_tiles.SMEM_PER_BLOCK
    assert p.smem_bytes == cell_tiles.smem_bytes(p.ncols, k, p.threads,
                                                 p.list_cap)
    assert p.threads % 32 == 0 and p.threads <= cell_tiles.MAX_THREADS
    assert 9 * p.ncols * k <= 1 << 16


def _ragged_plan(k, xr, ncell):
    """The plan for (K, xr, ncell) if its last run of cx is shorter than
    the others, else that plan narrowed to the widest W below its own
    whose runs come out ragged: the table is built for any W, the plan
    only picks one."""
    p = cell_tiles.plan(k, xr, ncell)
    nx = ncell[0]
    for w_max in range(p.width, 0, -1):
        n_xtiles = -(-nx // w_max)
        w = -(-nx // n_xtiles)
        if nx % w:
            return dataclasses.replace(p, width=w, n_xtiles=n_xtiles)
    raise AssertionError(f"no ragged plan for K={k}, xr={xr}, {ncell}")


@pytest.mark.parametrize("k,xr,ncell", [
    (16, 2, NCELL_1M), (28, 1, NCELL_1M), (24, 2, (5, 5, 5)),
    (32, 1, (5, 4, 3)), (16, 2, (17, 3, 4))])
def test_table_covers_every_cell_once(k, xr, ncell):
    p = cell_tiles.plan(k, xr, ncell)
    if ncell[0] % p.width == 0:
        p = _ragged_plan(k, xr, ncell)
    t = cell_tiles.tile_table(p).to(torch.int64)
    nx, ny, nz = ncell
    assert t.shape == (p.n_blocks, p.table_width)
    assert t.dtype == torch.int64 and cell_tiles.tile_table(p).dtype \
        == torch.int32
    cy, cz, cx0, width = t[:, :4].T
    assert bool(((width >= 1) & (width <= p.width)).all())
    seen = torch.zeros((ny, nz, nx), dtype=torch.int64)
    c = torch.arange(p.width)
    own = c[None, :] < width[:, None]
    cells = ((cy[:, None] * nz + cz[:, None]) * nx + cx0[:, None] + c)[own]
    seen.view(-1).index_add_(0, cells, torch.ones_like(cells))
    assert bool((seen == 1).all())
    assert (width < p.width).any(), "a ragged last run"

    def wrap_code(v, n):
        return (v >= n).to(torch.int64) - (v < 0).to(torch.int64)

    # the lines and source columns each block reads
    for li, (dy, dz) in enumerate(cell_tiles.LINES):
        base, yc, zc = t[:, cell_tiles.HEAD + 3 * li:
                         cell_tiles.HEAD + 3 * li + 3].T
        assert torch.equal(base, (((cy + dy) % ny) * nz + (cz + dz) % nz)
                           * k * nx)
        assert torch.equal(yc, wrap_code(cy + dy, ny))
        assert torch.equal(zc, wrap_code(cz + dz, nz))
    col = t[:, cell_tiles.COL0:].reshape(-1, p.ncols, 2)
    cx = cx0[:, None] - xr + torch.arange(p.ncols)
    inside = torch.arange(p.ncols)[None, :] < (width + 2 * xr)[:, None]
    assert torch.equal(col[..., 0], torch.where(inside, cx % nx, -1))
    assert torch.equal(col[..., 1], torch.where(inside, wrap_code(cx, nx),
                                                0))


def _bucket_case(spill, min_image, l=(8.0, 8.0, 8.0), n=1536, seed=3,
                 capacity=None):
    """A bucket state whose rows moved since the rebuild, as chip_smoke.py
    builds its K1 cases: unwrapped by <= skin/2 without min-image,
    box-wrapped with it."""
    box = Box.orthorhombic(*l)
    gen = torch.Generator().manual_seed(seed)
    st = create_random(gen, n, box)
    cfg = CellConfig.for_box(list(l), 1.0, n / (l[0] * l[1] * l[2]),
                             skin=0.4,
                             spill=spill, wrap_at_rebuild=not min_image,
                             capacity=capacity)
    bst = to_bucket_state(st, cfg)
    x = bst.x + torch.clamp(0.04 * bst.v, -0.2, 0.2) * bst.mask[:, None]
    if min_image:
        x = box.wrap(x)[0]
    return bst.replace(x=x), cfg


def _tile_pairs(p, table, mask):
    """The candidates (target row, source row, x, y, z wrap codes) that
    the kernel's walk takes from ``table`` over the valid rows of
    ``mask``: for every block, every target column c of its run (source
    column xr + c), the lines, the source columns c .. c + 2 xr, every
    valid slot of each slot-cell, the target itself excluded (the
    kernel's r^2 > 0). Blocks are taken a few at a time, so that a large
    capacity's (K x K) slot pairs stay small."""
    step = max(1, 2 ** 20 // (p.width * 9 * (2 * p.xr + 1) * p.capacity ** 2))
    parts = [_block_pairs(p, table[b:b + step].to(torch.int64), mask)
             for b in range(0, table.shape[0], step)]
    return tuple(torch.cat(col) for col in zip(*parts))


def _block_pairs(p, t, mask):
    """``_tile_pairs`` of the blocks whose table rows are ``t``."""
    nx = p.ncell[0]
    k, xr = p.capacity, p.xr
    col = t[:, cell_tiles.COL0:].reshape(-1, p.ncols, 2)
    lines = t[:, cell_tiles.HEAD:cell_tiles.COL0].reshape(
        -1, len(cell_tiles.LINES), cell_tiles.LINE_FIELDS)
    c = torch.arange(p.width)
    # (block, target column, line, stencil column)
    used = (c[None, :] < t[:, 3:4])[:, :, None, None, None, None]
    src_col = c[:, None] + torch.arange(2 * xr + 1)[None, :]
    tgt = (lines[:, None, cell_tiles.TARGET_LINE, 0]
           + col[:, xr + c, 0])[:, :, None, None]
    src = lines[:, None, :, None, 0] + col[:, src_col, 0][:, :, None, :]
    codes = [col[:, src_col, 1][:, :, None, :],
             lines[:, None, :, None, 1], lines[:, None, :, None, 2]]
    shape = src.shape
    slots = torch.arange(k) * nx
    # rows of the unused columns of a short run: clamped, then dropped
    trow = torch.where(used, tgt.expand(shape)[..., None, None]
                       + slots[:, None], 0)
    srow = torch.where(used, src[..., None, None] + slots[None, :], 0)
    keep = used & mask[trow] & mask[srow] & (trow != srow)
    out = [trow.expand(keep.shape)[keep], srow.expand(keep.shape)[keep]]
    out += [cd.expand(shape)[..., None, None].expand(keep.shape)[keep]
            for cd in codes]
    return tuple(out)


@pytest.mark.parametrize("min_image", [False, True])
@pytest.mark.parametrize("spill", [True, False])
def test_tile_pairs_are_the_plain_stencil(spill, min_image):
    """Every (target, source) candidate the table implies, with its dr,
    equals the plain version's stencil walk over the same valid rows:
    without min-image dr = (x_t - x_s) - code * L, bitwise the plain
    version's shifted difference; with it, the minimum image of x_t -
    x_s. The plan is a ragged one (W below ncx)."""
    bst, cfg = _bucket_case(spill, min_image)
    xr = 2 if spill else 1
    _check_plain_stencil(bst, cfg, _ragged_plan(cfg.capacity, xr,
                                                cfg.ncell))


@pytest.mark.parametrize("min_image", [False, True])
def test_tile_pairs_are_the_plain_stencil_at_k128(min_image):
    """The same at a capacity of 128 spill on a rho 9 fluid (5 x 3 x 3
    cells), whose plan takes one block an SM."""
    bst, cfg = _bucket_case(True, min_image, l=(7.0, 4.2, 4.2), n=1111,
                            capacity=128)
    assert cfg.ncell == (5, 3, 3) and cfg.spill
    p = cell_tiles.plan(cfg.capacity, 2, cfg.ncell)
    assert p.blocks_per_sm() == 1
    _check_plain_stencil(bst, cfg, p)


def _check_plain_stencil(bst, cfg, p):
    """The candidates and dr that ``p``'s table implies on ``bst`` against
    the plain version's stencil walk (``_stencil_pairs``)."""
    min_image = not cfg.wrap_at_rebuild
    table = cell_tiles.tile_table(p)
    tr, sr, xc, yc, zc = _tile_pairs(p, table, bst.mask)
    lens = bst.box.lengths
    dr = bst.x[tr] - bst.x[sr]
    if min_image:
        dr = dr - torch.round(dr / lens) * lens
    else:
        dr = dr - torch.stack([xc, yc, zc], 1).to(torch.float32) * lens
    nr = bst.x.shape[0]
    key = tr * nr + sr
    assert key.unique().numel() == key.numel(), "a candidate taken twice"
    rows, srcs, ds = [], [], []
    for row, src, d, _ in _stencil_pairs(bst.x, bst.mask, bst.box, cfg,
                                         torch.tensor(1e30)):
        rows.append(row)
        srcs.append(src)
        ds.append(torch.stack(d, 1))
    want_key = torch.cat(rows) * nr + torch.cat(srcs)
    order, want_order = torch.argsort(key), torch.argsort(want_key)
    assert torch.equal(key[order], want_key[want_order])
    assert torch.equal(dr[order], torch.cat(ds)[want_order])


def test_table_on_device_made_once():
    """The table reaches the device once per plan: a second call returns
    the same tensor (no copy in the step loop), as ``plan`` returns the
    same plan."""
    p = cell_tiles.plan(16, 2, (17, 3, 4))
    assert cell_tiles.plan(16, 2, (17, 3, 4)) is p
    cpu = torch.device("cpu")
    a = cell_tiles.table_on(p, cpu)
    assert cell_tiles.table_on(p, cpu) is a
    assert torch.equal(a, cell_tiles.tile_table(p))


def test_plan_refuses_a_capacity_no_tile_fits():
    with pytest.raises(ValueError, match="no tile width"):
        cell_tiles.plan(4096, 2, NCELL_1M)
