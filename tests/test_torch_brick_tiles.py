"""The brick kernel's cell tiles (``meso_tpu_torch/kernels/cell_tiles.py``:
``brick_plan``, ``brick_table``): the launch plan and the per-block table
that the Hopper kernel ``pair_brick_kernel`` (``csrc/pair_brick.cu``:
K4-K7 and K6-halo) reads, held here on the CPU. The kernel runs only on
the card (chip_smoke.py holds it against the plain version there); what
it reads to find its targets and sources is this table, and a numpy copy
of its staging and walk over the table must give the (target, source)
set of the plain version's walk over the same brick
(``_brick._brick_pairs``) exactly, on one card's brick and on halo
bricks."""

import numpy as np
import pytest
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import create_random
from meso_tpu_torch.kernels import _brick, cell_tiles
from meso_tpu_torch.neighbor.bucket_layout import to_bucket_state
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops.sweep import make_channels
from test_torch_imports import one_torch_thread  # noqa: F401

# the main path's grid: L = 70, 50^3 cells
NCELL_1M = (50, 50, 50)


@pytest.mark.parametrize("k,xr", [(16, 2), (17, 2), (18, 2), (19, 2),
                                  (28, 1)])
def test_brick_plan_fits_two_blocks_an_sm(k, xr):
    """The builders' capacities (16-19 spill, 28 strict): two blocks an
    SM in whole warps, every limit of the kernel's launch check held."""
    p = cell_tiles.brick_plan(k, xr, NCELL_1M)
    assert p.blocks_per_sm() >= 2
    assert 2 * (p.smem_bytes + cell_tiles.SMEM_RESERVED_PER_BLOCK) \
        <= cell_tiles.SMEM_PER_SM
    assert p.threads % 32 == 0 and p.threads <= cell_tiles.MAX_THREADS
    assert 1 <= p.width and p.ncols <= 32 and 9 * p.ncols * k <= 1 << 16
    assert p.smem_bytes == cell_tiles.brick_smem_bytes(p.ncols, k,
                                                       p.threads, p.list_cap)
    assert p.table_width == cell_tiles.BRICK_TABLE_WIDTH


def test_brick_plan_main_path_shapes():
    """K5's spill rows (K 16) take K1's tiles, two runs of 25 columns;
    K6's strict rows (K 28) three runs of 17; the brick stages 16 bytes a
    slot against K1's 20, so its blocks are smaller."""
    p = cell_tiles.brick_plan(16, 2, NCELL_1M)
    assert (p.width, p.n_xtiles, p.n_blocks, p.threads) == (25, 2, 5000,
                                                           256)
    assert p.smem_bytes < cell_tiles.plan(16, 2, NCELL_1M).smem_bytes
    p = cell_tiles.brick_plan(28, 1, NCELL_1M)
    assert (p.width, p.n_xtiles, p.threads) == (17, 3, 256)


@pytest.mark.parametrize("k,xr,blocks", [
    (144, 2, 2), (145, 2, 1), (216, 2, 1), (297, 2, 1), (227, 1, 2),
    (228, 1, 1), (495, 1, 1)])
def test_brick_plan_large_capacity(k, xr, blocks):
    """A capacity too large for two blocks an SM (a dense fluid, or a
    user's K) takes one block of at most 227 KB, up to K 297 spill and 495
    strict."""
    p = cell_tiles.brick_plan(k, xr, NCELL_1M)
    assert p.blocks_per_sm() == blocks
    assert p.smem_bytes <= cell_tiles.SMEM_PER_BLOCK
    assert 9 * p.ncols * k <= 1 << 16


@pytest.mark.parametrize("k,xr", [(298, 2), (496, 1), (4096, 2)])
def test_brick_plan_refuses_a_capacity_no_tile_fits(k, xr):
    with pytest.raises(ValueError, match="brick kernel's cell tiles: "
                       f"capacity {k} .* no tile width"):
        cell_tiles.brick_plan(k, xr, NCELL_1M)


@pytest.mark.parametrize("nx,xr", [(1, 1), (1, 2), (2, 2), (2, 1), (3, 2)])
def test_brick_plan_narrow_runs(nx, xr):
    """The halo calls' edge groups (ncx = xr) and any ncx >= 1: one run
    of all the columns, in whole warps."""
    p = cell_tiles.brick_plan(16, xr, (nx, 50, 50))
    assert (p.width, p.n_xtiles) == (nx, 1)
    assert p.threads == 32 * -(-nx * 16 // 32)
    with pytest.raises(ValueError, match="no target column"):
        cell_tiles.brick_plan(16, xr, (0, 50, 50))


def _ragged(p):
    """``p`` narrowed, if its runs of cx are all whole, to the widest W
    below its own whose last run is short: the table is built for any W,
    the plan only picks one."""
    nx = p.ncell[0]
    for w_max in range(p.width, 0, -1):
        n_xtiles = -(-nx // w_max)
        w = -(-nx // n_xtiles)
        if nx % w:
            return cell_tiles.TilePlan(**{**p.__dict__, "width": w,
                                          "n_xtiles": n_xtiles})
    raise AssertionError(f"no ragged plan for {p}")


@pytest.mark.parametrize("k,xr,ncell", [
    (16, 2, NCELL_1M), (28, 1, NCELL_1M), (24, 2, (5, 5, 5)),
    (32, 1, (5, 4, 3)), (16, 2, (17, 3, 4)), (16, 2, (2, 3, 4)),
    (28, 1, (1, 3, 3))])
def test_brick_table_covers_every_cell_once(k, xr, ncell):
    """Every target cell in exactly one block's run, and each line's
    first index the brick's own: ((cy + 1 + dy) * (ncz + 2) + cz + 1 + dz)
    * K * (ncx + 2 xr) + cx0."""
    p = cell_tiles.brick_plan(k, xr, ncell)
    if ncell[0] > 2 and ncell[0] % p.width == 0:
        p = _ragged(p)
    table = cell_tiles.brick_table(p)
    assert table.dtype == torch.int32
    t = table.to(torch.int64)
    nx, ny, nz = ncell
    assert t.shape == (p.n_blocks, p.table_width)
    cy, cz, cx0, width = t[:, :4].T
    assert bool(((width >= 1) & (width <= p.width)).all())
    seen = torch.zeros((ny, nz, nx), dtype=torch.int64)
    c = torch.arange(p.width)
    own = c[None, :] < width[:, None]
    cells = ((cy[:, None] * nz + cz[:, None]) * nx + cx0[:, None] + c)[own]
    seen.view(-1).index_add_(0, cells, torch.ones_like(cells))
    assert bool((seen == 1).all())
    if ncell[0] > 2:
        assert (width < p.width).any(), "a ragged last run"
    px = nx + 2 * xr
    for li, (dy, dz) in enumerate(cell_tiles.LINES):
        want = ((cy + 1 + dy) * (nz + 2) + cz + 1 + dz) * k * px + cx0
        assert torch.equal(t[:, cell_tiles.HEAD + li], want)
    last = t[:, cell_tiles.HEAD:] + ((k - 1) * px + width + 2 * xr)[:, None]
    assert int(last.max()) <= (ny + 2) * (nz + 2) * k * px


def test_brick_table_on_device_made_once():
    """One copy per plan and device; a brick plan and K1's plan of the
    same grid are different plans with different tables."""
    p = cell_tiles.brick_plan(16, 2, (17, 3, 4))
    assert cell_tiles.brick_plan(16, 2, (17, 3, 4)) is p
    cpu = torch.device("cpu")
    a = cell_tiles.table_on(p, cpu, cell_tiles.brick_table)
    assert cell_tiles.table_on(p, cpu, cell_tiles.brick_table) is a
    assert torch.equal(a, cell_tiles.brick_table(p))
    k1 = cell_tiles.table_on(cell_tiles.plan(16, 2, (17, 3, 4)), cpu)
    assert k1.shape[1] != a.shape[1]


def _walk(p, table, brick, box, rc2):
    """A numpy copy of pair_brick_kernel's phases over ``table``: per
    block, stage each line's valid slots in (column, slot) order (phase
    A's counts and offsets, phase B's compaction), then for every valid
    target of the run walk the staged sources of its 2 xr + 1 columns on
    each line, itself left out, and keep those with 0 < r2 < rc2 under
    the minimum image (the plain version's test). Returns (target row,
    source brick index, r2) in the kernel's per-row order (dy, dz, dx,
    slot), and the target rows walked."""
    nx, ny, nz = p.ncell
    k, xr = p.capacity, p.xr
    px = nx + 2 * xr
    valid = brick.ib[1].reshape(-1).numpy() != 0
    pos = brick.fb[:3].reshape(3, -1).numpy()
    lens = box.lengths.numpy()
    rows, srcs, r2s, targets = [], [], [], []
    for cy, cz, cx0, width, *bases in table.numpy().astype(np.int64):
        ncols = width + 2 * xr
        staged, first = [], []   # per line: brick indices; column offsets
        for base in bases:
            e = base + np.arange(k)[None, :] * px + np.arange(ncols)[:, None]
            ok = valid[e]
            staged.append(e[ok])
            first.append(np.concatenate([[0], np.cumsum(ok.sum(1))]))
        tl = cell_tiles.TARGET_LINE
        for tc in range(xr, xr + width):
            for self_ in staged[tl][first[tl][tc]:first[tl][tc + 1]]:
                slot = (self_ // px) % k
                row = ((cy * nz + cz) * k + slot) * nx + cx0 + tc - xr
                targets.append(row)
                for li in range(len(bases)):
                    src = staged[li][first[li][tc - xr]:first[li][tc + xr + 1]]
                    src = src[src != self_]
                    d = pos[:, self_, None] - pos[:, src]
                    d = d - np.round(d / lens[:, None]) * lens[:, None]
                    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                    keep = (r2 < rc2) & (r2 > 0.0)
                    rows.append(np.full(int(keep.sum()), row))
                    srcs.append(src[keep])
                    r2s.append(r2[keep])
    return (np.concatenate(rows), np.concatenate(srcs), np.concatenate(r2s),
            np.asarray(targets))


def _state(spill, l=(8.0, 8.0, 8.0), n=1536, seed=3, capacity=None):
    """A moved bucket state, box-wrapped (the brick kernels take the
    minimum image), as chip_smoke.py builds its brick cases."""
    box = Box.orthorhombic(*l)
    st = create_random(torch.Generator().manual_seed(seed), n, box)
    cfg = CellConfig.for_box(list(l), 1.0, n / (l[0] * l[1] * l[2]),
                             skin=0.4, spill=spill, capacity=capacity)
    bst = to_bucket_state(st, cfg)
    x = bst.x + torch.clamp(0.04 * bst.v, -0.2, 0.2) * bst.mask[:, None]
    return bst.replace(x=box.wrap(x)[0]), cfg


def _check_walk(brick, cfg, box, plan, rc2=1.0):
    """The emulated walk against ``_brick._brick_pairs`` on one brick:
    the same (target row, source) pairs, each once, with the same r2, and
    every valid target row walked once."""
    table = cell_tiles.brick_table(plan)
    rows, srcs, r2, targets = _walk(plan, table, brick, box, rc2)
    key = rows * brick.ib[0].numel() + srcs
    assert np.unique(key).size == key.size, "a pair taken twice"
    want_rows, want_srcs, want_r2 = [], [], []
    for row, _, sb, _, r2w in _brick._brick_pairs(brick, cfg, box,
                                                  torch.tensor(rc2)):
        want_rows.append(row)
        want_srcs.append(sb)
        want_r2.append(r2w)
    want_key = (torch.cat(want_rows) * brick.ib[0].numel()
                + torch.cat(want_srcs)).numpy()
    order, want_order = np.argsort(key), np.argsort(want_key)
    assert np.array_equal(key[order], want_key[want_order])
    np.testing.assert_allclose(r2[order], torch.cat(want_r2).numpy()[
        want_order], rtol=1e-6, atol=0)
    nx, ny, nz = cfg.ncell
    tgt_valid = brick.ib[1][1:ny + 1, 1:nz + 1, :,
                            plan.xr:plan.xr + nx].reshape(-1) != 0
    assert np.array_equal(np.sort(targets),
                          torch.nonzero(tgt_valid).squeeze(1).numpy())


@pytest.mark.parametrize("spill", [True, False])
def test_tile_walk_is_the_plain_walk(spill):
    """One card's brick (periodic pads), ragged runs of cx."""
    bst, cfg = _state(spill, l=(9.8, 5.6, 5.6), n=924)
    xr = 2 if spill else 1
    brick = _brick.build_brick(cfg, xr, bst.x, bst.v, bst.tag, bst.mask)
    plan = _ragged(cell_tiles.brick_plan(cfg.capacity, xr, cfg.ncell))
    assert cfg.ncell[0] % plan.width
    _check_walk(brick, cfg, bst.box, plan)


def test_tile_walk_is_the_plain_walk_dense():
    """A rho 9 fluid at a capacity of 128 spill: a block of W = 1 and
    rows with more sources in range than a list holds."""
    bst, cfg = _state(True, l=(7.0, 4.2, 4.2), n=1111, capacity=128)
    brick = _brick.build_brick(cfg, 2, bst.x, bst.v, bst.tag, bst.mask)
    plan = cell_tiles.brick_plan(cfg.capacity, 2, cfg.ncell)
    assert plan.width == 1 and plan.n_xtiles == cfg.ncell[0]
    _check_walk(brick, cfg, bst.box, plan)


def _halo_brick(bst, cfg, xr, cx0, ntx):
    """The brick of ``ntx`` target columns from cx0 on with ext ("x",):
    their planes with xr halo columns a side cut from the periodic state,
    coordinates shifted by -L or +L where the cut wrapped, as a rank
    receives them; y and z take the periodic copy."""
    nx = cfg.ncell[0]
    ch = make_channels(bst.x, bst.v, bst.tag, bst.mask, None, {}, cfg.ncell,
                       cfg.capacity)
    idx = torch.arange(cx0 - xr, cx0 + ntx + xr)
    shift = torch.div(idx, nx, rounding_mode="floor").to(torch.float32)
    planes = {nm: p.index_select(3, idx % nx) for nm, p in ch.items()}
    planes["x"] = planes["x"] + shift * float(bst.box.lengths[0])
    tcfg = cfg.replace(ncell=(ntx,) + tuple(cfg.ncell[1:]))
    return _brick.halo_brick(planes, tcfg, xr, ("x",), (), None, False, 0), \
        tcfg


@pytest.mark.parametrize("spill,cx0,ntx", [
    (True, 0, 2), (True, 3, 3), (False, 0, 1), (False, 4, 3),
    (True, 2, 5)])
def test_tile_walk_is_the_plain_walk_on_halo_bricks(spill, cx0, ntx):
    """Halo bricks with ext ("x",): the edge calls' ncx = xr, a slab
    across the periodic boundary, and the interior-sized call."""
    bst, cfg = _state(spill, l=(9.8, 5.6, 5.6), n=924)
    xr = 2 if spill else 1
    brick, tcfg = _halo_brick(bst, cfg, xr, cx0, ntx)
    plan = cell_tiles.brick_plan(cfg.capacity, xr, tcfg.ncell)
    _check_walk(brick, tcfg, bst.box, plan)
