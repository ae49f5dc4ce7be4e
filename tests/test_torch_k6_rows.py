"""What K6 on one card (``kernels/pair_dpd.py::bucket_forces_pallas``) takes
from K1's cell tiles, which it now walks over the strict bucket rows in
place of the padded brick: K1's plan accepts the strict cell's layout
(50^3 cells, K = 28, xr = 1); the wrap codes of ``tile_table`` for xr = 1
name the periodic neighbour line and column on every face; the row walk
visits, for every target row, the same source rows in the same order as
the brick walk over ``brick_table`` (the order in which the kernel sums a
row's pairs, so the two give the same bits); and the entry point still
refuses a spill ``CellConfig`` (R7), and now a strict capacity above K1's
limit of 396, before it reaches for the card.
Numpy and torch on the CPU; ``tests/test_torch_k6_rows_card.py`` holds the
kernel's outputs bitwise against the brick launch on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.kernels import _brick, _build, cell_tiles
from meso_tpu_torch.kernels.pair_dpd import bucket_forces_pallas
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops.dpd import DPDParams
from test_torch_imports import one_torch_thread  # noqa: F401

HEAD, COL0 = cell_tiles.HEAD, cell_tiles.COL0


def test_plan_accepts_the_strict_cell():
    """The strict cell's grid on K1's plan: K6's brick plan's W and runs,
    two blocks an SM, a table row for each of the 7,500 blocks."""
    p = cell_tiles.plan(28, 1, (50, 50, 50))
    brick = cell_tiles.brick_plan(28, 1, (50, 50, 50))
    assert (p.width, p.n_xtiles, p.threads) == (17, 3, 256)
    assert (p.width, p.n_xtiles) == (brick.width, brick.n_xtiles)
    assert p.blocks_per_sm() == 2 and p.n_blocks == 7_500
    assert p.smem_bytes <= cell_tiles.SMEM_PER_BLOCK
    table = cell_tiles.tile_table(p)
    assert table.shape == (7_500, p.table_width) and table.dtype == torch.int32


def _wrap(c, n):
    return c % n, np.where(c < 0, -1, np.where(c >= n, 1, 0))


@pytest.mark.parametrize("ncell,k,width", [((5, 4, 3), 3, None),
                                           ((3, 3, 3), 2, None),
                                           ((7, 3, 4), 5, 3)])
def test_strict_wrap_codes_name_the_periodic_neighbour(ncell, k, width):
    """Every block's 9 lines hold the first row of the periodic (cy + dy,
    cz + dz) line and its y and z wrap codes, and each of its width + 2
    source columns the periodic column cx0 - 1 + c and its x wrap code;
    every face of the grid shows up with its code."""
    p = cell_tiles.plan(k, 1, ncell)
    if width is not None:
        p = dataclasses.replace(p, width=width, n_xtiles=-(-ncell[0] // width))
    nx, ny, nz = ncell
    t = cell_tiles.tile_table(p).numpy()
    cy, cz, cx0, w = t[:, 0], t[:, 1], t[:, 2], t[:, 3]
    codes = {"x": set(), "y": set(), "z": set()}
    for line, (dy, dz) in enumerate(cell_tiles.LINES):
        sy, ycode = _wrap(cy + dy, ny)
        sz, zcode = _wrap(cz + dz, nz)
        base, yc, zc = (t[:, HEAD + 3 * line + i] for i in range(3))
        np.testing.assert_array_equal(base, (sy * nz + sz) * k * nx)
        np.testing.assert_array_equal(yc, ycode)
        np.testing.assert_array_equal(zc, zcode)
        codes["y"] |= set(yc.tolist())
        codes["z"] |= set(zc.tolist())
    for c in range(p.ncols):
        sx, xcode = _wrap(cx0 - 1 + c, nx)
        used = c < w + 2
        np.testing.assert_array_equal(t[:, COL0 + 2 * c],
                                      np.where(used, sx, -1))
        np.testing.assert_array_equal(t[:, COL0 + 2 * c + 1],
                                      np.where(used, xcode, 0))
        codes["x"] |= set(xcode[used].tolist())
    assert all(v == {-1, 0, 1} for v in codes.values())


def _row_walk(p, valid):
    """Per valid target row, the source rows K1's tile walk visits over
    ``tile_table`` (lines, then the target's 2 xr + 1 columns, then slots;
    valid sources only)."""
    nx, k, xr = p.ncell[0], p.capacity, p.xr
    seqs = {}
    for hdr in cell_tiles.tile_table(p).numpy():
        base = hdr[HEAD:COL0:3]
        sx = hdr[COL0::2]
        for tc in range(xr, xr + hdr[3]):
            for slot in range(k):
                row = base[cell_tiles.TARGET_LINE] + slot * nx + sx[tc]
                if valid[row]:
                    seqs[int(row)] = [
                        int(r) for b in base for c in range(tc - xr,
                                                            tc + xr + 1)
                        for r in b + np.arange(k) * nx + sx[c] if valid[r]]
    return seqs


def _brick_walk(p, valid):
    """The same for the brick kernel over ``brick_table``, the brick of
    each slot's row and valid flag built as the kernel's wrapper pads its
    planes (``_brick.pad_brick``)."""
    nx, ny, nz = p.ncell
    k, xr = p.capacity, p.xr
    px = nx + 2 * xr
    planes = torch.stack([torch.arange(valid.size),
                          torch.from_numpy(valid).long()])
    brick = _brick.pad_brick(planes.reshape(2, ny, nz, k, nx), xr)
    rows, ok = (b.reshape(-1).numpy() for b in brick)
    seqs = {}
    for hdr in cell_tiles.brick_table(p).numpy():
        cy, cz, cx0, width = hdr[:HEAD]
        base = hdr[HEAD:]
        for tc in range(xr, xr + width):
            for slot in range(k):
                e = base[cell_tiles.TARGET_LINE] + slot * px + tc
                if ok[e]:
                    assert rows[e] == ((cy * nz + cz) * k + slot) * nx \
                        + cx0 + tc - xr
                    seqs[int(rows[e])] = [
                        int(rows[s]) for b in base
                        for c in range(tc - xr, tc + xr + 1)
                        for s in b + np.arange(k) * px + c if ok[s]]
    return seqs


@pytest.mark.parametrize("ncell,k,width", [((5, 4, 3), 4, None),
                                           ((6, 3, 5), 3, 4)])
def test_row_walk_is_the_brick_walk(ncell, k, width):
    """Strict rows, about half valid (whole cells empty and full among
    them): the row walk and the brick walk visit every valid target's
    sources in one order, on the plans' own runs and on ragged ones."""
    p = cell_tiles.plan(k, 1, ncell)
    b = cell_tiles.brick_plan(k, 1, ncell)
    if width is not None:
        runs = dict(width=width, n_xtiles=-(-ncell[0] // width))
        p, b = (dataclasses.replace(q, **runs) for q in (p, b))
    nx, ny, nz = ncell
    valid = np.random.RandomState(7).rand(ny, nz, k, nx) < 0.5
    valid[0, 0, :, 0] = True
    valid[1, 1, :, 1] = False
    valid = valid.reshape(-1)
    rows, bricks = _row_walk(p, valid), _brick_walk(b, valid)
    assert sorted(rows) == sorted(np.flatnonzero(valid).tolist())
    assert rows == bricks


def test_k6_refuses_spill_before_the_card():
    """R7 on the card's route: a spill CellConfig is refused before any
    library or device is touched (meta tensors, no kernel library)."""
    cfg = CellConfig(ncell=(5, 4, 4), capacity=8, spill=True)
    nr = 5 * 4 * 4 * 8
    x = torch.zeros((nr, 3), device="meta")
    pair = DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                           seed=1).to("meta")
    before = dict(_build.LAUNCHES), dict(_brick.BUILDS)
    with pytest.raises(ValueError, match="R7"):
        bucket_forces_pallas(
            x, x, torch.zeros(nr, dtype=torch.int32, device="meta"),
            torch.zeros(nr, dtype=torch.int32, device="meta"),
            torch.zeros(nr, dtype=torch.bool, device="meta"),
            Box.cubic(6.0, device="meta"), 1, pair, 0.01, cfg)
    assert (dict(_build.LAUNCHES), dict(_brick.BUILDS)) == before


@pytest.mark.parametrize("capacity", [397, 495])
def test_k6_takes_k1s_capacity_limit(capacity):
    """K6 on one card runs on K1's plan, which refuses a strict capacity
    above 396 slots a cell (the brick's plan, which K6 ran on before,
    takes up to 495): the entry point raises ``ValueError`` naming the
    capacity before any library or device is touched (meta tensors, no
    kernel library)."""
    ncell = (5, 4, 4)
    assert cell_tiles.plan(396, 1, ncell).blocks_per_sm() == 1
    assert cell_tiles.brick_plan(capacity, 1, ncell).blocks_per_sm() == 1
    cfg = CellConfig(ncell=ncell, capacity=capacity, spill=False)
    nr = 5 * 4 * 4 * capacity
    x = torch.zeros((nr, 3), device="meta")
    rows = torch.zeros(nr, dtype=torch.int32, device="meta")
    pair = DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                           seed=1).to("meta")
    before = dict(_build.LAUNCHES), dict(_brick.BUILDS)
    with pytest.raises(ValueError, match=f"K1's cell tiles: capacity "
                                         f"{capacity} "):
        bucket_forces_pallas(
            x, x, rows, rows, torch.zeros(nr, dtype=torch.bool,
                                          device="meta"),
            Box.cubic(6.0, device="meta"), 1, pair, 0.01, cfg)
    assert (dict(_build.LAUNCHES), dict(_brick.BUILDS)) == before
