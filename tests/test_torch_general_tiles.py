"""The bucket-row walk of the cell-tile kernels that K1's general variant
(``pair_dpd_v3_general_kernel``), K2 (``pair_edpd_v3_kernel``, its own
file: ``test_torch_edpd_tiles.py``) and K3 (``pair_tdpd_v3_kernel``) run on
K1's tiles (``csrc/cell_tiles.cuh`` with the visitor of
``csrc/pair_visitor.cuh``), held here on the CPU. The kernels run only on
the card (chip_smoke.py holds them against their plain versions there);
what decides which pairs they take is the walk over ``tile_table`` and the
visitor's cutoff tests, and a numpy copy of both must give exactly the
plain version's pairs (``pair_dpd_v3._stencil_pairs`` and
``_type_pairs``): the walk takes the table's largest rc^2 with a 1e-4
margin, then the visitor keeps 0 < r^2 < rc_ij^2 on r^2 summed without
fused multiply-adds; without the minimum image dr = (x_i - x_j) - shift,
with it the walk tests the raw difference and takes the minimum image only
where a raw r^2 above 0.24 L_min^2 shows a wrapped axis."""

import math

import numpy as np
import pytest
import torch

from meso_tpu_torch.core import rng as rngmod
from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import create_random
from meso_tpu_torch.kernels import cell_tiles
from meso_tpu_torch.kernels.pair_dpd_v3 import (_stencil_pairs, _type_pairs,
                                                bucket_forces_v3_plain,
                                                bucket_forces_v3_tdpd_plain)
from meso_tpu_torch.neighbor.bucket_layout import to_bucket_state
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops import tdpd as tdpdmod
from meso_tpu_torch.ops.dpd import (DPDParams, build_exclusions,
                                    special_weight)
from meso_tpu_torch.ops.tdpd import TDPDParams
from test_torch_imports import one_torch_thread  # noqa: F401

# the kernels' constants (csrc/pair_visitor.cuh, csrc/cell_tiles.cuh)
EXCL_REGS = 4
SPECIES_BLOCK = 8
F32 = np.float32


def _bucket_case(spill, min_image, l=(9.8, 5.6, 5.6), n=924, seed=3,
                 capacity=None):
    """A bucket state whose rows moved since the rebuild, as chip_smoke.py
    builds its cases: unwrapped by <= skin/2 without min-image,
    box-wrapped with it; types alternate by tag."""
    box = Box.orthorhombic(*l)
    st = create_random(torch.Generator().manual_seed(seed), n, box)
    cfg = CellConfig.for_box(list(l), 1.0, n / (l[0] * l[1] * l[2]),
                             skin=0.4, spill=spill,
                             wrap_at_rebuild=not min_image,
                             capacity=capacity)
    bst = to_bucket_state(st, cfg)
    x = bst.x + torch.clamp(0.04 * bst.v, -0.2, 0.2) * bst.mask[:, None]
    if min_image:
        x = box.wrap(x)[0]
    return bst.replace(x=x, typ=(bst.tag % 2).to(torch.int32)), cfg


def _ragged(p):
    """``p`` narrowed to the widest W below its own whose last run of cx
    is short (the table is built for any W; the plan picks one)."""
    nx = p.ncell[0]
    for w_max in range(p.width, 0, -1):
        n_xtiles = -(-nx // w_max)
        w = -(-nx // n_xtiles)
        if nx % w:
            return cell_tiles.TilePlan(**{**p.__dict__, "width": w,
                                          "n_xtiles": n_xtiles})
    raise AssertionError(f"no ragged plan for {p}")


def _walk(p, bst, cfg, rc_tab):
    """A numpy copy of the kernels' phases over K1's ``tile_table``: per
    block, each line's valid slots staged in (column, slot) order with
    their rows and x wrap shifts (phases A and B), then for every valid
    target of the run the staged sources of its 2 xr + 1 columns on each
    line, kept by the walk's test (phase C) and then by the visitor's.
    Returns (target row, source row, dr (3, n), r^2) of the pairs taken,
    in the kernels' per-row order (dy, dz, dx, slot), and the target rows
    walked, in float32 as the kernels compute."""
    nx = p.ncell[0]
    k, xr = p.capacity, p.xr
    shift = cfg.wrap_at_rebuild
    x = bst.x.numpy()
    valid = bst.mask.numpy()
    typ = bst.typ.numpy().astype(np.int64)
    lens = bst.box.lengths.numpy()
    inv_l = (F32(1.0) / lens).astype(F32)
    nt = rc_tab.shape[0]
    rc2_walk = F32(np.max(rc_tab * rc_tab)) * F32(1.0001)
    wrap2 = F32(0.24) * F32(lens.min()) * F32(lens.min())

    def image(d):
        return d - np.rint(d * inv_l[:, None]) * lens[:, None]

    def sum_r2(d):
        return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]

    rows, srcs, drs, r2s, targets = [], [], [], [], []
    for trow in cell_tiles.tile_table(p).numpy().astype(np.int64):
        width = trow[3]
        ncols = width + 2 * xr
        lines = trow[cell_tiles.HEAD:cell_tiles.COL0].reshape(9, 3)
        cols = trow[cell_tiles.COL0:].reshape(-1, 2)[:ncols]
        staged, first, lsh = [], [], []
        for base, ycode, zcode in lines:
            r = base + np.arange(k)[None, :] * nx + cols[:, :1]
            ok = valid[r]
            xs = np.broadcast_to((cols[:, 1:] * lens[0]).astype(F32),
                                 r.shape)
            staged.append((r[ok], xs[ok]))
            first.append(np.concatenate([[0], np.cumsum(ok.sum(1))]))
            lsh.append((F32(ycode * lens[1]), F32(zcode * lens[2])))
        tl = cell_tiles.TARGET_LINE
        for tc in range(xr, xr + width):
            for ri in staged[tl][0][first[tl][tc]:first[tl][tc + 1]]:
                targets.append(ri)
                for li in range(9):
                    a, b = first[li][tc - xr], first[li][tc + xr + 1]
                    sr, xsh = staged[li][0][a:b], staged[li][1][a:b]
                    d = x[ri][:, None] - x[sr].T
                    if shift:
                        d = d - np.stack([xsh, np.full_like(xsh, lsh[li][0]),
                                          np.full_like(xsh, lsh[li][1])])
                        r2 = sum_r2(d)
                        walk = (r2 < rc2_walk) & (r2 > 0.0)
                    else:
                        raw = sum_r2(d)
                        d = image(d)
                        walk = (raw < rc2_walk) | ((raw > wrap2)
                                                   & (sum_r2(d) < rc2_walk))
                    r2 = sum_r2(d)
                    rc = rc_tab[typ[ri] % nt, typ[sr] % nt] if nt > 1 \
                        else rc_tab[0, 0]
                    keep = walk & (r2 < rc * rc) & (r2 > 0.0)
                    rows.append(np.full(int(keep.sum()), ri))
                    srcs.append(sr[keep])
                    drs.append(d[:, keep])
                    r2s.append(r2[keep])
    return (np.concatenate(rows), np.concatenate(srcs),
            np.concatenate(drs, 1), np.concatenate(r2s),
            np.asarray(targets))


def _plain_pairs(bst, cfg, params):
    """The plain versions' pairs: (row, src, dr (3, n), r^2) in numpy."""
    rc2 = torch.max(params.rc * params.rc)
    parts = [_type_pairs(params, bst.typ, *pair)
             for pair in _stencil_pairs(bst.x, bst.mask, bst.box, cfg, rc2)]
    return (torch.cat([q[0] for q in parts]).numpy(),
            torch.cat([q[1] for q in parts]).numpy(),
            torch.cat([torch.stack(q[2]) for q in parts], 1).numpy(),
            torch.cat([q[3] for q in parts]).numpy())


def _two_types(n_species=0):
    """rc_01 = 0.8 below rc = 1, an asymmetric a table; tDPD with
    ``n_species`` species (rcc 0.8, s1 2) where given."""
    kw = dict(a=[[25.0, 35.0], [30.0, 40.0]], rc=[[1.0, 0.8], [0.8, 1.0]],
              n_types=2, gamma=4.5, kt=1.0, seed=5)
    if n_species:
        return TDPDParams.build(kappa_c=list(np.linspace(0.5, 1.5, n_species)),
                                eps_c=list(np.linspace(0.05, 0.2, n_species)),
                                rcc=0.8, s1=2.0, **kw)
    return DPDParams.build(**kw)


def _exclusions(params, n, e):
    """Exclusion tables of E = e along chains of 8 tags (1..n): each bead's
    neighbours up to e / 2 beads away, so middle beads have e of them."""
    perm = np.random.RandomState(0).permutation(n) + 1
    bonds = [(perm[i], perm[i + d]) for d in range(1, e // 2 + 1)
             for i in range(n - d) if i % 8 + d < 8]
    ex, w = build_exclusions(np.asarray(bonds, np.int32), n, weight=0.5,
                             max_excl=e)
    return params.replace(excl=ex, excl_w=w)


def _sorted(rows, srcs, nr):
    key = rows * nr + srcs
    return key, np.argsort(key, kind="stable")


def _check_pairs(bst, cfg, p, params):
    """The emulated walk's pairs against the plain version's, each once,
    with bitwise dr and r^2, and every valid target walked once."""
    rows, srcs, dr, r2, targets = _walk(p, bst, cfg,
                                        params.rc.numpy().astype(F32))
    prow, psrc, pdr, pr2 = _plain_pairs(bst, cfg, params)
    nr = bst.x.shape[0]
    key, order = _sorted(rows, srcs, nr)
    pkey, porder = _sorted(prow, psrc, nr)
    assert np.unique(key).size == key.size, "a pair taken twice"
    assert np.array_equal(key[order], pkey[porder])
    assert np.array_equal(dr[:, order], pdr[:, porder])
    assert np.array_equal(r2[order], pr2[porder])
    assert np.array_equal(np.sort(targets),
                          np.nonzero(bst.mask.numpy())[0])
    return rows, srcs, dr, r2, order, porder


@pytest.mark.parametrize("min_image", [False, True])
@pytest.mark.parametrize("spill", [True, False])
def test_general_walk_is_the_plain_walk(spill, min_image):
    """Two types with rc_01 = 0.8, a box 5.6 wide on two axes (4 cells:
    raw differences across the box wrap within reach of the walk's
    radius), ragged runs of cx."""
    bst, cfg = _bucket_case(spill, min_image)
    p = _ragged(cell_tiles.plan(cfg.capacity, 2 if spill else 1, cfg.ncell))
    assert cfg.ncell[0] % p.width and cfg.ncell[1:] == (4, 4)
    _check_pairs(bst, cfg, p, _two_types())


@pytest.mark.parametrize("min_image", [False, True])
def test_general_walk_at_k128(min_image):
    """A rho 9 fluid at a capacity of 128 spill (one block an SM, rows with
    more partners than a list holds: the list flushes and the walk goes on
    from where it stopped, the same pairs in the same order)."""
    bst, cfg = _bucket_case(True, min_image, l=(7.0, 4.2, 4.2), n=1111,
                            capacity=128)
    p = cell_tiles.plan(cfg.capacity, 2, cfg.ncell)
    assert p.blocks_per_sm() == 1
    rows, *_ = _check_pairs(bst, cfg, p, _two_types())
    assert np.bincount(rows).max() > cell_tiles.LIST_CAP


@pytest.mark.parametrize("e", [2, 6])
@pytest.mark.parametrize("min_image", [False, True])
def test_exclusions(min_image, e):
    """The visitor's exclusion test on the walk's pairs (the target's first
    EXCL_REGS tags in registers, the rest read on a hit test; none for a
    tag outside the table) gives the plain version's special weights; E =
    6 is above EXCL_REGS and middle beads fill all six."""
    bst, cfg = _bucket_case(True, min_image)
    params = _exclusions(_two_types(), int(bst.tag.max()), e)
    p = cell_tiles.plan(cfg.capacity, 2, cfg.ncell)
    rows, srcs, _, _, order, porder = _check_pairs(bst, cfg, p, params)
    tag = bst.tag.numpy()
    excl = params.excl.numpy()
    ti, tj = tag[rows], tag[srcs]
    in_table = (ti >= 0) & (ti < excl.shape[0])
    ex = excl[np.where(in_table, ti, 0)]
    hit = in_table & (ex[:, :EXCL_REGS] == tj[:, None]).any(1)
    hit |= in_table & (ex[:, EXCL_REGS:] == tj[:, None]).any(1)
    w = np.where(hit, F32(params.excl_w), F32(1.0))
    prow, psrc, _, _ = _plain_pairs(bst, cfg, params)
    want = special_weight(torch.from_numpy(tag[prow]),
                          torch.from_numpy(tag[psrc]), params).numpy()
    assert np.array_equal(w[order], want[porder])
    assert (w != 1.0).sum() > 0
    if e == 6:
        assert (hit & ~(ex[:, :EXCL_REGS] == tj[:, None]).any(1)).any(), \
            "no hit beyond the registers"


@pytest.mark.parametrize("min_image", [False, True])
@pytest.mark.parametrize("spill", [True, False])
def test_debug_pairs_bitwise(spill, min_image):
    """debug_pairs: each row's partner count and sum of keys h_j >> 18, as
    the visitor adds them in float32 in walk order, bitwise equal to the
    plain version's."""
    bst, cfg = _bucket_case(spill, min_image)
    params = _exclusions(_two_types(), int(bst.tag.max()), 2)
    p = _ragged(cell_tiles.plan(cfg.capacity, 2 if spill else 1, cfg.ncell))
    rows, srcs, *_ = _walk(p, bst, cfg, params.rc.numpy().astype(F32))
    h = rngmod.particle_hash(bst.tag, 17, params.seed).numpy()
    nr = bst.x.shape[0]
    f = np.zeros((nr, 3), F32)
    for ri, sj in zip(rows, srcs):   # the visitor's order and arithmetic
        f[ri, 0] += F32(1.0)
        f[ri, 1] += F32(h[sj] >> 18)
    want, _ = bucket_forces_v3_plain(bst.x, bst.v, bst.tag, bst.mask,
                                     bst.box, 17, params, 0.01, cfg,
                                     typ=bst.typ, debug_pairs=True)
    assert np.array_equal(f, want.numpy())


@pytest.mark.parametrize("ns", [1, 10])
@pytest.mark.parametrize("min_image", [False, True])
def test_tdpd_pairs_inside_rcc(min_image, ns):
    """K3: the walk's pairs inside rcc (r^2 < rcc^2 in float32, as the
    visitor tests it) are the plain version's flux pairs; the species
    blocks (one register for one species, else SPECIES_BLOCK, grid.y
    over the blocks) write every species of every row once; and the flux
    summed over the walk's pairs in walk order is the plain version's."""
    bst, cfg = _bucket_case(True, min_image)
    params = _two_types(ns)
    p = _ragged(cell_tiles.plan(cfg.capacity, 2, cfg.ncell))
    rows, srcs, dr, r2, order, porder = _check_pairs(bst, cfg, p, params)
    rcc2 = F32(params.rcc) * F32(params.rcc)
    inside = r2 < rcc2
    prow, psrc, _, pr2 = _plain_pairs(bst, cfg, params)
    assert np.array_equal(inside[order], (pr2 < params.rcc ** 2)[porder])
    sb = 1 if ns == 1 else SPECIES_BLOCK
    written = [s0 + s for s0 in range(0, -(-ns // sb) * sb, sb)
               for s in range(sb) if s0 + s < ns]
    assert written == list(range(ns))
    m = bst.mask
    c = torch.where(m[:, None], 1.0 + 0.1 * torch.arange(ns)
                    + 0.5 * torch.cos(bst.x[:, :1] + torch.arange(ns)), 0.0)
    hp = rngmod.combine_symmetric(
        *(rngmod.particle_hash(bst.tag, 12, params.seed)[torch.from_numpy(i)]
          for i in (rows, srcs)))
    tag = bst.tag
    ri, sj = torch.from_numpy(rows), torch.from_numpy(srcs)
    _, xi = tdpdmod.noises_from_hash(hp, tag[ri], tag[sj], ns)
    q = tdpdmod.tdpd_flux(torch.from_numpy(dr.T.copy()), c[ri], c[sj], xi,
                          params.kappa_c, params.eps_c, params.rcc,
                          params.s1, 1.0 / math.sqrt(0.01), True)
    flux = torch.zeros((bst.x.shape[0], ns)).index_add_(0, ri, q)
    _, want, _ = bucket_forces_v3_tdpd_plain(bst.x, bst.v, c, bst.tag, m,
                                             bst.box, 12, params, 0.01, cfg,
                                             typ=bst.typ)
    torch.testing.assert_close(flux, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,xr", [(16, 2), (17, 2), (18, 2), (28, 1)])
def test_paths_share_k1s_plan(k, xr):
    """K1's general variant, K2 and K3 stage K1's record (x, y, z, the x
    shift and the row): K1's plan and table unchanged, two blocks an SM at
    the walls' and the eDPD path's (16), polymers' (17) and tDPD path's
    (18) spill capacities and at 28 strict."""
    p = cell_tiles.plan(k, xr, (50, 50, 50))
    assert p.blocks_per_sm() >= 2
    assert p.smem_bytes == cell_tiles.smem_bytes(p.ncols, k, p.threads,
                                                 p.list_cap)
