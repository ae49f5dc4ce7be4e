"""The port's bucket layout and rebuild (meso_tpu_torch/neighbor/) against
the JAX package's: slot assignment, the port's one placement against both
of JAX's rebuild engines, for fewer and for more input rows than bucket
rows, the deferred wrap with its wrap-relief pre-shift, and the overflow
check give bitwise-equal placement on the same input state. The cases
mirror tests/unit/test_spill_assign.py, test_bucket.py and
test_wrap_mode.py.
Also a numpy copy of the slot-assignment kernel's blocks
(csrc/bucket_assign.cu), which runs only on the card, against the plain
version it replaces there."""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import assign_inputs
from meso_tpu.core.box import Box as JBox
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.neighbor import bucket_layout as jbl
from meso_tpu.neighbor.cells import CellConfig as JCellConfig
from meso_tpu.neighbor.cells import max_displacement_sq as j_max_disp
from meso_tpu_torch import bridge
from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import create_random
from meso_tpu_torch.neighbor import bucket_layout as tbl
from meso_tpu_torch.neighbor.cells import CellConfig, max_displacement_sq
from test_torch_imports import one_torch_thread  # noqa: F401

FIELDS = ("x", "v", "f", "tag", "typ", "mol", "image", "mask")

# the JAX side runs jitted, as its own tests run it: eager dispatch of
# these graphs costs seconds per case
j_spill_assign = jax.jit(jbl.spill_assign, static_argnums=(3, 4, 5, 6, 7))
j_rebuild = jax.jit(jbl.rebuild_buckets, static_argnames="cfg")


def _assert_state_bitwise(jst, tst):
    got = bridge.state_to_numpy(tst)
    for name in FIELDS:
        want = np.asarray(getattr(jst, name))
        assert got[name].dtype == want.dtype, name
        if want.dtype == np.float32:
            np.testing.assert_array_equal(got[name].view(np.uint32),
                                          want.view(np.uint32), err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)
    assert tst.step == int(jst.step)


def _jax_state(l, n, seed, skin=0.3, spill=True, wrap=False, cap=None,
               rebuild="sort"):
    box = JBox.cubic(l)
    st = j_create_random(jax.random.PRNGKey(seed), n, box, kt=1.0)
    cfg = JCellConfig.for_box([l] * 3, rc=1.0, density=n / l ** 3, skin=skin,
                              spill=spill, capacity=cap, rebuild=rebuild,
                              wrap_at_rebuild=wrap)
    return st, cfg


def _make_case(seed, nx, n_rows_yz, k, mean_occ, n_pad):
    """Sorted-key inputs as the rebuild produces them (the same generator
    as tests/unit/test_spill_assign.py)."""
    rng = np.random.default_rng(seed)
    n_cells = n_rows_yz * nx
    occ = rng.poisson(mean_occ, size=n_cells)
    hot = rng.integers(0, n_cells, size=max(n_cells // 16, 1))
    occ[hot] += rng.integers(k, 2 * k, size=hot.size)
    keys = np.repeat(np.arange(n_cells, dtype=np.int32), occ)
    n_valid = keys.size
    keys = np.concatenate([keys, np.full(n_pad, n_cells, np.int32)])
    valid = np.arange(keys.size) < n_valid
    return keys // nx, keys % nx, valid


SPILL_CASES = [(5, 4, 4, 1.0), (8, 16, 8, 3.0), (16, 36, 16, 9.2),
               (8, 8, 4, 6.0), (46, 9, 16, 9.2)]


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("nx,n_rows_yz,k,mean_occ", SPILL_CASES)
def test_spill_assign_bitwise(nx, n_rows_yz, k, mean_occ, wrap):
    nr = n_rows_yz * nx * k
    for seed in range(2):
        base, cxs, valid = _make_case(1000 * seed + nx + k, nx, n_rows_yz, k,
                                      mean_occ, n_pad=nr // 3)
        n_in = base.size
        want = j_spill_assign(jnp.asarray(base), jnp.asarray(cxs),
                              jnp.asarray(valid), n_in, nx, k, n_rows_yz,
                              wrap)
        got = tbl.spill_assign(torch.from_numpy(base.astype(np.int64)),
                               torch.from_numpy(cxs.astype(np.int64)),
                               torch.from_numpy(valid), n_in, nx, k,
                               n_rows_yz, wrap)
        for g, w, name in zip(got, want, ("target", "fits", "overflow")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


@pytest.mark.parametrize("spill", [False, True])
def test_first_conversion_gather_engine_bitwise(spill):
    """N-row state -> bucket rows (n != nr): JAX's gather engine (its sort
    engine takes only nr rows) against the port's one placement."""
    st, cfg = _jax_state(8.0, 1536, 3, spill=spill, rebuild="sort")
    want = jbl.to_bucket_state(st, cfg)
    tcfg = bridge.cell_config_from(cfg)
    got = tbl.to_bucket_state(bridge.state_from(st), tcfg)
    assert got.n == tbl.n_rows(tcfg)
    _assert_state_bitwise(want, got)


@pytest.mark.parametrize("engine", ["gather", "sort"])
@pytest.mark.parametrize("spill", [False, True])
def test_steady_state_rebuild_bitwise(spill, engine):
    """Drifted nr-row state, step-wrapped positions: each of JAX's engines
    against the port's one placement."""
    st, cfg = _jax_state(8.0, 1536, 4, spill=spill, rebuild=engine)
    bst = jbl.to_bucket_state(st, cfg)
    bst = bst.replace(x=bst.box.wrap(bst.x + 0.05 * bst.v)[0],
                      step=jnp.int32(12))
    want, of_w = j_rebuild(bst, cfg)
    got, of_g = tbl.rebuild_buckets(bridge.state_from(bst),
                                    bridge.cell_config_from(cfg))
    assert int(of_g) == int(of_w) == 0
    _assert_state_bitwise(want, got)


@pytest.mark.parametrize("engine", ["gather", "sort"])
@pytest.mark.parametrize("spill", [False, True])
def test_deferred_wrap_rebuild_bitwise(spill, engine):
    """wrap_at_rebuild: rows drifted out of the box are wrapped at rebuild
    (test_wrap_mode.py:37-48 builds the same drift)."""
    st, cfg = _jax_state(8.0, 1536, 3, spill=spill, wrap=True, rebuild=engine)
    bst = jbl.to_bucket_state(st, cfg)
    drift = jnp.clip(0.04 * bst.v, -0.15, 0.15)
    bst = bst.replace(x=bst.x + drift * bst.mask[:, None])
    assert float(bst.x.min()) < 0 or float(bst.x.max()) > 8.0
    want, of_w = j_rebuild(bst, cfg)
    got, of_g = tbl.rebuild_buckets(bridge.state_from(bst),
                                    bridge.cell_config_from(cfg))
    assert int(of_g) == int(of_w) == 0
    _assert_state_bitwise(want, got)


@pytest.mark.parametrize("engine", ["gather", "sort"])
def test_wrap_relief_preshift_bitwise(engine):
    """The forced wrap-relief layout of test_wrap_mode.py::
    test_wrap_relief_preshift_under_deferred_wrap: K + 6 particles piled in
    the last x-cell of an emptied row must wrap into cell 0, pre-shifted
    one image left."""
    l, n = 8.0, 1536
    st, cfg = _jax_state(l, n, 11, spill=True, wrap=True, rebuild=engine)
    nx, ncy, ncz = cfg.ncell
    k = cfg.capacity
    x = np.array(st.x)
    side_y, side_z = l / ncy, l / ncz
    in_row = (x[:, 1] < side_y) & (x[:, 2] < side_z)
    x[in_row, 1] = side_y + (x[in_row, 0] / l) * (l - 1.5 * side_y)
    n_pile = k + 6
    band_lo = l * (nx - 1) / nx
    x[:n_pile, 0] = band_lo + (l / nx) * np.linspace(0.05, 0.95, n_pile)
    x[:n_pile, 1] = 0.4 * side_y
    x[:n_pile, 2] = 0.4 * side_z
    st = st.replace(x=jnp.asarray(x))
    bst = jbl.to_bucket_state(st, dataclasses.replace(cfg,
                                                      wrap_at_rebuild=False))
    want, of_w = j_rebuild(bst, cfg)
    got, of_g = tbl.rebuild_buckets(bridge.state_from(bst),
                                    bridge.cell_config_from(cfg))
    assert int(of_g) == int(of_w) == 0
    _assert_state_bitwise(want, got)
    xs = got.x[got.mask]
    assert bool((xs[:, 0] < 0).any()), "case failed to trigger wrap relief"


@pytest.mark.parametrize("spill", [False, True])
def test_overflow_count_and_error(spill):
    """A capacity far too small: both packages count the same overflow, and
    to_bucket_state raises in both."""
    st, cfg = _jax_state(8.0, 1536, 5, spill=spill, cap=4)
    _, of_w = j_rebuild(st, cfg)
    tst, tcfg = bridge.state_from(st), bridge.cell_config_from(cfg)
    _, of_g = tbl.rebuild_buckets(tst, tcfg)
    assert int(of_g) == int(of_w) > 0
    with pytest.raises(ValueError, match="overflowed"):
        jbl.to_bucket_state(st, cfg)
    with pytest.raises(ValueError, match="overflowed"):
        tbl.to_bucket_state(tst, tcfg)


def _merged_with_migrants(bst, n_mig):
    """A slab's rows after its migration: the bucket rows with their first
    ``n_mig`` valid rows gone (masked) and those rows appended, moved 0.2
    along x (some out of the box), as the rows that came in."""
    rows = np.flatnonzero(np.asarray(bst.mask))[:n_mig]
    mig = {f: getattr(bst, f)[rows] for f in FIELDS}
    mig["x"] = mig["x"].at[:, 0].add(0.2)
    out = bst.replace(mask=bst.mask.at[rows].set(False))
    return out.replace(**{f: jnp.concatenate([getattr(out, f), mig[f]])
                          for f in FIELDS})


@pytest.mark.parametrize("rows", ["fewer", "more"])
@pytest.mark.parametrize("spill", [False, True])
def test_place_rows_takes_any_row_count_bitwise(spill, rows):
    """place_rows on the keys and slot targets of fewer input rows than
    bucket rows (an N-row start) and of more (a slab merged with its
    migrants, as ``run_distributed`` rebuilds it) gives JAX's gather
    engine's placement and overflow, bitwise; on spill buckets with the
    deferred wrap and its relief."""
    st, cfg = _jax_state(8.0, 1536, 6, spill=spill, wrap=spill,
                         rebuild="gather")
    nr = jbl.n_rows(cfg)
    if rows == "more":
        st = _merged_with_migrants(jbl.to_bucket_state(st, cfg), 300)
    assert (st.n > nr) == (rows == "more")
    want, of_w = j_rebuild(st, cfg)
    tcfg = bridge.cell_config_from(cfg)
    tst, key = tbl.cell_keys(bridge.state_from(st), tcfg,
                             tcfg.wrap_at_rebuild)
    order, target, fits, overflow, relief = tbl.slot_targets(key, tcfg)
    got = tbl.place_rows(tst, order, target, fits, nr, relief)
    assert int(overflow) == int(of_w)
    _assert_state_bitwise(want, got)


@pytest.mark.parametrize("l,rc,density,skin,spill", [
    (8.0, 1.0, 3.0, 0.3, True), (8.0, 1.0, 3.0, 0.4, False),
    (70.0, 1.0, 3.0, 0.4, True), ([9.0, 6.0, 4.0], 1.0, 3.0, 0.3, True),
    (4.5, 1.0, 3.0, 0.3, True), (12.0, 1.2, 4.0, 0.2, False)])
def test_cell_config_for_box_matches(l, rc, density, skin, spill):
    lens = l if isinstance(l, list) else [l] * 3
    want = JCellConfig.for_box(lens, rc, density, skin=skin, spill=spill)
    got = CellConfig.for_box(lens, rc, density, skin=skin, spill=spill)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_box_wrap_and_displacement_bitwise():
    rng = np.random.default_rng(9)
    x = rng.uniform(-3.0, 11.0, size=(4096, 3)).astype(np.float32)
    x[:3] = [[8.0, 0.0, -0.0], [-1e-7, 7.9999995, 16.0], [-8.0, 24.0, 4.0]]
    image = rng.integers(-2, 3, size=(4096, 3)).astype(np.int32)
    jb = JBox.cubic(8.0)
    tb = bridge.box_from(jb)
    xw_j, im_j = jb.wrap(jnp.asarray(x), jnp.asarray(image))
    xw_t, im_t = tb.wrap(torch.from_numpy(x), torch.from_numpy(image))
    np.testing.assert_array_equal(xw_t.numpy().view(np.uint32),
                                  np.asarray(xw_j).view(np.uint32))
    np.testing.assert_array_equal(im_t.numpy(), np.asarray(im_j))
    x_ref = x + rng.normal(0, 0.1, size=x.shape).astype(np.float32)
    mask = rng.random(4096) < 0.9
    want = j_max_disp(jnp.asarray(x), jnp.asarray(x_ref), jnp.asarray(mask),
                      jb)
    got = max_displacement_sq(torch.from_numpy(x), torch.from_numpy(x_ref),
                              torch.from_numpy(mask), tb)
    assert float(got) == float(want)


# the slot-assignment kernel's constants (csrc/bucket_assign.cu)
ASSIGN_THREADS = 128
ASSIGN_ROWS = 4
ASSIGN_CHUNK = ASSIGN_THREADS * ASSIGN_ROWS
TAIL_SPAN = 8192
WARP = 32


def test_assign_constants_mirror_the_kernel():
    src = (Path(tbl.__file__).parents[1] / "csrc" / "bucket_assign.cu"
           ).read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert (int(consts["kAssignThreads"]), int(consts["kAssignRows"]),
            int(consts["kTailSpan"])) == (ASSIGN_THREADS, ASSIGN_ROWS,
                                          TAIL_SPAN)


def _warp_lower_bound(a, lo, hi, key):
    """The kernel's 32-way search: the first index in [lo, hi) with
    a[i] >= key, hi if none; 32 probes a round while more than 32 rows
    remain, then one probe a lane."""
    lanes = np.arange(WARP)
    while hi - lo > WARP:
        n = hi - lo
        ge = a[lo + n * lanes // WARP] >= key
        if not ge.any():
            lo += n * 31 // WARP + 1
        else:
            f = int(np.argmax(ge))
            nlo = lo if f == 0 else lo + n * (f - 1) // WARP + 1
            hi = lo + n * f // WARP
            lo = nlo
    idx = lo + lanes
    ge = (idx < hi) & (a[np.minimum(idx, a.size - 1)] >= key) \
        if a.size else np.zeros(WARP, bool)
    return lo + int(np.argmax(ge)) if ge.any() else hi


def _warp_max_scan(m):
    """Inclusive max-scan of each warp's lanes by shuffles up 1, 2, 4, 8,
    16 (a lane below the distance keeps its value)."""
    incl = m.reshape(-1, WARP).copy()
    lane = np.arange(WARP)
    d = 1
    while d < WARP:
        up = np.concatenate([incl[:, :d], incl[:, :-d]], axis=1)
        incl = np.where(lane >= d, np.maximum(incl, up), incl)
        d *= 2
    return incl


def _assign_emulated(base, cxs, valid, nx, k, n_rows_yz, wrap):
    """The kernel's blocks, one after another: a segment block per (cy, cz)
    row (its bounds and c0_used by the 32-way search, then its chunks:
    threads' running maxima, the warps' scans, the warps' maxima and the
    carry), then the tail blocks over [t0, n_in)."""
    n_in = base.size
    nr = n_rows_yz * k * nx
    target = np.full(n_in, -7, np.int64)
    fits = np.ones(n_in, bool)
    overflow = 0
    for b in range(n_rows_yz):
        s = _warp_lower_bound(base, 0, n_in, b)
        e = _warp_lower_bound(base, 0, n_in, b + 1)
        c0_used = (_warp_lower_bound(cxs, s, min(e, s + k), 1) - s
                   if wrap else 0)
        carry = 0
        for c in range(s, e, ASSIGN_CHUNK):
            i = c + np.arange(ASSIGN_CHUNK)
            live = i < e
            il = np.minimum(i, e - 1)
            cx, v = cxs[il], valid[il] & live
            a = np.where(live, np.maximum(cx * k - (i - s), 0), 0)
            run = np.maximum.accumulate(a.reshape(ASSIGN_THREADS, ASSIGN_ROWS),
                                        axis=1)
            incl = _warp_max_scan(run[:, -1])
            before = np.concatenate([np.zeros((incl.shape[0], 1), np.int64),
                                     incl[:, :-1]], axis=1)
            warp_max = incl[:, -1]
            prev = np.maximum.accumulate(np.concatenate([[carry],
                                                         warp_max[:-1]]))
            before = np.maximum(before, prev[:, None]).reshape(-1)
            carry = max(carry, int(warp_max.max()))
            am = np.maximum(run, before[:, None]).reshape(-1)
            l_lin = (i - s) + am
            in_row = v & (l_lin < np.minimum((cx + 2) * k, nx * k))
            over = l_lin - nx * k
            wrap_ok = (wrap & v & ~in_row & (cx == nx - 1) & (over >= 0)
                       & (over < k) & (k - 1 - over >= c0_used))
            fit = in_row | wrap_ok
            cell = np.where(wrap_ok, 0, l_lin // k)
            slot = np.where(wrap_ok, k - 1 - over, l_lin - (l_lin // k) * k)
            tg = np.where(fit, (b * k + slot) * nx + cell, nr + i)
            target[i[live]] = tg[live]
            fits[i[live]] = fit[live]
            overflow += int((v & ~fit).sum())
    n_tail = -(-n_in // TAIL_SPAN)
    for j in range(n_tail):
        t0 = _warp_lower_bound(base, 0, n_in, n_rows_yz)
        i = np.arange(t0 + j * ASSIGN_THREADS, n_in, n_tail * ASSIGN_THREADS)
        i = (i[:, None] + np.arange(ASSIGN_THREADS)).reshape(-1)
        i = i[i < n_in]
        target[i] = nr + i
        fits[i] = False
    return target, fits, overflow


def _keys_case(kind, k):
    """(base, cxs, valid, nx, n_rows_yz) as the callers of spill_assign
    build them: the nr rows of a drifted bucket state, an N-row start, a
    brick's rows with those outside it masked, and generated keys: long
    rows (K 216, rho 200), sparse rows with empty (cy, cz) segments, and
    a pile in a row's last cell that spills past the row and wraps into
    cell 0."""
    if kind in ("sort", "start", "brick"):
        l, n = 12.0, int(round((6.0 if k > 24 else 3.0) * 12.0 ** 3))
        box = Box.cubic(l)
        st = create_random(torch.Generator().manual_seed(k), n, box)
        cfg = CellConfig.for_box([l] * 3, 1.0, n / l ** 3, skin=0.4,
                                 spill=True, capacity=k)
        if kind != "start":
            # bucket rows (a random start's few overflowing rows dropped)
            st = tbl.rebuild_buckets(st, cfg)[0]
            st = st.replace(x=st.box.wrap(st.x + 0.05 * st.v)[0])
        base, cxs, valid, _, nx, _, n_rows_yz = assign_inputs(
            st, cfg, brick=kind == "brick")
        return base.numpy(), cxs.numpy(), valid.numpy(), nx, n_rows_yz
    if kind == "pile":
        nx, n_rows_yz = 6, 3
        keys = sorted([0] * 2 + [5] * (k + 6) + list(range(6, 18))
                      + [7] * (3 * k) + [nx * n_rows_yz] * 5)
    else:
        nx, n_rows_yz, occ = {"long": (8, 6, 200.0),
                              "sparse": (3, 40, 0.2)}[kind]
        rng = np.random.default_rng(k)
        n_cells = n_rows_yz * nx
        counts = rng.poisson(occ, size=n_cells)
        hot = rng.integers(0, n_cells, size=3)
        counts[hot] += rng.integers(k, 2 * k, size=hot.size)
        keys = np.repeat(np.arange(n_cells), counts).tolist() \
            + [n_cells] * 29
    keys = np.asarray(keys, np.int64)
    return keys // nx, keys % nx, keys < nx * n_rows_yz, nx, n_rows_yz


ASSIGN_CASES = [("sort", 16), ("sort", 28), ("start", 16), ("start", 28),
                ("brick", 16), ("long", 216), ("sparse", 16), ("sparse", 28),
                ("pile", 16), ("pile", 28)]


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("kind,k", ASSIGN_CASES)
def test_assign_kernel_emulation_matches_plain_bitwise(kind, k, wrap):
    """The numpy copy of the kernel's block algorithm gives the plain
    version's target, fits and overflow, bitwise."""
    base, cxs, valid, nx, n_rows_yz = _keys_case(kind, k)
    n_in = base.size
    got = _assign_emulated(base, cxs, valid, nx, k, n_rows_yz, wrap)
    want = tbl.spill_assign_plain(torch.from_numpy(base),
                                  torch.from_numpy(cxs),
                                  torch.from_numpy(valid), n_in, nx, k,
                                  n_rows_yz, wrap)
    np.testing.assert_array_equal(got[0], want[0].numpy(), err_msg="target")
    np.testing.assert_array_equal(got[1], want[1].numpy(), err_msg="fits")
    assert got[2] == int(want[2])
    # what each case is there for
    seg = np.bincount(base[valid], minlength=n_rows_yz)
    if kind == "long":
        assert seg.max() > ASSIGN_CHUNK
    if kind == "sparse":
        assert (seg == 0).any()
    if kind in ("pile", "long"):
        assert got[2] > 0
    if kind == "pile" and wrap:
        t = want[0].numpy()
        assert (want[1].numpy() & (cxs == nx - 1) & (t % nx == 0)).any()
    if kind in ("start", "brick"):
        assert n_in != n_rows_yz * k * nx
    if kind == "sort":
        assert n_in == n_rows_yz * k * nx
