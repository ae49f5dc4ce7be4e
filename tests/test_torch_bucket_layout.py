"""The port's bucket layout and rebuild (meso_tpu_torch/neighbor/) against
the JAX package's: slot assignment, dummy targets, both rebuild engines,
the deferred wrap with its wrap-relief pre-shift, and the overflow check
give bitwise-equal placement on the same input state. The cases mirror
tests/unit/test_spill_assign.py, test_bucket.py and test_wrap_mode.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.neighbor import bucket_layout as jbl
from meso_tpu.neighbor.cells import CellConfig as JCellConfig
from meso_tpu.neighbor.cells import max_displacement_sq as j_max_disp
from meso_tpu_torch import bridge
from meso_tpu_torch.neighbor import bucket_layout as tbl
from meso_tpu_torch.neighbor.cells import CellConfig, max_displacement_sq
from test_torch_imports import one_torch_thread  # noqa: F401

FIELDS = ("x", "v", "f", "tag", "typ", "mol", "image", "mask")

# the JAX side runs jitted, as its own tests run it: eager dispatch of
# these graphs costs seconds per case
j_spill_assign = jax.jit(jbl.spill_assign, static_argnums=(3, 4, 5, 6, 7))
j_dummy_targets = jax.jit(jbl._dummy_targets, static_argnums=(2,))
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
    """Sorted-key inputs as both rebuild engines produce them (the same
    generator as tests/unit/test_spill_assign.py)."""
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
def test_spill_assign_and_dummy_targets_bitwise(nx, n_rows_yz, k, mean_occ,
                                                wrap):
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
        target, fits = got[0], got[1]
        np.testing.assert_array_equal(
            tbl._dummy_targets(target, fits, nr).numpy(),
            np.asarray(j_dummy_targets(want[0], want[1], nr)))


@pytest.mark.parametrize("spill", [False, True])
def test_first_conversion_gather_engine_bitwise(spill):
    """N-row state -> bucket rows (n != nr): the gather engine."""
    st, cfg = _jax_state(8.0, 1536, 3, spill=spill, rebuild="sort")
    want = jbl.to_bucket_state(st, cfg)
    tcfg = bridge.cell_config_from(cfg)
    got = tbl.to_bucket_state(bridge.state_from(st), tcfg)
    assert got.n == tbl.n_rows(tcfg)
    _assert_state_bitwise(want, got)


@pytest.mark.parametrize("engine", ["gather", "sort"])
@pytest.mark.parametrize("spill", [False, True])
def test_steady_state_rebuild_bitwise(spill, engine):
    """Drifted nr-row state: both engines, step-wrapped positions."""
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
    """A capacity far too small: both engines count the same overflow, and
    to_bucket_state raises in both packages."""
    st, cfg = _jax_state(8.0, 1536, 5, spill=spill, cap=4)
    _, of_w = j_rebuild(st, cfg)
    tst, tcfg = bridge.state_from(st), bridge.cell_config_from(cfg)
    _, of_g = tbl.rebuild_buckets(tst, tcfg)
    assert int(of_g) == int(of_w) > 0
    with pytest.raises(ValueError, match="overflowed"):
        jbl.to_bucket_state(st, cfg)
    with pytest.raises(ValueError, match="overflowed"):
        tbl.to_bucket_state(tst, tcfg)


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
