"""K1's general cases in the port against the JAX package's dense oracle:
two particle types with an asymmetric a table and rc_01 = 0.8 < rc = 1,
s_exp = 0.5, special-bonds exclusions (E = 2, weight 0.25, random chains)
and debug_pairs accounting, as chip_smoke.py holds the CUDA kernel against
this plain version on the card.

Bounds are the JAX v3 tests' own (tests/unit/test_pallas_v3.py:40-59):
max relative force error 2e-5 with min-image and 5e-5 without, pad rows
exactly 0, relative virial error 1e-4 (1e-3 without min-image). Pair
counts and key sums are integers and compared bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.rng import particle_hash as j_particle_hash
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.neighbor.bucket_layout import to_bucket_state as j_to_bucket
from meso_tpu.neighbor.cells import CellConfig as JCellConfig
from meso_tpu.ops.dpd import DPDParams as JDPDParams
from meso_tpu.ops.dpd import build_exclusions as j_build_exclusions
from meso_tpu.ops.dpd import dense_forces as j_dense
from meso_tpu.ops.dpd import special_weight as j_special_weight
from meso_tpu_torch import bridge
from meso_tpu_torch.kernels.pair_dpd_v3 import (bucket_forces_pallas_v3,
                                                bucket_forces_v3_plain)
from meso_tpu_torch.ops.dpd import (build_exclusions, dense_forces,
                                    special_weight)
from test_torch_imports import one_torch_thread  # noqa: F401

STEP = 42
L, N = 7.0, 1029


def _chains(n, chain_len=8, seed=0):
    """Bonds along random chains of tags 1..n: at most two per tag."""
    perm = np.random.RandomState(seed).permutation(n) + 1
    bonds = [(perm[i], perm[i + 1]) for i in range(n - 1)
             if (i + 1) % chain_len]
    return np.asarray(bonds, np.int32)


def _params(s_exp=0.5, excl=True):
    p = JDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=77,
                         n_types=2, s_exp=s_exp)
    p = p.replace(a=p.a * jnp.asarray([[1.0, 1.4], [1.2, 2.0]]),
                  rc=p.rc * jnp.asarray([[1.0, 0.8], [0.8, 1.0]]))
    if excl:
        ex, w = j_build_exclusions(_chains(N), N, weight=0.25, max_excl=2)
        p = p.replace(excl=ex, excl_w=w)
    return p


def _bucket_case(spill, min_image, skin=0.3, seed=3):
    """A two-type JAX bucket state whose rows moved since the rebuild."""
    box = JBox.cubic(L)
    st = j_create_random(jax.random.PRNGKey(seed), N, box, kt=1.0)
    st = st.replace(typ=jnp.arange(N, dtype=jnp.int32) % 2)
    cfg = JCellConfig.for_box([L] * 3, rc=1.0, density=N / L ** 3, skin=skin,
                              spill=spill, wrap_at_rebuild=not min_image)
    bst = j_to_bucket(st, cfg)
    drift = jnp.clip(0.04 * bst.v, -skin / 2, skin / 2) * bst.mask[:, None]
    x = bst.x + drift
    if min_image:
        x = box.wrap(x)[0]
    return bst.replace(x=x), cfg


def _valid(bst):
    m = np.asarray(bst.mask)
    return m, np.flatnonzero(m)


def _jax_key_sums(bst, p, idx):
    """Per-row sum of the in-range partners' 14-bit keys, from the dense
    oracle's own pair test (meso_tpu/ops/dpd.py:205-224)."""
    x, typ, tag = bst.x[idx], bst.typ[idx], bst.tag[idx]
    dr = bst.box.min_image(x[:, None, :] - x[None, :, :])
    rc = p.rc[typ[:, None], typ[None, :]]
    r2 = jnp.sum(dr * dr, axis=-1)
    ok = (r2 < rc * rc) & (r2 > 0.0) & ~jnp.eye(idx.size, dtype=bool)
    keys = np.asarray(j_particle_hash(tag, jnp.int32(STEP), p.seed)) >> 18
    return (np.asarray(ok) * keys[None, :].astype(np.float64)).sum(1)


@pytest.mark.parametrize("min_image", [True, False])
@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("rng_mode", ["fast", "tea"])
def test_general_plain_matches_jax_dense(rng_mode, spill, min_image):
    bst, cfg = _bucket_case(spill, min_image)
    jp = _params()
    m, idx = _valid(bst)
    f_d, vir_d, nn_d = j_dense(bst.x[idx], bst.v[idx], bst.typ[idx],
                               bst.tag[idx], bst.mask[idx], bst.box,
                               jnp.int32(STEP), jp, 0.01, rng_mode=rng_mode)
    tst = bridge.state_from(bst)
    tp = bridge.dpd_params_from(jp)
    tcfg = bridge.cell_config_from(cfg)
    args = (tst.x, tst.v, tst.typ, tst.tag, tst.mask, tst.box, STEP, tp,
            0.01, tcfg)
    f_t, vir_t = bucket_forces_pallas_v3(*args, rng_mode=rng_mode, s_exp=0.5)
    fp, f_d = f_t.numpy(), np.asarray(f_d)
    assert np.isfinite(fp).all()
    rel = np.abs(fp[idx] - f_d).max() / np.abs(f_d).max()
    assert rel < (2e-5 if min_image else 5e-5), rel
    assert (~m).any() and np.abs(fp[~m]).max() == 0.0
    assert abs(float(vir_t) - float(vir_d)) / abs(float(vir_d)) < (
        1e-4 if min_image else 1e-3)

    # debug_pairs: in-range partners and their key sums, bitwise
    f_dbg, vir_dbg = bucket_forces_pallas_v3(*args, rng_mode=rng_mode,
                                             s_exp=0.5, debug_pairs=True)
    dbg = f_dbg.numpy()
    np.testing.assert_array_equal(dbg[idx, 0],
                                  np.asarray(nn_d).astype(np.float32))
    np.testing.assert_array_equal(dbg[idx, 1].astype(np.float64),
                                  _jax_key_sums(bst, jp, idx))
    assert (dbg[:, 2] == 0.0).all() and np.abs(dbg[~m]).max() == 0.0
    assert float(vir_dbg) == 0.0


@pytest.mark.parametrize("case", ["multitype", "s_exp", "excl"])
def test_each_general_case_alone(case):
    """One general feature at a time, against the JAX dense oracle: the
    plain version takes each of them on its own path."""
    bst, cfg = _bucket_case(True, False)
    jp = {"multitype": _params(s_exp=1.0, excl=False),
          "s_exp": JDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                                    seed=77, s_exp=0.25),
          "excl": _params(s_exp=1.0).replace(
              a=jnp.full((2, 2), 25.0), rc=jnp.ones((2, 2)))}[case]
    m, idx = _valid(bst)
    f_d, vir_d, _ = j_dense(bst.x[idx], bst.v[idx], bst.typ[idx],
                            bst.tag[idx], bst.mask[idx], bst.box,
                            jnp.int32(STEP), jp, 0.01, rng_mode="fast")
    tst = bridge.state_from(bst)
    f_t, vir_t = bucket_forces_pallas_v3(
        tst.x, tst.v, tst.typ, tst.tag, tst.mask, tst.box, STEP,
        bridge.dpd_params_from(jp), 0.01, bridge.cell_config_from(cfg),
        rng_mode="fast", s_exp=float(jp.s_exp))
    f_d = np.asarray(f_d)
    assert np.abs(f_t.numpy()[idx] - f_d).max() / np.abs(f_d).max() < 5e-5
    assert abs(float(vir_t) - float(vir_d)) / abs(float(vir_d)) < 1e-3


def test_s_exp_mismatch_raises():
    bst, cfg = _bucket_case(True, False)
    tst = bridge.state_from(bst)
    with pytest.raises(ValueError, match="s_exp"):
        bucket_forces_pallas_v3(
            tst.x, tst.v, tst.typ, tst.tag, tst.mask, tst.box, STEP,
            bridge.dpd_params_from(_params()), 0.01,
            bridge.cell_config_from(cfg), s_exp=1.0)


def test_plain_version_needs_typ_with_two_types():
    bst, cfg = _bucket_case(True, False)
    tst = bridge.state_from(bst)
    with pytest.raises(ValueError, match="typ"):
        bucket_forces_v3_plain(tst.x, tst.v, tst.tag, tst.mask, tst.box,
                               STEP, bridge.dpd_params_from(_params()), 0.01,
                               bridge.cell_config_from(cfg))


@pytest.mark.parametrize("rng_mode", ["fast", "tea"])
def test_dense_forces_with_exclusions_matches_jax(rng_mode):
    bst, _ = _bucket_case(False, True)
    jp = _params()
    _, idx = _valid(bst)
    sub = {k: np.asarray(getattr(bst, k))[idx]
           for k in ("x", "v", "typ", "tag", "mask")}
    f_d, vir_d, nn_d = j_dense(*(jnp.asarray(sub[k]) for k in
                                 ("x", "v", "typ", "tag", "mask")),
                               bst.box, jnp.int32(STEP), jp, 0.01,
                               rng_mode=rng_mode)
    t = {k: torch.from_numpy(a) for k, a in sub.items()}
    f_t, vir_t, nn_t = dense_forces(t["x"], t["v"], t["typ"], t["tag"],
                                    t["mask"], bridge.box_from(bst.box),
                                    STEP, bridge.dpd_params_from(jp), 0.01,
                                    rng_mode=rng_mode)
    f_d = np.asarray(f_d)
    assert np.abs(f_t.numpy() - f_d).max() / np.abs(f_d).max() < 2e-6
    assert abs(float(vir_t) - float(vir_d)) / abs(float(vir_d)) < 1e-5
    np.testing.assert_array_equal(nn_t.numpy(), np.asarray(nn_d))


def test_special_weight_matches_jax():
    jp = _params()
    rs = np.random.RandomState(1)
    ti = rs.randint(1, N + 1, 4000).astype(np.int32)
    # half the partners are bonded ones, half random
    tj = np.where(rs.rand(4000) < 0.5,
                  np.asarray(jp.excl)[ti, rs.randint(0, 2, 4000)],
                  rs.randint(1, N + 1, 4000)).astype(np.int32)
    want = np.asarray(j_special_weight(jnp.asarray(ti), jnp.asarray(tj), jp))
    got = special_weight(torch.from_numpy(ti), torch.from_numpy(tj),
                         bridge.dpd_params_from(jp)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0.25).sum() > 1000


def test_build_exclusions_bitwise():
    bonds = _chains(N)
    ex_j, w_j = j_build_exclusions(bonds, N, weight=0.25, max_excl=2)
    ex_t, w_t = build_exclusions(bonds, N, weight=0.25, max_excl=2)
    np.testing.assert_array_equal(ex_t.numpy(), np.asarray(ex_j))
    assert ex_t.dtype == torch.int32 and ex_t.shape == (N + 1, 2)
    assert float(w_t) == float(w_j) == 0.25
    # padding bonds are skipped, an overfull tag raises, as in JAX
    pad = np.concatenate([bonds, np.zeros((3, 2), np.int32)])
    np.testing.assert_array_equal(build_exclusions(pad, N, max_excl=2)[0],
                                  ex_t.numpy())
    with pytest.raises(ValueError, match="more than 1 exclusions"):
        build_exclusions(bonds, N, max_excl=1)


def test_bridge_carries_exclusions():
    jp = _params()
    tp = bridge.dpd_params_from(jp)
    assert tp.excl.dtype == torch.int32 and tp.excl_w.shape == ()
    back = bridge.dpd_params_to_numpy(tp)
    for name in ("a", "rc", "excl", "excl_w", "s_exp"):
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(jp, name)))
