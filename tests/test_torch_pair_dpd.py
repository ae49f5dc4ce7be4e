"""The port's classic pair forces against the JAX package's dense O(N^2)
oracle, on the same bucket state.

``bucket_forces_pallas_v3`` runs its plain torch version here (CPU
tensors); the CUDA kernel is held against that plain version on the card by
chip_smoke.py. The oracle is the one the JAX v3 tests use
(tests/unit/test_pallas_v3.py:40-59, test_wrap_mode.py:56-71), evaluated
over the valid rows only, and the bounds are those tests' own: max relative
force error 2e-5 with min-image and 5e-5 without, pad rows exactly 0,
relative virial error 1e-4 (1e-3 without min-image)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.neighbor.bucket_layout import to_bucket_state as j_to_bucket
from meso_tpu.neighbor.cells import CellConfig as JCellConfig
from meso_tpu.ops.dpd import DPDParams as JDPDParams
from meso_tpu.ops.dpd import dense_forces as j_dense
from meso_tpu_torch import bridge
from meso_tpu_torch.kernels.pair_dpd_v3 import bucket_forces_pallas_v3
from meso_tpu_torch.ops.dpd import DPDParams, dense_forces
from test_torch_imports import one_torch_thread  # noqa: F401

J_PARAMS = JDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=77)
STEP = 42


def _bucket_case(spill, min_image, l=8.0, n=1536, skin=0.3, seed=3):
    """A JAX bucket state whose rows moved since the rebuild: unwrapped
    (out of the box by <= skin/2) for the no-min-image layout, box-wrapped
    (rows that crossed the boundary sit in their old cells) otherwise."""
    box = JBox.cubic(l)
    st = j_create_random(jax.random.PRNGKey(seed), n, box, kt=1.0)
    cfg = JCellConfig.for_box([l] * 3, rc=1.0, density=n / l ** 3, skin=skin,
                              spill=spill, wrap_at_rebuild=not min_image)
    bst = j_to_bucket(st, cfg)
    drift = jnp.clip(0.04 * bst.v, -skin / 2, skin / 2) * bst.mask[:, None]
    x = bst.x + drift
    if min_image:
        x = box.wrap(x)[0]
    return bst.replace(x=x), cfg


def _dense_on_valid(bst, rng_mode):
    """JAX dense oracle over the valid rows, scattered back to bucket rows."""
    m = np.asarray(bst.mask)
    idx = np.flatnonzero(m)
    f_d, vir_d, _ = j_dense(bst.x[idx], bst.v[idx], bst.typ[idx],
                            bst.tag[idx], bst.mask[idx], bst.box,
                            jnp.int32(STEP), J_PARAMS, 0.01,
                            rng_mode=rng_mode)
    f = np.zeros((m.size, 3), np.float32)
    f[idx] = np.asarray(f_d)
    return f, float(vir_d), m


def _port_forces(bst, cfg, rng_mode, need_virial=True):
    tst = bridge.state_from(bst)
    return bucket_forces_pallas_v3(
        tst.x, tst.v, tst.typ, tst.tag, tst.mask, tst.box, STEP,
        bridge.dpd_params_from(J_PARAMS), 0.01, bridge.cell_config_from(cfg),
        rng_mode=rng_mode, need_virial=need_virial)


@pytest.mark.parametrize("min_image", [True, False])
@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("rng_mode", ["fast", "tea"])
def test_v3_plain_matches_jax_dense(rng_mode, spill, min_image):
    bst, cfg = _bucket_case(spill, min_image)
    f_t, vir_t = _port_forces(bst, cfg, rng_mode)
    f_d, vir_d, m = _dense_on_valid(bst, rng_mode)
    fp = f_t.numpy()
    assert np.isfinite(fp).all()
    scale = np.abs(f_d).max()
    rel = np.abs(fp[m] - f_d[m]).max() / scale
    assert rel < (2e-5 if min_image else 5e-5), rel
    assert (~m).any() and np.abs(fp[~m]).max() == 0.0
    assert abs(float(vir_t) - vir_d) / abs(vir_d) < (1e-4 if min_image
                                                    else 1e-3)
    # every pair is computed from both rows: momentum is conserved
    assert np.abs(fp[m].sum(0)).max() / scale < 5e-5


def test_v3_need_virial_off_same_forces():
    bst, cfg = _bucket_case(True, False)
    f_on, vir_on = _port_forces(bst, cfg, "fast")
    f_off, vir_off = _port_forces(bst, cfg, "fast", need_virial=False)
    assert torch.equal(f_on, f_off)
    assert float(vir_off) == 0.0 and float(vir_on) != 0.0


@pytest.mark.parametrize("rng_mode", ["fast", "tea"])
def test_dense_forces_matches_jax(rng_mode):
    bst, _ = _bucket_case(False, True)
    m = np.asarray(bst.mask)
    idx = np.flatnonzero(m)
    sub = {name: np.asarray(getattr(bst, name))[idx]
           for name in ("x", "v", "typ", "tag", "mask")}
    f_d, vir_d, nn_d = j_dense(*(jnp.asarray(sub[k]) for k in
                                 ("x", "v", "typ", "tag", "mask")),
                               bst.box, jnp.int32(STEP), J_PARAMS, 0.01,
                               rng_mode=rng_mode)
    t = {k: torch.from_numpy(a) for k, a in sub.items()}
    f_t, vir_t, nn_t = dense_forces(t["x"], t["v"], t["typ"], t["tag"],
                                    t["mask"], bridge.box_from(bst.box), STEP,
                                    bridge.dpd_params_from(J_PARAMS), 0.01,
                                    rng_mode=rng_mode)
    f_d = np.asarray(f_d)
    assert np.abs(f_t.numpy() - f_d).max() / np.abs(f_d).max() < 2e-6
    assert abs(float(vir_t) - float(vir_d)) / abs(float(vir_d)) < 1e-5
    np.testing.assert_array_equal(nn_t.numpy(), np.asarray(nn_d))


def test_dpd_params_build_matches_jax():
    p = DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.3, seed=2 ** 32 - 5)
    j = JDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.3, seed=2 ** 32 - 5)
    for name in ("a", "gamma", "sigma", "rc"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert p.seed == int(np.asarray(j.seed)) == 2 ** 32 - 5


def test_bridge_round_trip():
    """JAX arrays -> port -> numpy gives back the same bits."""
    bst, cfg = _bucket_case(True, False)
    back = bridge.state_to_numpy(bridge.state_from(bst))
    for name in ("x", "v", "f", "typ", "tag", "image", "mask", "mol"):
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(bst, name)))
    np.testing.assert_array_equal(back["hi"], np.asarray(bst.box.hi))
    pd = bridge.dpd_params_to_numpy(bridge.dpd_params_from(J_PARAMS))
    for name in ("a", "gamma", "sigma", "rc", "kt", "seed", "s_exp"):
        np.testing.assert_array_equal(pd[name],
                                      np.asarray(getattr(J_PARAMS, name)))
    assert bridge.cell_config_from(cfg).ncell == cfg.ncell


@pytest.mark.parametrize("case", ["multitype", "s_exp", "debug_pairs",
                                  "excl"])
def test_unported_kernel_cases_raise(case, monkeypatch):
    """K1's former NotImplementedError cases now take the general kernel:
    off the CPU with no compiler they raise for want of nvcc, never fall
    back to the plain version, and launch nothing."""
    import torch.utils.cpp_extension

    from meso_tpu_torch.kernels import _build
    from meso_tpu_torch.kernels.pair_dpd_v3 import LAUNCHES
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("CUDA_PATH", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    _build.load_library.cache_clear()
    bst, cfg = _bucket_case(True, False)
    tst = bridge.state_from(bst, device="meta")
    params = bridge.dpd_params_from(J_PARAMS)
    kw = {}
    if case == "multitype":
        params = DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=7,
                                 n_types=2)
    elif case == "s_exp":
        params = params.replace(s_exp=0.5)
        kw["s_exp"] = 0.5
    elif case == "debug_pairs":
        kw["debug_pairs"] = True
    else:
        params = params.replace(excl=torch.zeros((2, 1), dtype=torch.int32),
                                excl_w=torch.tensor(0.5))
    before = dict(LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bucket_forces_pallas_v3(tst.x, tst.v, tst.typ, tst.tag, tst.mask,
                                tst.box, STEP, params.to("meta"), 0.01,
                                bridge.cell_config_from(cfg), **kw)
    assert LAUNCHES == before
