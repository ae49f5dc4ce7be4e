"""The port's eDPD and tDPD bucket forces (K2, K3) against the JAX
package's dense O(N^2) oracles, on the same bucket state.

``bucket_forces_pallas_v3_edpd``/``_tdpd`` run their plain torch versions
here (CPU tensors); the CUDA kernels are held against those plain versions
on the card by chip_smoke.py. The oracle, the inputs and the bounds are the
JAX kernel tests' own (tests/unit/test_pallas_v3_transport.py:49-125):
T = 1 + 0.3 sin x, kappa 1.5, cv 10; two tDPD species, kappa_c [1, 0.5],
eps_c [0.1, 0.05], rcc 0.8, s1 2. Max relative error of f 2e-5 (5e-5
without min-image), of dT/dt and dC/dt 5e-5, of the virial 1e-4 (1e-3
without min-image), pad rows exactly 0, and per-species sum of dC/dt over
max |dC/dt| below 5e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.neighbor.bucket_layout import to_bucket_state as j_to_bucket
from meso_tpu.neighbor.cells import CellConfig as JCellConfig
from meso_tpu.ops.edpd import EDPDParams as JEDPDParams
from meso_tpu.ops.edpd import dense_forces_edpd as j_dense_edpd
from meso_tpu.ops.tdpd import TDPDParams as JTDPDParams
from meso_tpu.ops.tdpd import dense_forces_tdpd as j_dense_tdpd
from meso_tpu_torch import bridge
from meso_tpu_torch.kernels.pair_dpd_v3 import (bucket_forces_pallas_v3_edpd,
                                                bucket_forces_pallas_v3_tdpd)
from meso_tpu_torch.ops.edpd import EDPDParams, dense_forces_edpd
from meso_tpu_torch.ops.tdpd import TDPDParams, dense_forces_tdpd
from test_torch_imports import one_torch_thread  # noqa: F401

J_EDPD = JEDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kappa=1.5, cv=10.0,
                           seed=7)
J_TDPD = JTDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                           kappa_c=[1.0, 0.5], eps_c=[0.1, 0.05], rcc=0.8,
                           s1=2.0, seed=5)
STEP = {"edpd": 12, "tdpd": 4}
MODELS = {"edpd": (J_EDPD, j_dense_edpd, "T", bucket_forces_pallas_v3_edpd,
                   bridge.edpd_params_from),
          "tdpd": (J_TDPD, j_dense_tdpd, "C", bucket_forces_pallas_v3_tdpd,
                   bridge.tdpd_params_from)}


@functools.lru_cache(maxsize=None)
def _bucket_case(spill, min_image, skin=0.3):
    """A JAX bucket state with T and two C species whose rows moved since
    the rebuild: unwrapped (out of the box by <= skin/2) for the
    no-min-image layout, box-wrapped otherwise (the drift of
    test_torch_pair_dpd.py)."""
    n, l = (1536, 8.0) if spill else (500, 5.0)
    box = JBox.cubic(l)
    st = j_create_random(jax.random.PRNGKey(9), n, box, kt=1.0, n_species=2,
                         with_energy=True)
    st = st.replace(T=1.0 + 0.3 * jnp.sin(st.x[:, 0]),
                    C=jnp.stack([1.0 + 0.5 * jnp.cos(st.x[:, 0]),
                                 0.5 + 0.2 * jnp.sin(st.x[:, 1])], -1))
    cfg = JCellConfig.for_box([l] * 3, rc=1.0, density=n / l ** 3, skin=skin,
                              spill=spill, wrap_at_rebuild=not min_image)
    bst = j_to_bucket(st, cfg)
    x = bst.x + jnp.clip(0.04 * bst.v, -skin / 2, skin / 2) * bst.mask[:, None]
    if min_image:
        x = box.wrap(x)[0]
    return bst.replace(x=x), cfg


def _jax_dense_on_valid(model, bst, rng_mode):
    """JAX dense oracle over the valid rows, scattered back to bucket rows."""
    jparams, fn, field, _, _ = MODELS[model]
    m = np.asarray(bst.mask)
    idx = np.flatnonzero(m)
    fld = getattr(bst, field)
    f_d, q_d, vir_d = fn(bst.x[idx], bst.v[idx], fld[idx], bst.typ[idx],
                         bst.tag[idx], bst.mask[idx], bst.box,
                         jnp.int32(STEP[model]), jparams, 0.01,
                         rng_mode=rng_mode)
    f = np.zeros((m.size, 3), np.float32)
    f[idx] = np.asarray(f_d)
    q = np.zeros((m.size,) + fld.shape[1:], np.float32)
    q[idx] = np.asarray(q_d)
    return f, q, float(vir_d), m


def _port_forces(model, bst, cfg, rng_mode, params=None):
    jparams, _, field, fn, params_from = MODELS[model]
    tst = bridge.state_from(bst)
    return fn(tst.x, tst.v, getattr(tst, field), tst.typ, tst.tag, tst.mask,
              tst.box, STEP[model],
              params_from(jparams) if params is None else params, 0.01,
              bridge.cell_config_from(cfg), rng_mode=rng_mode)


@pytest.mark.parametrize("min_image", [True, False])
@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("rng_mode", ["fast", "tea"])
@pytest.mark.parametrize("model", ["edpd", "tdpd"])
def test_transport_plain_matches_jax_dense(model, rng_mode, spill,
                                           min_image):
    bst, cfg = _bucket_case(spill, min_image)
    f_t, q_t, vir_t = _port_forces(model, bst, cfg, rng_mode)
    f_d, q_d, vir_d, m = _jax_dense_on_valid(model, bst, rng_mode)
    fp, qp = f_t.numpy(), q_t.numpy()
    assert np.isfinite(fp).all() and np.isfinite(qp).all()
    rel = np.abs(fp[m] - f_d[m]).max() / np.abs(f_d).max()
    assert rel < (2e-5 if min_image else 5e-5), rel
    q_scale = np.abs(q_d).max()
    assert np.abs(qp[m] - q_d[m]).max() / q_scale < 5e-5
    assert (~m).any() and np.abs(fp[~m]).max() == 0.0
    assert np.abs(qp[~m]).max() == 0.0
    assert abs(float(vir_t) - vir_d) / abs(vir_d) < (1e-4 if min_image
                                                    else 1e-3)
    if model == "tdpd":
        # antisymmetric fluxes: each species' total is conserved
        assert np.abs(qp[m].sum(0)).max() / q_scale < 5e-5


@pytest.mark.parametrize("rng_mode", ["fast", "tea"])
@pytest.mark.parametrize("model", ["edpd", "tdpd"])
def test_dense_oracles_match_jax(model, rng_mode):
    """The port's own dense oracles against JAX's, on the valid rows of
    the strict min-image case."""
    jparams, j_fn, field, _, params_from = MODELS[model]
    t_fn = dense_forces_edpd if model == "edpd" else dense_forces_tdpd
    bst, _ = _bucket_case(False, True)
    idx = np.flatnonzero(np.asarray(bst.mask))
    names = ("x", "v", field, "typ", "tag", "mask")
    sub = {k: np.asarray(getattr(bst, k))[idx] for k in names}
    f_d, q_d, vir_d = j_fn(*(jnp.asarray(sub[k]) for k in names), bst.box,
                           jnp.int32(STEP[model]), jparams, 0.01,
                           rng_mode=rng_mode)
    t = {k: torch.from_numpy(a) for k, a in sub.items()}
    f_t, q_t, vir_t = t_fn(*(t[k] for k in names), bridge.box_from(bst.box),
                           STEP[model], params_from(jparams), 0.01,
                           rng_mode=rng_mode)
    f_d, q_d = np.asarray(f_d), np.asarray(q_d)
    assert np.abs(f_t.numpy() - f_d).max() / np.abs(f_d).max() < 2e-6
    assert np.abs(q_t.numpy() - q_d).max() / np.abs(q_d).max() < 2e-6
    assert abs(float(vir_t) - float(vir_d)) / abs(float(vir_d)) < 1e-5


def test_params_build_and_bridge_match_jax():
    e = EDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kappa=1.5, cv=10.0,
                         seed=2 ** 32 - 3, mass=1.3)
    je = JEDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kappa=1.5, cv=10.0,
                           seed=2 ** 32 - 3, mass=1.3)
    for name, want in bridge.edpd_params_to_numpy(e).items():
        np.testing.assert_array_equal(want, np.asarray(getattr(je, name)),
                                      err_msg=name)
    t = TDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.3, kappa_c=[1.0, 0.5],
                         eps_c=[0.1, 0.05], rcc=0.8, s1=2.0, seed=5)
    for name, want in bridge.tdpd_params_to_numpy(t).items():
        np.testing.assert_array_equal(want, np.asarray(getattr(J_TDPD, name))
                                      if name != "sigma" else
                                      np.asarray(JTDPDParams.build(
                                          a=25.0, gamma=4.5, rc=1.0, kt=1.3,
                                          kappa_c=[1.0, 0.5],
                                          eps_c=[0.1, 0.05], rcc=0.8, s1=2.0,
                                          seed=5).sigma), err_msg=name)
    assert t.n_species == 2
    # system_params_from tells the pair models apart by their fields
    from meso_tpu.core.system import SystemParams as JSystemParams
    for jpair, cls in ((J_EDPD, EDPDParams), (J_TDPD, TDPDParams)):
        got = bridge.system_params_from(JSystemParams.build_raw(jpair))
        assert type(got.pair) is cls


def test_rcc_above_rc_raises():
    bst, cfg = _bucket_case(True, True)
    params = bridge.tdpd_params_from(J_TDPD).replace(rcc=1.2)
    with pytest.raises(ValueError, match="rcc <= rc"):
        _port_forces("tdpd", bst, cfg, "fast", params)


@pytest.mark.parametrize("case", ["tdpd-s_exp"])
def test_unported_transport_cases_raise(case):
    """K3 refuses s_exp != 1 (ROADMAP Queue 3, R8): every JAX tDPD kernel
    takes s_exp = 1 whatever the parameters say, its dense oracle applies
    them. Multi-type tables and more than eight species are ported
    (tests/test_torch_transport_multitype.py)."""
    bst, cfg = _bucket_case(True, True)
    params = bridge.tdpd_params_from(J_TDPD).replace(s_exp=0.5)
    with pytest.raises(ValueError, match="R8"):
        _port_forces("tdpd", bst, cfg, "fast", params)
