"""The eDPD and tDPD forms of the port's K4
(``halo_forces_pallas_model_fused``) against the JAX package's kernel run
in interpret mode outside ``shard_map`` (``vma=()``), on the same
halo-extended planes as tests/test_torch_dd_halo_kernels.py (whose
``halo_case`` cuts them), with a T plane or species planes beside them.
Cases: eDPD on spill buckets with ext=("x", "y", "z") and two types with
an asymmetric kappa table (fast RNG); tDPD with two species, rcc 0.8 and
s1 2, on strict buckets with ext=("x",) (TEA) and on spill buckets with
ext=("x", "y"), the 2-D bricks' extension (fast RNG). Also the refusals
of the tDPD halo route: s_exp != 1 (R8) and rcc above the smallest rc_ij
(R9).

Bounds: max force error 2e-5 of max |f| (the v3 kernel gate), max flux
error 5e-5 of max |flux| (the port's transport kernel tests), relative
virial error 1e-4, pad rows exactly 0. Per-species sums of dC/dt are not
held: the fluxes to halo rows belong to the neighbouring ranks.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.kernels.pair_dpd_fused import \
    halo_forces_pallas_model_fused as j_halo_model
from meso_tpu.ops.edpd import EDPDParams as JEDPDParams
from meso_tpu.ops.tdpd import TDPDParams as JTDPDParams
from meso_tpu_torch import bridge
from meso_tpu_torch.kernels.pair_dpd_fused import \
    halo_forces_pallas_model_fused
from test_torch_dd_halo_kernels import STEP, halo_case, with_jax_hash
from test_torch_imports import one_torch_thread  # noqa: F401


def model_params(model):
    if model == "edpd":
        return JEDPDParams.build(
            a=jnp.asarray([[25.0, 35.0], [30.0, 40.0]]), gamma=4.5,
            rc=jnp.asarray([[1.0, 0.8], [0.8, 1.0]]),
            kappa=jnp.asarray([[1.5, 1.0], [1.2, 0.5]]), cv=10.0, seed=7,
            n_types=2)
    return JTDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                             kappa_c=[1.0, 0.5], eps_c=[0.1, 0.05], rcc=0.8,
                             s1=2.0, seed=5)


def box_of(lens):
    return bridge.box_from({"lo": np.zeros(3), "hi": lens})


@pytest.mark.parametrize("model,spill,ext,rng_mode", [
    ("edpd", True, ("x", "y", "z"), "fast"), ("tdpd", False, ("x",), "tea"),
    ("tdpd", True, ("x", "y"), "fast")],
    ids=["edpd-spill-xyz-fast-2types", "tdpd-strict-x-tea-2species",
         "tdpd-spill-xy-fast-2species"])
def test_k4_model_plain_matches_jax_interpret(model, spill, ext, rng_mode):
    n_types = 2 if model == "edpd" else 1
    ns = 2 if model == "tdpd" else 0
    planes, tcfg, jcfg, lens, valid = halo_case(
        spill, ext, 11, n_types, t=model == "edpd", ns=ns)
    jp = model_params(model)
    kw = dict(model=model, ns=ns, ext=ext, rng_mode=rng_mode,
              n_types=n_types)
    jpl, planes = with_jax_hash(planes, jp.seed, rng_mode)
    want = j_halo_model(jpl, JBox.orthorhombic(*lens),
                        jnp.int32(STEP), jp, 0.01, jcfg, interpret=True,
                        vma=(), **kw)
    got = halo_forces_pallas_model_fused(
        planes, box_of(lens), STEP, bridge.pair_params_from(jp), 0.01, tcfg,
        **kw)
    fp, qp, fj, qj = (np.asarray(a) for a in (*got[:2], *want[:2]))
    assert fp.shape == fj.shape == (valid.size, 3)
    assert qp.shape == qj.shape
    assert np.isfinite(fp).all() and np.isfinite(qp).all()
    assert np.abs(fp[valid] - fj[valid]).max() / np.abs(fj).max() < 2e-5
    assert np.abs(qp[valid] - qj[valid]).max() / np.abs(qj).max() < 5e-5
    assert (~valid).any() and np.abs(fp[~valid]).max() == 0.0
    assert np.abs(qp[~valid]).max() == 0.0
    assert abs(float(got[2]) - float(want[2])) / abs(float(want[2])) < 1e-4


@pytest.mark.parametrize("change,match", [
    (dict(s_exp=0.5), "R8"),
    (dict(rc=[[1.0, 0.7], [0.7, 1.0]], n_types=2), "R9")], ids=["R8", "R9"])
def test_tdpd_halo_route_refuses_r8_r9(change, match):
    planes, tcfg, _, lens, _ = halo_case(False, ("x",), 11, 2, ns=1)
    kw = dict(a=25.0, gamma=4.5, rc=1.0, kt=1.0, kappa_c=[1.0],
              eps_c=[0.1], rcc=0.8, seed=5)
    s_exp = change.pop("s_exp", None)
    jp = JTDPDParams.build(**{**kw, **change})
    if s_exp is not None:
        jp = jp.replace(s_exp=jnp.asarray(s_exp, jnp.float32))
    with pytest.raises(ValueError, match=match):
        halo_forces_pallas_model_fused(
            planes, box_of(lens), STEP, bridge.pair_params_from(jp), 0.01,
            tcfg, model="tdpd", ns=1, n_types=jp.a.shape[0])
