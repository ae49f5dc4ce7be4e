"""The port's 27-offset bucket sweep (force_path "bucket") against the
JAX package's on the same bucket state: classic DPD
(``ops.bucket_dpd.bucket_forces_xla``) here, eDPD and tDPD in
tests/test_torch_sweep_transport.py. The gate is the v3 gate of
tests/unit/test_pallas_v3.py:40-59: max relative force error 2e-5,
relative virial error 1e-4, pad rows exactly 0; fluxes 2e-5 relative to
the largest, as tests/unit/test_transport_paths.py holds them. Cases as
tests/unit/test_bucket.py:59-207: one type and two, s_exp 0.5, exclusions,
fast and TEA. Every model refuses spill buckets, and tDPD rcc > rc."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.neighbor.bucket_layout import to_bucket_state as j_to_bucket
from meso_tpu.neighbor.cells import CellConfig as JCellConfig
from meso_tpu.ops import bucket_dpd as jbucket
from meso_tpu.ops import dpd as jdpd
from meso_tpu.ops import edpd as jedpd
from meso_tpu.ops import tdpd as jtdpd
from meso_tpu_torch import bridge
from meso_tpu_torch.ops import bucket_dpd as tbucket
from meso_tpu_torch.ops import edpd as tedpd
from meso_tpu_torch.ops import tdpd as ttdpd
from test_torch_imports import one_torch_thread  # noqa: F401

L, N, STEP, DT = 6.0, 630, 12, 0.01
# the JAX sweep runs eagerly: it compiles each operation once for the
# file (about 5 s), where jit compiles every case's whole 27-offset graph
# (6-7 s each)
J_FN = {"dpd": jbucket.bucket_forces_xla, "edpd": jedpd.bucket_forces_edpd,
        "tdpd": jtdpd.bucket_forces_tdpd}
T_FN = {"dpd": tbucket.bucket_forces_xla, "edpd": tedpd.bucket_forces_edpd,
        "tdpd": ttdpd.bucket_forces_tdpd}
TWO = dict(a=[[25.0, 35.0], [35.0, 40.0]], rc=[[1.0, 0.8], [0.8, 1.0]],
           n_types=2)


def _params(model, two_types, ns=1, s_exp=1.0, excl=False, rcc=0.8):
    kw = dict(TWO) if two_types else dict(a=25.0, rc=1.0)
    if model == "dpd":
        p = jdpd.DPDParams.build(gamma=4.5, kt=1.0, seed=77, s_exp=s_exp,
                                 **kw)
        if excl:
            bonds = np.stack([np.arange(1, N), np.arange(2, N + 1)], 1)
            ex, w = jdpd.build_exclusions(bonds, N, weight=0.25)
            p = p.replace(excl=ex, excl_w=w)
        return p
    if model == "edpd":
        return jedpd.EDPDParams.build(gamma=4.5, kappa=1.5, cv=10.0, seed=7,
                                      **kw)
    p = jtdpd.TDPDParams.build(gamma=4.5, kt=1.0,
                               kappa_c=[1.0, 2.0, 0.5][:ns],
                               eps_c=[0.1, 0.0, 0.3][:ns], rcc=rcc, seed=5,
                               s1=2.0 if ns > 1 else 1.0, **kw)
    return p.replace(s_exp=jnp.float32(s_exp))


def _bucket_state(model, two_types, ns=1):
    """A JAX random state with 30 padding rows in strict bucket rows, with
    T or C fields, and its CellConfig."""
    box = JBox.cubic(L)
    st = j_create_random(jax.random.PRNGKey(11), N, box,
                         n_species=ns if model == "tdpd" else 0,
                         with_energy=model == "edpd")
    x = np.asarray(st.x)
    mask = np.arange(N) < N - 30
    typ = (np.arange(N) % 3 == 0).astype(np.int32) if two_types \
        else np.zeros(N, np.int32)
    st = st.replace(mask=jnp.asarray(mask), typ=jnp.asarray(typ))
    if model == "edpd":
        st = st.replace(T=jnp.asarray(1.0 + 0.3 * np.sin(x[:, 0]),
                                      jnp.float32))
    if model == "tdpd":
        c = np.stack([1.0 + 0.5 * np.cos(x[:, 0] + s) for s in range(ns)],
                     -1)
        st = st.replace(C=jnp.asarray(c, jnp.float32))
    cfg = JCellConfig.for_box([L] * 3, 1.0, 3.0, skin=0.3)
    return j_to_bucket(st, cfg), cfg


def _field(model, st):
    return {"dpd": (), "edpd": (st.T,), "tdpd": (st.C,)}[model]


def _gate(got, want, mask, what):
    """(f, [flux,] virial) against (f, [flux,] virial)."""
    f, f_ref = np.asarray(got[0]), np.asarray(want[0])
    rel = np.abs(f[mask] - f_ref[mask]).max() / np.abs(f_ref[mask]).max()
    assert rel < 2e-5, (what, rel)
    assert np.abs(f[~mask]).max() == 0.0, what
    if len(got) == 3:
        q, q_ref = np.asarray(got[1]), np.asarray(want[1])
        qrel = np.abs(q[mask] - q_ref[mask]).max() / max(
            np.abs(q_ref[mask]).max(), 1e-9)
        assert qrel < 2e-5, (what, qrel)
        assert np.abs(q[~mask]).max() == 0.0, what
    vrel = abs(float(got[-1]) - float(want[-1])) / abs(float(want[-1]))
    assert vrel < 1e-4, (what, vrel)


def _run(model, jp, jst, cfg, rng_mode):
    st = bridge.state_from(jst, device="cpu")
    p = bridge.pair_params_from(jp, device="cpu")
    tcfg = bridge.cell_config_from(cfg)
    args = (st.x, st.v, *_field(model, st), st.typ, st.tag, st.mask, st.box,
            STEP, p, DT)
    return T_FN[model](*args, tcfg, rng_mode=rng_mode, rng_rounds=8), \
        (args, st)


CASES = {
    "dpd-one-type-fast": ("dpd", False, "fast", {}),
    "dpd-one-type-tea": ("dpd", False, "tea", {}),
    "dpd-two-types-sexp-excl-fast": ("dpd", True, "fast",
                                     dict(s_exp=0.5, excl=True)),
    "dpd-two-types-sexp-excl-tea": ("dpd", True, "tea",
                                    dict(s_exp=0.5, excl=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_matches_jax(case):
    model, two, rng_mode, kw = CASES[case]
    jst, cfg = _bucket_state(model, two, kw.get("ns", 1))
    jp = _params(model, two, **kw)
    want = J_FN[model](jst.x, jst.v, *_field(model, jst), jst.typ, jst.tag,
                       jst.mask, jst.box, jnp.int32(STEP), jp, DT, cfg,
                       rng_mode=rng_mode, rng_rounds=8)
    got, _ = _run(model, jp, jst, cfg, rng_mode)
    _gate(got, want, np.asarray(jst.mask), case)


@pytest.mark.parametrize("model", ["dpd", "edpd", "tdpd"])
def test_sweep_refuses_spill(model):
    jst, cfg = _bucket_state(model, False)
    cfg = JCellConfig(ncell=cfg.ncell, capacity=cfg.capacity, spill=True)
    with pytest.raises(ValueError, match="strict buckets"):
        _run(model, _params(model, False, rcc=1.0), jst, cfg, "fast")


def test_tdpd_sweep_refuses_rcc_above_rc():
    jst, cfg = _bucket_state("tdpd", False)
    with pytest.raises(ValueError, match="rcc <= rc"):
        _run("tdpd", _params("tdpd", False, rcc=1.2), jst, cfg, "fast")
