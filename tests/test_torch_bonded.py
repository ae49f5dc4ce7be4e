"""The bonded path in the port against the JAX package, polymers: the
closed-form bond forces, the tag maps, angle forces from ``torch.autograd``
against ``jax.grad`` of the same energy, the builders' positions and
topology bitwise, and a few steps of ``polymer_melt(special_weight=0.5)``
in both packages. The membrane's terms are in test_torch_membrane.py.

Tolerances: the closed forms agree to 1e-6 of their scale (float32
rounding); the autograd forces to 2e-5 of their scale, since both packages
sum the per-term gradients into rows in their own order. The step runs are
held to PR 1's chunk-test bounds (tests/test_torch_slice.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.system import run_chunk as j_run_chunk
from meso_tpu.models import polymer as jpoly
from meso_tpu.ops import bonded as jb
from meso_tpu_torch import bridge
from meso_tpu_torch.core.system import make_step
from meso_tpu_torch.models import polymer as tpoly
from meso_tpu_torch.neighbor.bucket_layout import to_bucket_state
from meso_tpu_torch.ops import bonded as tb
from test_torch_imports import one_torch_thread  # noqa: F401

MELT = dict(l=6.0, n_chains=3, chain_len=10, special_weight=0.5)


@pytest.fixture(scope="module")
def jax_melt():
    return jpoly.polymer_melt(force_path="dense", **MELT)


@pytest.mark.parametrize("style", ["fene", "harmonic", "wlc_pow"])
def test_closed_form_bond_forces_match_jax(style):
    rs = np.random.RandomState(4)
    dr = rs.uniform(-0.9, 0.9, (2000, 3)).astype(np.float32)
    c = {"fene": (30.0, 1.5), "harmonic": (10.0, 0.8),
         "wlc_pow": (50.0, 1.2, 0.2, 2.0)}[style]
    fn_j = {"fene": jb.fene_force, "harmonic": jb.harmonic_force,
            "wlc_pow": jb.wlc_pow_force}[style]
    fn_t = {"fene": tb.fene_force, "harmonic": tb.harmonic_force,
            "wlc_pow": tb.wlc_pow_force}[style]
    want = np.asarray(fn_j(jnp.asarray(dr), *c))
    got = fn_t(torch.from_numpy(dr), *c).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_tag_maps_match_jax(jax_melt):
    st = jax_melt[2]
    mask = np.asarray(st.mask).copy()
    mask[::7] = False
    n_tags = st.n
    tag, m = jnp.asarray(st.tag), jnp.asarray(mask)
    t_tag, t_m = torch.from_numpy(np.array(st.tag)), torch.from_numpy(mask)
    inv_j = np.asarray(jb.inverse_tag_map(tag, m, n_tags))
    inv_t = tb.inverse_tag_map(t_tag, t_m, n_tags).numpy()
    # inv[0] is junk in both; every present tag maps to its row
    np.testing.assert_array_equal(inv_t[1:][mask[inv_j[1:]]],
                                  inv_j[1:][mask[inv_j[1:]]])
    np.testing.assert_array_equal(tb.presence_map(t_tag, t_m, n_tags).numpy(),
                                  np.asarray(jb.presence_map(tag, m, n_tags)))


def _bonded_pair(jsys, jparams, jst, **kw):
    """(JAX (f, missing), port (f, missing)) of bonded_forces_ext."""
    tparams = bridge.bonded_params_from(jparams.bonded)
    tst = bridge.state_from(jst)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(np.array(v)) for k, v in kw.items()}
    want = jb.bonded_forces_ext(jst.x, jst.tag, jst.mask, jst.box,
                                jparams.bonded, jsys.bond_style, jsys.n_tags,
                                jsys.n_mols, **jkw)
    got = tb.bonded_forces_ext(tst.x, tst.tag, tst.mask, tst.box, tparams,
                               jsys.bond_style, jsys.n_tags, jsys.n_mols,
                               **tkw)
    return want, got


def _close(got, want, tol):
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


def test_fene_bonded_forces_match_jax(jax_melt):
    (fj, mj), (ft, mt) = _bonded_pair(*jax_melt)
    _close(ft, fj, 1e-6)
    assert int(mt) == int(mj) == 0
    # Newton's third law over the bonds
    assert float(ft.sum(0).abs().max()) < 1e-4


def test_angle_energy_forces_match_jax(jax_melt):
    """Harmonic angles (no builder uses them) along the melt's chains."""
    jsys, jparams, jst = jax_melt
    bt = np.asarray(jparams.bonded.bond_tags)
    ang = np.stack([bt[:-1, 0], bt[:-1, 1], bt[1:, 1]], 1)
    ang = ang[bt[:-1, 1] == bt[1:, 0]].astype(np.int32)
    jparams = jparams.replace(bonded=jparams.bonded.replace(
        angle_tags=jnp.asarray(ang),
        angle_type=jnp.zeros(len(ang), jnp.int32),
        angle_coeffs=jnp.asarray([[5.0, 2.0]], jnp.float32)))
    (fj, _), (ft, _) = _bonded_pair(jsys, jparams, jst)
    _close(ft, fj, 2e-5)


def test_icosphere_and_hinges_bitwise():
    for subdiv in (0, 1, 2):
        vj, fj = jpoly.icosphere(subdiv)
        vt, ft = tpoly.icosphere(subdiv)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(tpoly.build_hinges(ft),
                                      jpoly.build_hinges(fj))


def _assert_same_start(tst, jst):
    for name in ("x", "tag", "mol", "typ", "mask"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)


def _assert_same_bonded(tparams, jparams):
    for name in ("bond_tags", "bond_type", "bond_coeffs", "tri_tags",
                 "tri_mol", "membrane", "tri_a0", "hinge_tags",
                 "hinge_coeffs"):
        want = getattr(jparams.bonded, name)
        got = getattr(tparams.bonded, name)
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)


def test_polymer_melt_builder_bitwise(jax_melt):
    jsys, jparams, jst = jax_melt
    tsys, tparams, tst = tpoly.polymer_melt(force_path="dense", device="cpu",
                                            **MELT)
    _assert_same_start(tst, jst)
    _assert_same_bonded(tparams, jparams)
    np.testing.assert_array_equal(tparams.pair.excl.numpy(),
                                  np.asarray(jparams.pair.excl))
    assert float(tparams.pair.excl_w) == float(jparams.pair.excl_w) == 0.5
    assert (tsys.bond_style, tsys.n_tags) == (jsys.bond_style, jsys.n_tags)


@pytest.mark.parametrize("path", ["dense", "pallas"])
def test_polymer_melt_steps_match_jax(path, jax_melt):
    """5 steps of the JAX melt (special_weight 0.5) in both packages: JAX
    on its dense path, the port on its dense path or through the plain K1
    general kernel (exclusions) on bucket rows, compared by tag."""
    jsys, jparams, jst = jax_melt
    j_end = j_run_chunk(jsys, jparams, jst, 5)
    tsys = bridge.system_from(jsys)
    tparams = bridge.system_params_from(jparams)
    tst = bridge.state_from(jst)
    assert tsys.bond_style == "fene" and tparams.pair.excl is not None
    if path == "pallas":
        tsys = tsys.replace(force_path="pallas")
        tst = to_bucket_state(tst, tsys.cells)
    step = make_step(tsys)
    for _ in range(5):
        tst = step(tparams, tst)
    m = tst.mask.numpy()
    order = np.argsort(tst.tag.numpy()[m])
    jorder = np.argsort(np.asarray(j_end.tag))
    got = {k: getattr(tst, k).numpy()[m][order] for k in ("x", "v", "f")}
    want = {k: np.asarray(getattr(j_end, k))[jorder] for k in ("x", "v", "f")}
    assert np.abs(got["f"] - want["f"]).max() / np.abs(want["f"]).max() < 1e-4
    assert np.abs(got["v"] - want["v"]).max() < 1e-4
    assert np.abs(got["x"] - want["x"]).max() < 1e-5
