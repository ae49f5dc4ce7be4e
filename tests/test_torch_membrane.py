"""The bonded path in the port against the JAX package, membranes: on
``membrane_suspension(l=10, radius=2.5, subdiv=1)``, the WLC-POW edge,
global and local area, volume and hinge-bending forces from
``torch.autograd`` against ``jax.grad`` of the same energy, the
domain-decomposition arguments, and the builder's positions, triangles and
hinges bitwise. (The JAX builder alone takes about 12 s on a CPU, so these
sit in their own file.)

Tolerance: the autograd forces agree to 2e-5 of their scale, since both
packages sum the per-term gradients into rows in their own order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.models import polymer as jpoly
from meso_tpu_torch.core.system import run_bucket
from meso_tpu_torch.models import polymer as tpoly
from test_torch_bonded import (_assert_same_bonded, _assert_same_start,
                               _bonded_pair, _close)
from test_torch_imports import one_torch_thread  # noqa: F401

MEMBRANE = dict(l=10.0, radius=2.5, subdiv=1)


@pytest.fixture(scope="module")
def jax_membrane():
    return jpoly.membrane_suspension(force_path="dense", **MEMBRANE)


@pytest.mark.parametrize("context", ["plain", "inference_mode", "no_grad"])
def test_membrane_autograd_matches_jax_grad(context, jax_membrane):
    """WLC-POW edges, global and local area, volume and hinge bending on the
    vesicle, with image flags set so the volume unwraps x + image L; the
    caller's inference_mode or no_grad does not stop the gradient."""
    jsys, jparams, jst, _ = jax_membrane
    rs = np.random.RandomState(2)
    x = np.asarray(jst.x) + rs.normal(0, 0.05, jst.x.shape).astype(
        np.float32)
    image = rs.randint(-1, 2, jst.x.shape).astype(np.int32)
    jst = jst.replace(x=jnp.asarray(x), image=jnp.asarray(image))
    ctx = {"plain": torch.enable_grad, "inference_mode": torch.inference_mode,
           "no_grad": torch.no_grad}[context]
    with ctx():
        (fj, mj), (ft, mt) = _bonded_pair(jsys, jparams, jst,
                                          image=jst.image)
    _close(ft, fj, 2e-5)
    assert int(mt) == int(mj) == 0 and not ft.requires_grad
    # the membrane terms are not all zero at the perturbed shape
    assert float(ft.abs().max()) > 1.0


def test_owner_mask_and_missing_match_jax(jax_membrane):
    """The domain-decomposition arguments: forces only on owned rows, and
    terms whose partner is absent counted as missing."""
    jsys, jparams, jst, _ = jax_membrane
    mask = np.asarray(jst.mask).copy()
    mask[5] = False                     # vertex tag 6 is not resolvable
    owner = np.zeros(jst.n, bool)
    owner[: jst.n // 2] = True
    jst = jst.replace(mask=jnp.asarray(mask))
    (fj, mj), (ft, mt) = _bonded_pair(jsys, jparams, jst,
                                      owner_mask=owner)
    _close(ft, fj, 2e-5)
    assert int(mt) == int(mj) > 0
    assert float(ft[torch.from_numpy(~owner)].abs().max()) == 0.0


def test_membrane_builder_bitwise(jax_membrane):
    jsys, jparams, jst, jmesh = jax_membrane
    tsys, tparams, tst, tmesh = tpoly.membrane_suspension(
        force_path="dense", device="cpu", **MEMBRANE)
    _assert_same_start(tst, jst)
    _assert_same_bonded(tparams, jparams)
    assert (tsys.bond_style, tsys.n_tags, tsys.n_mols) == \
        (jsys.bond_style, jsys.n_tags, jsys.n_mols)
    for key in ("area0", "vol0", "n_mem", "l_max"):
        assert tmesh[key] == jmesh[key]
    np.testing.assert_array_equal(tmesh["faces"], jmesh["faces"])


def test_membrane_runs_under_inference_mode():
    """The port's own vesicle through the kernels' plain versions and
    run_bucket, inside torch.inference_mode, as chip_smoke drives it."""
    system, params, state, mesh = tpoly.membrane_suspension(
        force_path="pallas", device="cpu", **MEMBRANE)
    with torch.inference_mode():
        state, diag = run_bucket(system, params, state, 5)
    assert int(diag["bucket_overflow"]) == 0
    assert bool(torch.isfinite(state.x).all() & torch.isfinite(state.f).all())
    assert not state.x.requires_grad
