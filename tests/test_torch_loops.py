"""The port's loops (``core.system.run``, ``run_chunk``, ``run_adaptive``
and ``run_bucket_fixed``) against the JAX package's, each from the JAX
start carried across by the bridge, for 10-30 steps: positions within
1.5e-5 by tag (as the 1-D ring of one was held), the integer diagnostics
equal. And the builders with their default force_path ("nlist") set up
and step on the CPU."""

import numpy as np
import pytest
import torch

from meso_tpu.core import system as jsystem
from meso_tpu.models.classic import classic_fluid as j_classic_fluid
from meso_tpu_torch import bridge
from meso_tpu_torch.core import system as tsystem
from meso_tpu_torch.core.system import make_step
from meso_tpu_torch.models.classic import classic_fluid
from meso_tpu_torch.models.polymer import membrane_suspension, polymer_melt
from meso_tpu_torch.models.walls import couette, poiseuille
from test_torch_imports import one_torch_thread  # noqa: F401

POS_TOL = 1.5e-5


def _start(**kw):
    """A JAX classic_fluid at l=6 (648 particles) and its port copy."""
    jsys, jp, jst = j_classic_fluid(l=6.0, **kw)
    return (jsys, jp, jst), (bridge.system_from(jsys),
                             bridge.system_params_from(jp, device="cpu"),
                             bridge.state_from(jst, device="cpu"))


def _by_tag(x, tag, mask):
    x, tag, mask = map(np.asarray, (x, tag, mask))
    out = np.zeros((int(tag.max()) + 1,) + x.shape[1:], x.dtype)
    out[tag[mask]] = x[mask]
    return out


def _same_positions(jst, tst):
    want = _by_tag(jst.x, jst.tag, jst.mask)
    got = _by_tag(tst.x.numpy(), tst.tag.numpy(), tst.mask.numpy())
    d = np.abs(got - want)
    d = np.minimum(d, 6.0 - d)          # a row may wrap on one side only
    assert d.max() < POS_TOL, d.max()
    assert tst.step == int(jst.step)


def _same_diag(jd, td, ints, floats=()):
    for k in ints:
        np.testing.assert_array_equal(np.asarray(td[k]), np.asarray(jd[k]),
                                      err_msg=k)
    for k in floats:
        np.testing.assert_allclose(np.asarray(td[k]), np.asarray(jd[k]),
                                   rtol=1e-4, err_msg=k)


def test_run_matches_jax():
    """Two chunks of (rebuild + 10 steps) on the neighbour lists, TEA."""
    (jsys, jp, jst), (tsys, tp, tst) = _start()
    assert tsys.force_path == "nlist"
    jst, jd = jsystem.run(jsys, jp, jst, 2)
    tst, td = tsystem.run(tsys, tp, tst, 2)
    _same_positions(jst, tst)
    _same_diag(jd, td, ("cell_overflow", "nlist_overflow", "max_neigh",
                        "skin_violation"), ("max_disp_sq",))


def test_run_adaptive_matches_jax():
    """30 steps with a rebuild whenever a particle moved beyond skin/2."""
    (jsys, jp, jst), (tsys, tp, tst) = _start(rng_mode="fast")
    jst, jd = jsystem.run_adaptive(jsys, jp, jst, 30)
    tst, td = tsystem.run_adaptive(tsys, tp, tst, 30)
    _same_positions(jst, tst)
    assert td["n_rebuilds"] == int(jd["n_rebuilds"]) > 0
    _same_diag(jd, td, ("cell_overflow", "nlist_overflow"),
               ("worst_disp_at_rebuild",))


def test_run_chunk_matches_jax():
    """20 dense-path steps with no rebuild."""
    (jsys, jp, jst), (tsys, tp, tst) = _start(force_path="dense")
    jst = jsystem.run_chunk(jsys, jp, jst, 20)
    tst = tsystem.run_chunk(tsys, tp, tst, 20)
    _same_positions(jst, tst)


def test_run_bucket_fixed_matches_jax():
    """Three chunks of (bucket rebuild + 4 steps) through the sweep."""
    (jsys, jp, jst), (tsys, tp, tst) = _start(force_path="bucket",
                                              rng_mode="fast")
    jst, jd = jsystem.run_bucket_fixed(jsys, jp, jst, 3, 4)
    tst, td = tsystem.run_bucket_fixed(tsys, tp, tst, 3, 4)
    _same_positions(jst, tst)
    _same_diag(jd, td, ("bucket_overflow",), ("worst_skin_ratio",))


@pytest.mark.parametrize("builder,kw", [
    (classic_fluid, dict(l=6.0)),
    (poiseuille, dict(lx=6.0, lz=6.0)),
    (couette, dict(lx=6.0, lz=6.0)),
    (polymer_melt, dict(l=6.0, n_chains=2, chain_len=5)),
    (membrane_suspension, dict(l=8.0, radius=2.0, subdiv=0))],
    ids=["classic_fluid", "poiseuille", "couette", "polymer_melt",
         "membrane_suspension"])
def test_builders_run_their_default_force_path(builder, kw):
    """Every builder defaults to force_path "nlist", as in the JAX package,
    and now sets up and steps with it."""
    out = builder(device="cpu", **kw)
    system, params, state = out[:3]
    assert system.force_path == "nlist"
    state, diag = tsystem.run(system, params, state, 1)
    assert state.step == system.cells.rebuild_every
    assert int(diag["cell_overflow"].max()) == 0
    assert int(diag["nlist_overflow"].max()) == 0
    assert bool(torch.isfinite(state.x).all() & torch.isfinite(state.f).all())
    assert bool((state.f[state.mask] != 0).any())
    make_step(system)   # the step builds for the nlist path as well
