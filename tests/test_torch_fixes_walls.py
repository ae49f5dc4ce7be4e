"""The wall path in the port against the JAX package: each fix and region on
the same state, a few steps of the JAX ``poiseuille`` and ``couette``
states carried across by the bridge and run by both packages, and the
velocity and temperature profiles.

The fixes and regions are elementwise, so their outputs agree to float32
rounding (FixMomentumZero's centre-of-mass sum is taken in another order:
1e-6). The step runs are held to PR 1's chunk-test bounds
(tests/test_torch_slice.py): forces within 1e-4 of their scale, v within
1e-4 and x within 1e-5 after 5 steps."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core import region as jregion
from meso_tpu.core.system import run_chunk as j_run_chunk
from meso_tpu.models.walls import couette as j_couette
from meso_tpu.models.walls import poiseuille as j_poiseuille
from meso_tpu.obs import profiles as jprof
from meso_tpu.ops import fixes as jfixes
from meso_tpu_torch import bridge
from meso_tpu_torch.core import region as tregion
from meso_tpu_torch.core.system import make_step
from meso_tpu_torch.models.walls import couette, poiseuille
from meso_tpu_torch.neighbor.bucket_layout import to_bucket_state
from meso_tpu_torch.obs import profiles as tprof
from meso_tpu_torch.ops import fixes as tfixes
from test_torch_imports import one_torch_thread  # noqa: F401

BUILDERS = {"poiseuille": j_poiseuille, "couette": j_couette}


@pytest.fixture(scope="module")
def jax_walls():
    """Each JAX builder's (system, params, state) on the dense path."""
    return {name: fn(force_path="dense") for name, fn in BUILDERS.items()}


def _port(jsys, jparams, jst):
    return (bridge.system_from(jsys), bridge.system_params_from(jparams),
            bridge.state_from(jst))


def _crossed(jst, lo=1.0, hi=5.0):
    """The state with 20 fluid rows pushed below ``lo`` and 20 above
    ``hi``, so the bounce-back has work to do."""
    x = np.asarray(jst.x).copy()
    fluid = np.flatnonzero(np.asarray(jst.typ) == 0)
    x[fluid[:20], 1] = lo - 0.05
    x[fluid[20:40], 1] = hi + 0.07
    return jst.replace(x=jnp.asarray(x))


FIXES = {
    "body_force_typ": dict(cls="FixBodyForce", fx=0.1, typ=0),
    "body_force_all": dict(cls="FixBodyForce", fy=-0.3, fz=0.2),
    "bounce_back": dict(cls="FixBounceBack", axis=1, lo=1.0, hi=5.0),
    "bounce_back_moving": dict(cls="FixBounceBack", axis=1, lo=1.0, hi=5.0,
                               u_lo=(-0.5, 0.0, 0.1), u_hi=(0.5, 0.2, 0.0)),
    "wall_move": dict(cls="FixWallMove", typ=1),
    "momentum_zero_on": dict(cls="FixMomentumZero", every=5),
    "momentum_zero_off": dict(cls="FixMomentumZero", every=7),
    "set_force_typ": dict(cls="FixSetForce", fx=0.0, fz=1.5, typ=1),
    "set_force_all": dict(cls="FixSetForce", fy=2.0),
}


@pytest.mark.parametrize("name", list(FIXES))
def test_fix_matches_jax(name, jax_walls):
    kw = dict(FIXES[name])
    jfix = getattr(jfixes, kw.pop("cls"))(**kw)
    jsys, jparams, jst = jax_walls["couette"]
    jst = _crossed(jst).replace(step=jnp.int32(15))
    jsys = jsys.replace(fixes=(jfix,))
    tsys, tparams, tst = _port(jsys, jparams, jst)
    (tfix,) = tsys.fixes
    assert type(tfix).__name__ == type(jfix).__name__
    assert dataclasses.asdict(tfix) == dataclasses.asdict(jfix)
    if hasattr(jfix, "post_force"):
        pairs = [(jfix.post_force(jsys, jparams, jst, jst.x, jst.v, jst.f),
                  tfix.post_force(tsys, tparams, tst, tst.x, tst.v, tst.f))]
    elif hasattr(jfix, "post_integrate"):
        x1 = jst.x + 0.01 * jst.v
        got = tfix.post_integrate(tsys, tparams, tst, torch.from_numpy(
            np.array(x1)), tst.image, tst.v)
        pairs = list(zip(jfix.post_integrate(jsys, jparams, jst, x1,
                                             jst.image, jst.v), got))
    else:
        j_end = jfix.end_of_step(jsys, jparams, jst)
        t_end = tfix.end_of_step(tsys, tparams, tst)
        pairs = [(j_end.x, t_end.x), (j_end.v, t_end.v)]
    changed = False
    for want, got in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        changed |= not np.array_equal(want, np.asarray(jst.x)) and \
            not np.array_equal(want, np.asarray(jst.v)) and \
            not np.array_equal(want, np.asarray(jst.f))
    # every fix but the skipped momentum step changes something
    assert changed == (name != "momentum_zero_off")


REGIONS = {
    "block": (lambda m: m.Block(lo=(1.0, -np.inf, 2.0),
                                hi=(6.0, 3.0, np.inf))),
    "sphere": lambda m: m.Sphere(center=(5.0, 3.0, 5.0), radius=2.2),
    "cylinder": lambda m: m.Cylinder(axis=2, c1=4.0, c2=3.0, radius=1.7,
                                     lo=2.0, hi=8.0),
    "union_complement": lambda m: m.Union(regions=(
        m.Sphere(center=(2.0, 2.0, 2.0), radius=1.5),
        m.Complement(m.Block(lo=(0.0, 0.0, 0.0), hi=(9.0, 5.5, 9.0))))),
}


@pytest.mark.parametrize("name", list(REGIONS))
def test_region_matches_jax(name, jax_walls):
    jst = jax_walls["poiseuille"][2]
    tst = bridge.state_from(jst)
    jr, tr = REGIONS[name](jregion), REGIONS[name](tregion)
    np.testing.assert_array_equal(tr.inside(tst.x).numpy(),
                                  np.asarray(jr.inside(jst.x)))
    np.testing.assert_array_equal(
        tregion.set_type_in_region(tst, tr, 3).typ.numpy(),
        np.asarray(jregion.set_type_in_region(jst, jr, 3).typ))
    np.testing.assert_array_equal(
        tregion.delete_in_region(tst, tr).mask.numpy(),
        np.asarray(jregion.delete_in_region(jst, jr).mask))
    n = int(tregion.count_in_region(tst, tr))
    assert n == int(jregion.count_in_region(jst, jr)) and 0 < n < tst.n


@pytest.mark.parametrize("path", ["dense", "pallas"])
@pytest.mark.parametrize("builder", list(BUILDERS))
def test_builder_steps_match_jax(builder, path, jax_walls):
    """5 steps of the JAX builder's state in both packages: JAX on its
    dense path, the port on its dense path (same rows) or through the plain
    K1 general kernel on bucket rows (compared by tag)."""
    jsys, jparams, jst = jax_walls[builder]
    j_end = j_run_chunk(jsys, jparams, jst, 5)
    tsys, tparams, tst = _port(jsys, jparams, jst)
    if path == "pallas":
        tsys = tsys.replace(force_path="pallas")
        tst = to_bucket_state(tst, tsys.cells)
    step = make_step(tsys)
    for _ in range(5):
        tst = step(tparams, tst)
    assert tst.step == int(j_end.step) == 5
    m = tst.mask.numpy()
    order = np.argsort(tst.tag.numpy()[m])
    got = {k: getattr(tst, k).numpy()[m][order] for k in ("x", "v", "f")}
    jorder = np.argsort(np.asarray(j_end.tag))
    want = {k: np.asarray(getattr(j_end, k))[jorder] for k in ("x", "v", "f")}
    scale = np.abs(want["f"]).max()
    assert np.abs(got["f"] - want["f"]).max() / scale < 1e-4
    assert np.abs(got["v"] - want["v"]).max() < 1e-4
    assert np.abs(got["x"] - want["x"]).max() < 1e-5
    # the frozen walls did not move (Couette's: by exactly dt * u each
    # step, as in JAX)
    wall = np.asarray(j_end.typ)[jorder] == 1
    np.testing.assert_array_equal(got["x"][wall], want["x"][wall])


def test_wall_system_carried_across(jax_walls):
    jsys = jax_walls["couette"][0]
    tsys = bridge.system_from(jsys)
    assert tsys.frozen_types == (1,) and tsys.dt == jsys.dt
    assert [type(f).__name__ for f in tsys.fixes] == \
        ["FixBounceBack", "FixWallMove"]
    assert tsys.fixes[0].u_lo == (-0.5, 0.0, 0.0)
    assert tsys.cells.ncell == jsys.cells.ncell
    # wall moves need in-box positions every step: the deferred wrap is
    # refused, as in JAX
    with pytest.raises(ValueError, match="post_integrate"):
        make_step(tsys.replace(force_path="pallas", wrap_mode="rebuild"))


@pytest.mark.parametrize("typ", [None, 0])
def test_profiles_match_jax(typ, jax_walls):
    jsys, jparams, jst = jax_walls["poiseuille"]
    # a shear flow on top of the thermal velocities
    v = np.asarray(jst.v).copy()
    v[:, 0] += 0.3 * np.sin(np.asarray(jst.x)[:, 1])
    jst = jst.replace(v=jnp.asarray(v))
    tst = bridge.state_from(jst)
    jmass = jparams.mass[jst.typ]
    tmass = torch.from_numpy(np.array(jmass))
    for want, got in zip(
            jprof.velocity_profile(jst, 1, 0, 12, typ=typ),
            tprof.velocity_profile(tst, 1, 0, 12, typ=typ)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    for sub in (True, False):
        for want, got in zip(
                jprof.temperature_profile(jst, jmass, 1, 12, typ=typ,
                                          subtract_flow=sub),
                tprof.temperature_profile(tst, tmass, 1, 12, typ=typ,
                                          subtract_flow=sub)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["poiseuille", "couette"])
def test_port_builders_on_the_cpu(name):
    """The port's builders: a wall slab of frozen type-1 beads at rest (or
    moving with +-u/2 along x), a 2 x 2 table, K1's general case."""
    fn = {"poiseuille": poiseuille, "couette": couette}[name]
    system, params, state = fn(force_path="pallas", device="cpu")
    m = state.mask
    y, typ = state.x[m, 1], state.typ[m]
    wall = typ == 1
    assert bool(((y < 1.0) | (y > 5.0))[wall].all())
    assert bool(((y >= 1.0) & (y <= 5.0))[~wall].all())
    assert params.pair.n_types == 2 and system.frozen_types == (1,)
    assert system.cells.spill and torch.isfinite(state.f).all()
    vx = state.v[m, 0][wall]
    if name == "poiseuille":
        assert bool((state.v[m][wall] == 0).all())
    else:
        assert set(vx.unique().tolist()) == {-0.5, 0.5}


def test_muller_plathe_swap_matches_jax(jax_walls):
    """One Mueller-Plathe swap on the same state (flow along x, gradient
    along z), as obs.viscosity drives it between chunks."""
    from meso_tpu.obs.viscosity import muller_plathe_swap as j_swap
    from meso_tpu_torch.obs.viscosity import muller_plathe_swap as t_swap
    _, jparams, jst = jax_walls["poiseuille"]
    jmass = jparams.mass[jst.typ]
    j_end, dp_j = j_swap(jst, jmass, 0, 2, 20)
    t_end, dp_t = t_swap(bridge.state_from(jst),
                         torch.from_numpy(np.array(jmass)), 0, 2, 20)
    np.testing.assert_array_equal(t_end.v.numpy(), np.asarray(j_end.v))
    assert float(dp_t) == float(dp_j) > 0.0
