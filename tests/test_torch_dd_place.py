"""The host-side pieces of the port's 2-D and 3-D bricks and of its replica
ensemble against the JAX package's, with no ranks started:

- ``build_domain2d``/``build_domain3d`` give JAX's configs and refusals;
- ``distribute_state_2d``/``_3d`` place every brick's rows as JAX's
  ``distribute_state_2d``/``_3d`` do, bitwise, on strict and spill
  buckets (the bridge carries JAX's stacked bricks across, their leading
  mesh axes flattened in row-major order, the port's rank order), and
  ``collect_state_2d``/``_3d`` give the start back by tag;
- ``_rebuild_brick``/``_rebuild_brick3d`` on a whole box with one brick's
  origin and too small a capacity count the same overflow and place the
  same rows as JAX's;
- ``replicate_state``'s tags are JAX's bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.core.system import System as JSystem
from meso_tpu.parallel import domain2d as j2d
from meso_tpu.parallel import domain3d as j3d
from meso_tpu.parallel.ensemble import replicate_state as j_replicate_state
from meso_tpu_torch import bridge
from meso_tpu_torch.parallel import (build_domain2d, build_domain3d,
                                     collect_state_2d, collect_state_3d,
                                     distribute_state_2d,
                                     distribute_state_3d, replicate_state)
from meso_tpu_torch.parallel.domain2d import _rebuild_brick
from meso_tpu_torch.parallel.domain3d import _rebuild_brick3d
from test_torch_imports import one_torch_thread  # noqa: F401

SIDE, RC, SKIN, DENSITY = 1.2, 1.0, 0.2, 3.0


def fluid(cols, spill, seed=0):
    """A random JAX start in a box of ``cols`` cell columns of side 1.2 an
    axis, and its JAX system."""
    lengths = [c * SIDE for c in cols]
    n = int(round(DENSITY * np.prod(lengths)))
    state = j_create_random(jax.random.PRNGKey(seed), n,
                            JBox.orthorhombic(*lengths), kt=1.0)
    system = JSystem.for_fluid(lengths, rc=RC, density=DENSITY, dt=0.01,
                               skin=SKIN, rebuild_every=5, spill=spill)
    return system, state, lengths


def flat(dstate, n_axes):
    """JAX's stacked bricks as per-rank port states (row-major order)."""
    return bridge.states_from_distributed(jax.tree.map(
        lambda a: a.reshape((-1,) + a.shape[n_axes:]), dstate))


def by_tag(state):
    m = state.mask.numpy()
    order = np.argsort(state.tag.numpy()[m])
    return {f: getattr(state, f).numpy()[m][order] for f in ("x", "v")}


def assert_same_states(got, want):
    got, want = bridge.states_to_numpy(got), bridge.states_to_numpy(want)
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name


CASES = {"2d-strict": ((2, 2), (6, 6, 4), False),
         "2d-spill": ((2, 2), (10, 6, 4), True),
         "3d-strict": ((2, 2, 2), (6, 6, 6), False),
         "3d-spill": ((2, 2, 2), (10, 6, 6), True)}


def build_both(devs, jsys, lengths):
    if len(devs) == 2:
        jd = j2d.build_domain2d(jsys, *devs, *lengths[:2], rebuild_every=5)
        return jd, build_domain2d(bridge.system_from(jsys), *devs,
                                  *lengths[:2], rebuild_every=5)
    jd = j3d.build_domain3d(jsys, *devs, *lengths, rebuild_every=5)
    return jd, build_domain3d(bridge.system_from(jsys), *devs, *lengths,
                              rebuild_every=5)


@pytest.mark.parametrize("case", list(CASES))
def test_distribute_bricks_matches_jax_bitwise(case):
    devs, cols, spill = CASES[case]
    jsys, jstate, lengths = fluid(cols, spill)
    jd, dcfg = build_both(devs, jsys, lengths)
    assert dcfg.cells == bridge.cell_config_from(jd.cells)
    assert (dcfg.cap_mig, dcfg.rebuild_every, dcfg.devs) == (
        jd.cap_mig, jd.rebuild_every, tuple(devs))
    start = bridge.state_from(jstate)
    if len(devs) == 2:
        got = distribute_state_2d(start, dcfg, device="cpu")
        want = flat(j2d.distribute_state_2d(jstate, jd), 2)
        back = collect_state_2d(got)
    else:
        got = distribute_state_3d(start, dcfg, device="cpu")
        want = flat(j3d.distribute_state_3d(jstate, jd), 3)
        back = collect_state_3d(got)
    assert len(got) == int(np.prod(devs))
    assert_same_states(got, want)
    for f, a in by_tag(start).items():
        assert np.array_equal(by_tag(back)[f], a), f


@pytest.mark.parametrize("case", list(CASES))
def test_rebuild_brick_overflow_matches_jax(case):
    """A whole box placed into brick (1, 1[, 1])'s grid with capacity 4:
    rows outside the brick clamp into its edge cells and overflow."""
    devs, cols, spill = CASES[case]
    jsys, jstate, lengths = fluid(cols, spill, seed=4)
    jd, dcfg = build_both(devs, jsys, lengths)
    jcfg = jd.cells.__class__(ncell=jd.cells.ncell, capacity=4,
                              skin=jd.cells.skin, spill=spill)
    cfg = dcfg.cells.replace(capacity=4)
    widths = dcfg.slab_widths
    sides = [w / n for w, n in zip(widths, cfg.ncell)]
    start = bridge.state_from(jstate)
    if len(devs) == 2:
        jout, jof = jax.jit(j2d._rebuild_brick, static_argnames=(
            "cfg", "side_x", "side_y"))(
            jstate, jcfg, jnp.float32(widths[0]), jnp.float32(widths[1]),
            *sides)
        out, of = _rebuild_brick(start, cfg, float(np.float32(widths[0])),
                                 float(np.float32(widths[1])), *sides)
    else:
        jout, jof = jax.jit(j3d._rebuild_brick3d, static_argnames=(
            "cfg", "side_x", "side_y", "side_z"))(
            jstate, jcfg, *(jnp.float32(w) for w in widths), *sides)
        out, of = _rebuild_brick3d(start, cfg,
                                   *(float(np.float32(w)) for w in widths),
                                   *sides)
    assert int(of) == int(jof) > 0
    assert_same_states([out], [bridge.state_from(jout)])


def test_build_refusals_match_jax():
    jsys, _, lengths = fluid((6, 6, 4), True)
    for build, args in ((j2d.build_domain2d, (2, 2, *lengths[:2])),
                        (build_domain2d, (2, 2, *lengths[:2]))):
        system = jsys if build is j2d.build_domain2d \
            else bridge.system_from(jsys)
        with pytest.raises(ValueError, match=">= 5 local cell columns"):
            build(system, *args)
    jsys, _, lengths = fluid((6, 6, 6), False)
    with pytest.raises(ValueError, match="not divisible"):
        build_domain3d(bridge.system_from(jsys), 4, 2, 2, *lengths)
    with pytest.raises(ValueError, match=">= 3 cell columns"):
        build_domain3d(bridge.system_from(jsys), 2, 2, 3, *lengths)


@pytest.mark.parametrize("reseed", [True, False])
def test_replicate_state_tags_match_jax(reseed):
    """Tags of each replica equal JAX's bitwise, masked rows' tags
    included (0 under reseed)."""
    jsys, jstate, _ = fluid((4, 4, 4), False)
    jstate = jstate.replace(mask=jstate.mask.at[::7].set(False))
    want = np.asarray(j_replicate_state(jstate, 3, reseed=reseed).tag)
    got = replicate_state(bridge.state_from(jstate), 3, reseed=reseed)
    assert len(got) == 3
    for r in range(3):
        assert got[r].tag.dtype == bridge.state_from(jstate).tag.dtype
        assert np.array_equal(got[r].tag.numpy(), want[r])
