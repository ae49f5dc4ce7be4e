"""The host-side pieces of the port's 1-D decomposition against the JAX
package's, and its migration on gloo rings on the CPU.

- ``build_domain``'s config and ``distribute_state``'s per-rank rows equal
  JAX's bitwise, on strict and spill buckets (the bridge carries JAX's
  distributed state, with its leading device axis, across);
- ``collect_state`` gives back the start, bitwise by tag;
- ``_migrate`` on a ring of 4 ranks: with room in the buffers, N is
  conserved, tags stay unique and every row lands in its own slab; with
  buffers of 4 rows, the overflow on each rank equals a numpy count of the
  crossers beyond the capacity in each direction and of the rows more than
  one slab away, and no other row is lost;
- at P = 2, where both neighbours are one rank, every crosser travels
  right (``meso_tpu/parallel/domain.py:166-170``) and N is conserved;
- at P = 1 (R10, ROADMAP Queue 3): JAX's ``_migrate`` sends every row
  left to itself and drops those beyond ``cap_mig``; the port moves none;
- ``fit_slab_capacity`` gives the least capacity that places a start on
  its slabs.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.core.system import System as JSystem
from meso_tpu.parallel.domain import _migrate as j_migrate
from meso_tpu.parallel.domain import build_domain as j_build_domain
from meso_tpu.parallel.domain import distribute_state as j_distribute_state
from meso_tpu.parallel.domain import make_mesh_1d as j_make_mesh_1d
from meso_tpu_torch import bridge
from meso_tpu_torch.parallel import (Ring, build_domain, collect_state,
                                     distribute_state, launch)
from meso_tpu_torch.parallel.domain import _migrate, fit_slab_capacity
from test_torch_imports import one_torch_thread  # noqa: F401

SIDE, RC, SKIN, DENSITY = 1.2, 1.0, 0.2, 3.0
SPAWN_TIMEOUT_S = 120.0


def fluid(n_dev, spill, seed=0):
    """A random JAX start in a box of ``n_dev`` slabs of 5 (spill) or 3
    (strict) cell columns, and its JAX system."""
    lx = n_dev * (5 if spill else 3) * SIDE
    lyz = 4 * SIDE
    n = int(round(DENSITY * lx * lyz * lyz))
    state = j_create_random(jax.random.PRNGKey(seed), n,
                            JBox.orthorhombic(lx, lyz, lyz), kt=1.0)
    system = JSystem.for_fluid([lx, lyz, lyz], rc=RC, density=DENSITY,
                               dt=0.01, skin=SKIN, rebuild_every=5,
                               spill=spill)
    return system, state, lx, n


def by_tag(state):
    m = state.mask.numpy()
    order = np.argsort(state.tag.numpy()[m])
    return {f: getattr(state, f).numpy()[m][order] for f in ("x", "v")}


@pytest.mark.parametrize("spill", [False, True], ids=["strict", "spill"])
def test_distribute_matches_jax_bitwise(spill):
    jsys, jstate, lx, _ = fluid(4, spill)
    jd = j_build_domain(jsys, 4, lx_global=lx, rebuild_every=5)
    system = bridge.system_from(jsys)
    dcfg = build_domain(system, 4, lx_global=lx, rebuild_every=5)
    assert (dcfg.n_dev, dcfg.cap_mig, dcfg.rebuild_every, dcfg.lx_global) \
        == (jd.n_dev, jd.cap_mig, jd.rebuild_every, jd.lx_global)
    assert dcfg.cells == bridge.cell_config_from(jd.cells)
    start = bridge.state_from(jstate)
    got = bridge.states_to_numpy(distribute_state(start, dcfg,
                                                  device="cpu"))
    want = bridge.states_to_numpy(bridge.states_from_distributed(
        j_distribute_state(jstate, jd)))
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name
    back = by_tag(collect_state(distribute_state(start, dcfg,
                                                 device="cpu")))
    for f, a in by_tag(start).items():
        assert np.array_equal(back[f], a), f


def moved_slabs(n_dev, seed=3):
    """Per-rank slab states of a 4- or 2-slab fluid whose rows then moved:
    by up to +-0.4 in x, and, on every rank, 5 rows by two slab widths (at
    P = 4 these are more than one slab away)."""
    jsys, jstate, lx, n = fluid(n_dev, False, seed)
    system = bridge.system_from(jsys)
    dcfg = build_domain(system, n_dev, lx_global=lx, rebuild_every=5)
    states = distribute_state(bridge.state_from(jstate), dcfg, device="cpu")
    rs = np.random.RandomState(seed)
    out = []
    for st in states:
        dx = torch.from_numpy(rs.uniform(-0.4, 0.4, st.n).astype(np.float32))
        far = torch.nonzero(st.mask)[:5, 0]
        dx[far] += 2 * dcfg.slab_w
        x = st.x.clone()
        x[:, 0] = torch.where(st.mask, x[:, 0] + dx, x[:, 0])
        out.append(st.replace(x=st.box.wrap(x, st.image)[0]))
    return out, dcfg, n


def numpy_overflow(state, rank, dcfg):
    """Rows beyond cap_mig going each way, and rows more than one slab
    away, counted with numpy."""
    m = state.mask.numpy()
    tgt = np.clip((state.x[:, 0].numpy() / np.float32(dcfg.slab_w)
                   ).astype(np.int32), 0, dcfg.n_dev - 1)
    delta = (tgt - rank) % dcfg.n_dev
    right = m & (delta == 1)
    left = m & (delta == dcfg.n_dev - 1) & ~right
    far = m & (delta != 0) & ~right & ~left
    return (max(0, int(right.sum()) - dcfg.cap_mig)
            + max(0, int(left.sum()) - dcfg.cap_mig) + int(far.sum()))


def slab_of(x, dcfg):
    return np.clip((x / np.float32(dcfg.slab_w)).astype(int), 0,
                   dcfg.n_dev - 1)


def test_migrate_on_a_ring_of_4(tmp_path):
    states, dcfg, n = moved_slabs(4)
    small = dcfg.__class__(**{**dcfg.__dict__, "cap_mig": 4})
    out = launch.spawn(
        launch.call, 4, tmp_path, device="cpu", timeout_s=SPAWN_TIMEOUT_S,
        args=([(_migrate, [(st, dcfg) for st in states]),
               (_migrate, [(st, small) for st in states])],))
    tags, dropped, lost, kept_tight = [], 0, 0, 0
    for rank, (roomy, tight) in enumerate(out):
        merged, of = roomy
        m = merged.mask.numpy()
        tags.append(merged.tag.numpy()[m])
        assert (slab_of(merged.x[:, 0].numpy()[m], dcfg) == rank).all()
        assert int(of) == numpy_overflow(states[rank], rank, dcfg)
        dropped += int(of)
        merged_t, of_t = tight
        assert merged_t.n == states[rank].n + 2 * small.cap_mig
        assert int(of_t) == numpy_overflow(states[rank], rank, small)
        assert int(of_t) > int(of)
        lost += int(of_t)
        kept_tight += int(merged_t.mask.sum())
    tags = np.concatenate(tags)
    # with room, only the rows more than one slab away are dropped
    assert dropped > 0 and len(tags) == n - dropped
    assert len(np.unique(tags)) == len(tags)
    assert kept_tight == n - lost


def test_migrate_two_ranks_sends_every_crosser_right(tmp_path):
    states, dcfg, n = moved_slabs(2, seed=4)
    out = launch.spawn(launch.call, 2, tmp_path, device="cpu",
                       timeout_s=SPAWN_TIMEOUT_S,
                       args=([(_migrate, [(st, dcfg) for st in states])],))
    nr, cap = states[0].n, dcfg.cap_mig
    tags = []
    for rank, ((merged, of),) in enumerate(out):
        m = merged.mask.numpy()
        assert int(of) == 0
        assert m[nr:nr + cap].any() and not m[nr + cap:].any()
        assert (slab_of(merged.x[:, 0].numpy()[m], dcfg) == rank).all()
        tags.append(merged.tag.numpy()[m])
    tags = np.sort(np.concatenate(tags))
    assert (tags == np.arange(1, n + 1)).all()


def test_one_rank_migrates_nothing_r10():
    jsys, jstate, lx, n = fluid(1, False)
    jd = j_build_domain(jsys, 1, lx_global=lx, rebuild_every=5)
    dst = j_distribute_state(jstate, jd)
    j_of = jax.jit(jax.shard_map(
        lambda s: j_migrate(jax.tree.map(lambda a: a[0], s), jd, 0.0,
                            0.0)[1][None],
        mesh=j_make_mesh_1d(1), in_specs=(PartitionSpec("x"),),
        out_specs=PartitionSpec("x"), check_vma=False))(dst)
    assert int(j_of[0]) == n - jd.cap_mig > 0
    dcfg = build_domain(bridge.system_from(jsys), 1, lx_global=lx,
                        rebuild_every=5)
    (st,) = distribute_state(bridge.state_from(jstate), dcfg, device="cpu")
    merged, of = _migrate(st, dcfg, Ring.single())
    assert int(of) == 0 and int(merged.mask.sum()) == n
    assert torch.equal(merged.mask[:st.n], st.mask)


def test_fit_slab_capacity_places_the_start():
    jsys, jstate, lx, _ = fluid(4, True, seed=1)
    system = bridge.system_from(jsys)
    system = system.replace(cells=system.cells.replace(capacity=8))
    start = bridge.state_from(jstate)
    fitted = fit_slab_capacity(system, start, 4, lx)
    k = fitted.cells.capacity
    assert k > 8
    distribute_state(start, build_domain(fitted, 4, lx_global=lx),
                     device="cpu")
    tight = system.replace(cells=system.cells.replace(capacity=k - 1))
    with pytest.raises(ValueError, match="overflow"):
        distribute_state(start, build_domain(tight, 4, lx_global=lx),
                         device="cpu")
