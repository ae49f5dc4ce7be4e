"""The port's 2-D bricks, its ("dp", "x") ensemble and its mesh of ranks on
4 gloo ranks on the CPU, started once for every case of this file
(``launch.slab_runs``), against the JAX package's single-card dense path
on the same start, by tag. The start is JAX's, carried across by the
bridge; the counter-based pair RNG depends only on (tags, step, seed), so
a trajectory does not depend on the decomposition.

Cases:

- the 2 x 2 mesh: each rank's id shifted along x and along y, and summed
  and maxed over each axis and over both;
- classic DPD through the sweep (force_path "bucket", strict buckets, 3
  chunks of 5 steps) and through K4 (``halo_forces_pallas_fused`` with
  ext ("x", "y")) on spill buckets in a box of 2 x 5 cell columns along x,
  as tests/dist/test_domain2d.py and test_spill_dist_2d3d.py hold JAX's:
  x < 2e-4, v < 2e-3;
- eDPD and tDPD through the sweep, with the starts of
  tests/dist/test_transport_dist2d.py (a sine of T and a cosine of C along
  y): x, T and C < 5e-4;
- the eDPD slab's FixRegionT (end_of_step), which JAX's 2-D step skips
  (R11): by tag against the single-card dense path, which runs it, at
  5e-4;
- FENE chains with special bonds at weight 0.5 (R15: JAX's 2-D force
  paths drop the exclusions) through K4 and through the sweep, migration
  and rebuild every step (every pair in reach): x < 1e-4, v < 1e-3, no
  bonded term missing its partner;
- DP x SP: 2 replicas x 2 slabs on a ("dp", "x") mesh through K4; replica
  0 (its tags unchanged) within 1e-6 of the 1-D run of the same start on
  the same slabs (``reseed=False``: each replica is the 1-D run) and
  within the classic bounds of the JAX dense path; replica 1's rows
  decorrelate (max |dx| by tag, the minimum image, above 0.1).

The ranks run K4's plain version here; chip_smoke.py runs the same paths
on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.rng import maxwell_velocities as j_maxwell
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.core.state import zeros_state as j_zeros_state
from meso_tpu.core.system import System as JSystem
from meso_tpu.core.system import SystemParams as JSystemParams
from meso_tpu.models.transport import edpd_slab as j_edpd_slab
from meso_tpu.ops.bonded import BondedParams as JBondedParams
from meso_tpu.ops.dpd import DPDParams as JDPDParams
from meso_tpu.ops.dpd import build_exclusions as j_build_exclusions
from meso_tpu.ops.edpd import EDPDParams as JEDPDParams
from meso_tpu.ops.tdpd import TDPDParams as JTDPDParams
from meso_tpu_torch import bridge
from meso_tpu_torch.parallel import (build_domain, build_domain2d,
                                     build_domain3d, collect_state,
                                     distribute_ensemble_spatial,
                                     distribute_state_2d,
                                     distribute_state_3d, launch)
from meso_tpu_torch.parallel.ensemble import ensemble_spatial_rank
from test_torch_dd_slice import by_tag, jax_reference, jax_setup
from test_torch_imports import one_torch_thread  # noqa: F401

N_RANKS = 4
SIDE, RC, SKIN, DENSITY = 1.2, 1.0, 0.2, 3.0
CHUNKS, EVERY = 3, 5
SPAWN_TIMEOUT_S = 240.0
AXES = ("x", "y", "z")


def fluid_case(cols, spill=False, seed=0):
    """A classic fluid, ``cols`` cell columns of side 1.2 an axis, from
    JAX's random start and dense setup: (system, params, start, lengths,
    N)."""
    lengths = [c * SIDE for c in cols]
    n = int(round(DENSITY * np.prod(lengths)))
    state = j_create_random(jax.random.PRNGKey(seed), n,
                            JBox.orthorhombic(*lengths), kt=1.0)
    params = JSystemParams.build(JDPDParams.build(
        a=25.0, gamma=4.5, rc=RC, kt=1.0, seed=928459))
    system = JSystem.for_fluid(lengths, rc=RC, density=DENSITY, dt=0.01,
                               skin=SKIN, rng_mode="fast",
                               rebuild_every=EVERY, spill=spill)
    return system, params, jax_setup(system, params, state), lengths, n


def transport_case(model):
    """The starts of tests/dist/test_transport_dist2d.py (2 x 2 bricks of
    3 x 3 columns, 4 cells along z)."""
    lengths = [6 * SIDE, 6 * SIDE, 4 * SIDE]
    n = int(round(DENSITY * np.prod(lengths)))
    st = j_create_random(jax.random.PRNGKey(0), n,
                         JBox.orthorhombic(*lengths), kt=1.0,
                         with_energy=model == "edpd",
                         n_species=1 if model == "tdpd" else 0)
    if model == "edpd":
        st = st.replace(T=1.0 + 0.2 * jnp.sin(st.x[:, 1]))
        pair = JEDPDParams.build(a=25.0, gamma=4.5, rc=RC, kappa=1.0,
                                 cv=20.0, seed=77)
    else:
        st = st.replace(C=(1.0 + 0.5 * jnp.cos(
            2 * jnp.pi * st.x[:, 1] / lengths[1]))[:, None])
        pair = JTDPDParams.build(a=25.0, gamma=4.5, rc=RC, kt=1.0,
                                 kappa_c=[1.5], eps_c=[0.1], rcc=RC,
                                 seed=88)
    params = JSystemParams.build_raw(pair)
    system = JSystem.for_fluid(lengths, rc=RC, density=DENSITY, dt=0.01,
                               skin=SKIN, rng_mode="fast",
                               rebuild_every=EVERY).replace(model=model)
    return system, params, jax_setup(system, params, st), lengths, n


def region_t_case():
    """JAX's eDPD slab (FixRegionT: a hot slab at x in [0, 1), a cold one
    at [L/2, L/2 + 1)) at L = 7.8, 6 cells of 1.3 an axis."""
    system, params, state = j_edpd_slab(l=7.8, force_path="dense")
    lengths = [7.8] * 3
    return system, params, state, lengths, int(np.asarray(state.mask).sum())


def polymer_case(cols, special_weight=0.5):
    """Six FENE chains of 10 beads in solvent (tests/dist/test_bonded_dist
    .py's chains) in a box of ``cols`` cell columns, exclusions along the
    bonds at ``special_weight``."""
    lengths = [c * SIDE for c in cols]
    n = int(round(DENSITY * np.prod(lengths)))
    rs = np.random.RandomState(11)
    n_chains, chain_len = 6, 10
    chains = []
    for _ in range(n_chains):
        pos = [rs.uniform(0, 1, 3) * lengths]
        for _ in range(chain_len - 1):
            d = rs.normal(size=3)
            pos.append(pos[-1] + d * 0.8 / np.linalg.norm(d))
        chains.append(np.asarray(pos) % lengths)
    x_poly = np.concatenate(chains)
    x_solv = rs.uniform(0, 1, (n - len(x_poly), 3)) * lengths
    box = JBox.orthorhombic(*lengths)
    st = j_zeros_state(n, box).replace(
        x=jnp.asarray(np.concatenate([x_poly, x_solv]), jnp.float32),
        v=j_maxwell(jax.random.PRNGKey(2), n, 1.0, 1.0),
        tag=jnp.arange(1, n + 1, dtype=jnp.int32), mask=jnp.ones(n, bool))
    bonds = np.asarray([(c * chain_len + b + 1, c * chain_len + b + 2)
                        for c in range(n_chains)
                        for b in range(chain_len - 1)], np.int32)
    bonded = JBondedParams(
        bond_tags=jnp.asarray(bonds),
        bond_type=jnp.zeros(len(bonds), jnp.int32),
        bond_coeffs=jnp.asarray([[30.0, 1.5, 0.0, 0.0]], jnp.float32))
    excl, w = j_build_exclusions(bonds, n, weight=special_weight, max_excl=2)
    pair = JDPDParams.build(a=25.0, gamma=4.5, rc=RC, kt=1.0, seed=99)
    params = JSystemParams.build(pair.replace(excl=excl, excl_w=w)).replace(
        bonded=bonded)
    system = JSystem.for_fluid(lengths, rc=RC, density=DENSITY, dt=0.01,
                               skin=SKIN, rng_mode="fast",
                               rebuild_every=EVERY)
    system = system.replace(bond_style="fene", n_tags=n)
    return system, params, jax_setup(system, params, st), lengths, n


def brick_job(case, devs, chunks=CHUNKS, every=EVERY, **system_kw):
    """The brick job of the port on ``devs`` ranks an axis (2 or 3 axes):
    the JAX system, parameters and start carried across and split into
    bricks on the CPU, ``chunks`` chunks of ``every`` steps."""
    jsys, jparams, jstate, lengths, _ = case
    system = bridge.system_from(jsys).replace(**system_kw)
    state = bridge.state_from(jstate)
    if len(devs) == 2:
        dcfg = build_domain2d(system, *devs, *lengths[:2],
                              rebuild_every=every)
        states = distribute_state_2d(state, dcfg, device="cpu")
    else:
        dcfg = build_domain3d(system, *devs, *lengths, rebuild_every=every)
        states = distribute_state_3d(state, dcfg, device="cpu")
    return dict(system=system, params=bridge.system_params_from(jparams),
                states=states, dcfg=dcfg, nchunks=chunks,
                mesh=(devs, AXES[:len(devs)]))


def fields_of(final):
    fields = {f: getattr(final, f) for f in ("x", "v", "mask", "tag", "T",
                                             "C")}
    return {f: None if t is None else t.numpy() for f, t in fields.items()}


def collected(ranks):
    """(the ranks' diags, the collected state by tag, the valid tags) of
    one job's per-rank results."""
    fields = fields_of(collect_state([r["state"] for r in ranks]))
    return ([r["diag"] for r in ranks], by_tag(fields),
            fields["tag"][fields["mask"]])


def assert_trajectory(got, want, n, x_tol, v_tol, field_tol=None,
                      bonded=False):
    """No overflow (nor missing bonded partner) on any rank, N conserved
    and tags unique, and x, v (and T or C) by tag within the bounds."""
    diags, traj, tags = got
    assert all(d["overflow"] == 0 for d in diags)
    if bonded:
        assert all(d["bonded_missing"] == 0 for d in diags)
    assert len(tags) == n and (np.sort(tags) == np.arange(1, n + 1)).all()
    assert np.abs(traj["x"] - want["x"]).max() < x_tol
    if v_tol is not None:
        assert np.abs(traj["v"] - want["v"]).max() < v_tol
    for f in ("T", "C"):
        if f in want:
            assert np.abs(traj[f] - want[f]).max() < field_tol


def dpsp_jobs(case):
    """DP x SP on a ("dp", "x") mesh of 2 x 2 through K4 on strict buckets:
    the reseeded ensemble and, as the 1-D reference, the same start with
    every replica's tags unchanged."""
    jsys, jparams, jstate, lengths, _ = case
    system = bridge.system_from(jsys).replace(force_path="pallas")
    params = bridge.system_params_from(jparams)
    dcfg = build_domain(system, 2, lx_global=lengths[0],
                        rebuild_every=EVERY)
    start = bridge.state_from(jstate)
    return [(ensemble_spatial_rank,
             (system, params, distribute_ensemble_spatial(
                 start, 2, dcfg, reseed=reseed, device="cpu"), dcfg,
              CHUNKS + 1)) for reseed in (True, False)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {
        "classic-sweep": (fluid_case((6, 6, 4)), dict(force_path="bucket")),
        "classic-k4-spill": (fluid_case((10, 6, 4), spill=True, seed=5),
                             dict(force_path="pallas")),
        "edpd": (transport_case("edpd"), dict(force_path="bucket")),
        "tdpd": (transport_case("tdpd"), dict(force_path="bucket")),
        "region-t": (region_t_case(), dict(force_path="bucket")),
        "polymer-k4": (polymer_case((6, 6, 4)), dict(force_path="pallas")),
        "polymer-sweep": (polymer_case((6, 6, 4)),
                          dict(force_path="bucket"))}
    wants, jobs = {}, []
    for name, (case, kw) in cases.items():
        per_step = name.startswith("polymer")
        if name != "polymer-sweep":
            steps = CHUNKS * EVERY
            wants[name] = jax_reference(case[0], case[1], case[2], steps)
        else:
            wants[name] = wants["polymer-k4"]
        jobs.append(brick_job(case, (2, 2), every=1 if per_step else EVERY,
                              chunks=CHUNKS * EVERY if per_step else CHUNKS,
                              **kw))
    dpsp = fluid_case((6, 4, 4), seed=3)
    wants["dpsp"] = jax_reference(dpsp[0], dpsp[1], dpsp[2],
                                  (CHUNKS + 1) * EVERY)
    jobs += dpsp_jobs(dpsp)
    jobs.append((launch.mesh_shifts, ((2, 2), ("x", "y"))))
    results = launch.spawn(launch.slab_runs, N_RANKS,
                           tmp_path_factory.mktemp("dd_2d"), args=(jobs,),
                           device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    got = {name: collected([r[j] for r in results])
           for j, name in enumerate(cases)}
    ns = {name: case[4] for name, (case, _) in cases.items()}
    ns["dpsp"] = dpsp[4]
    j = len(cases)
    got["dpsp"] = [[r[j + k] for r in results] for k in (0, 1)]
    got["shifts"] = [r[-1] for r in results]
    return wants, got, ns


def test_mesh_2x2_shifts_and_reductions(runs):
    _, got, _ = runs
    shifts = got["shifts"]
    for rank, out in enumerate(shifts):
        i, j = divmod(rank, 2)
        assert out["coords"] == {"x": i, "y": j}
        for axis, peer in (("x", lambda d: ((i + d) % 2) * 2 + j),
                           ("y", lambda d: i * 2 + (j + d) % 2)):
            line = [peer(0), peer(1)]
            assert out[axis] == (peer(-1), peer(1), sum(line), max(line))
        assert out["all"] == (6, 3)


@pytest.mark.parametrize("case", ["classic-sweep", "classic-k4-spill"])
def test_classic_2x2_matches_jax_single_card(runs, case):
    wants, got, ns = runs
    assert_trajectory(got[case], wants[case], ns[case], 2e-4, 2e-3)


@pytest.mark.parametrize("case", ["edpd", "tdpd"])
def test_transport_2x2_matches_jax_single_card(runs, case):
    wants, got, ns = runs
    assert_trajectory(got[case], wants[case], ns[case], 5e-4, None, 5e-4)


def test_fix_region_t_runs_under_bricks_r11(runs):
    """The hot and cold slabs hold their T on every rank, as on one card."""
    wants, got, ns = runs
    assert_trajectory(got["region-t"], wants["region-t"], ns["region-t"],
                      5e-4, None, 5e-4)
    traj = got["region-t"][1]
    hot = traj["x"][:, 0] < 1.0
    cold = (traj["x"][:, 0] >= 3.9) & (traj["x"][:, 0] < 4.9)
    assert hot.any() and cold.any()
    assert np.all(traj["T"][hot] == np.float32(1.2))
    assert np.all(traj["T"][cold] == np.float32(0.8))


@pytest.mark.parametrize("case", ["polymer-k4", "polymer-sweep"])
def test_special_bonds_polymer_2x2_r15(runs, case):
    wants, got, ns = runs
    assert_trajectory(got[case], wants[case], ns[case], 1e-4, 1e-3,
                      bonded=True)


def test_dp_x_sp_replica0_is_the_1d_run(runs):
    wants, got, ns = runs
    n = ns["dpsp"]
    ens, ref = got["dpsp"]
    assert all(r["diag"]["overflow"] == 0 for r in ens + ref)
    rep0 = collected(ens[:2])
    one_d = collected(ref[:2])
    assert np.abs(rep0[1]["x"] - one_d[1]["x"]).max() < 1e-6
    assert np.abs(rep0[1]["v"] - one_d[1]["v"]).max() < 1e-6
    assert_trajectory(rep0, wants["dpsp"], n, 2e-4, 2e-3)
    rep1 = collected(ens[2:])
    assert len(rep1[2]) == n
    assert (np.sort(rep1[2]) == np.arange(1, n + 1) + n).all()
    d = rep1[1]["x"] - rep0[1]["x"]
    lengths = np.asarray([6, 4, 4]) * SIDE
    assert np.abs(d - lengths * np.round(d / lengths)).max() > 0.1
