"""The port's 1-D domain decomposition on 4 gloo ranks on the CPU, against
the JAX package's single-card path on the same start: 3 chunks of 5 steps,
positions and velocities compared by tag, as JAX's own
tests/dist/test_domain.py:60-93 compares its distributed run with its
single-chip one (bounds x < 2e-4, v < 2e-3). The counter-based pair RNG
depends only on (tags, step, seed), so the trajectory does not depend on
the decomposition. The reference is the JAX dense path (every pair, no
cells), jitted; the start is JAX's ``create_random`` and dense ``setup``,
carried across by the bridge.

Cases, all run by one start of the four ranks (``launch.slab_runs``): the
classic fluid on spill buckets through K4 (``halo_forces_pallas_fused``)
with ``dd_overlap`` on (the border/inner split) and off (one call over
the extended slab), and on strict buckets through K6-halo
(``halo_forces_pallas_1d``). The eDPD, tDPD and polymer cases are in
tests/test_torch_dd_slice_models.py. The ranks run the kernels' plain
versions here; chip_smoke.py runs the same path on the card."""

import jax
import numpy as np
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.core.system import System as JSystem
from meso_tpu.core.system import SystemParams as JSystemParams
from meso_tpu.core.system import make_step as j_make_step
from meso_tpu.core.system import setup as j_setup
from meso_tpu.ops.dpd import DPDParams as JDPDParams
from meso_tpu_torch import bridge
from meso_tpu_torch.parallel import (build_domain, collect_state,
                                     distribute_state, launch)
from test_torch_imports import one_torch_thread  # noqa: F401

N_DEV, CHUNKS, EVERY = 4, 3, 5
SIDE, RC, SKIN, DENSITY = 1.2, 1.0, 0.2, 3.0
SPAWN_TIMEOUT_S = 120.0


def skinny_box(cols_per_dev):
    """Box lengths of a slab-decomposable fluid: ``cols_per_dev`` cell
    columns of side 1.2 per rank along x, 4 cells across."""
    return N_DEV * cols_per_dev * SIDE, 4 * SIDE, 4 * SIDE


def jax_setup(system, params, state):
    """JAX's ``setup`` on the dense path, jitted (eager, it compiles each
    operation on its own)."""
    dense = system.replace(force_path="dense")
    return jax.jit(lambda p, s: j_setup(dense, p, s))(params, state)


def jax_reference(system, params, state, steps):
    """``steps`` steps of the JAX dense path from ``state``, by tag."""
    step = jax.jit(j_make_step(system.replace(force_path="dense")))
    for _ in range(steps):
        state = step(params, state)
    return by_tag({f: getattr(state, f) for f in ("x", "v", "mask", "tag",
                                                  "T", "C")})


def by_tag(fields, names=("x", "v", "T", "C")):
    """The named per-row fields of the valid rows, in tag order."""
    mask = np.asarray(fields["mask"])
    order = np.argsort(np.asarray(fields["tag"])[mask])
    return {f: np.asarray(fields[f])[mask][order] for f in names
            if fields.get(f) is not None}


def port_job(jsystem, jparams, jstate, lx, strict_k=0, every=EVERY,
             chunks=CHUNKS, **system_kw):
    """The slab job of the port: the JAX system, parameters and start
    carried across, distributed over N_DEV ranks on the CPU, ``chunks``
    chunks of ``every`` steps; with ``strict_k``, on strict buckets of that
    capacity."""
    system = bridge.system_from(jsystem).replace(**system_kw)
    if strict_k:
        system = system.replace(cells=system.cells.replace(
            spill=False, capacity=strict_k))
    state = bridge.state_from(jstate)
    dcfg = build_domain(system, N_DEV, lx_global=lx, rebuild_every=every)
    return dict(system=system, params=bridge.system_params_from(jparams),
                states=distribute_state(state, dcfg, device="cpu"),
                dcfg=dcfg, nchunks=chunks)


def run_jobs(tmp_path, jobs):
    """Every job on one start of N_DEV gloo ranks; per job, (the ranks'
    diags of the run, the collected state by tag, the valid rows)."""
    results = launch.spawn(launch.slab_runs, N_DEV, tmp_path, args=(jobs,),
                           device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    out = []
    for j in range(len(jobs)):
        ranks = [r[j] for r in results]
        final = collect_state([r["state"] for r in ranks])
        fields = {f: getattr(final, f) for f in ("x", "v", "mask", "tag",
                                                 "T", "C")}
        fields = {f: None if t is None else t.numpy()
                  for f, t in fields.items()}
        out.append(([r["diag"] for r in ranks], by_tag(fields),
                    fields["tag"][fields["mask"]]))
    return out


def assert_matches(diags, got, tags, want, n):
    """Overflow 0 on every rank, N conserved and tags unique, and the
    trajectory by tag within x < 2e-4, v < 2e-3 (and T or C, where present,
    within 2e-4 of max(1, |field|))."""
    assert all(d["overflow"] == 0 for d in diags)
    assert len(tags) == n and (np.sort(tags) == np.arange(1, n + 1)).all()
    assert np.abs(got["x"] - want["x"]).max() < 2e-4
    assert np.abs(got["v"] - want["v"]).max() < 2e-3
    for f in ("T", "C"):
        if f in want:
            scale = max(1.0, np.abs(want[f]).max())
            assert np.abs(got[f] - want[f]).max() / scale < 2e-4


@pytest.fixture(scope="module")
def classic(tmp_path_factory):
    lx, ly, lz = skinny_box(5)
    n = int(round(DENSITY * lx * ly * lz))
    box = JBox.orthorhombic(lx, ly, lz)
    state = j_create_random(jax.random.PRNGKey(0), n, box, kt=1.0)
    params = JSystemParams.build(JDPDParams.build(
        a=25.0, gamma=4.5, rc=RC, kt=1.0, seed=928459))
    system = JSystem.for_fluid([lx, ly, lz], rc=RC, density=DENSITY, dt=0.01,
                               skin=SKIN, rng_mode="fast",
                               rebuild_every=EVERY, spill=True)
    state = jax_setup(system, params, state)
    want = jax_reference(system, params, state, CHUNKS * EVERY)
    jobs = [port_job(system, params, state, lx, force_path="pallas",
                     dd_overlap=True),
            port_job(system, params, state, lx, force_path="pallas",
                     dd_overlap=False),
            port_job(system, params, state, lx, strict_k=20,
                     force_path="pallas_banded")]
    names = ("fused-spill-overlap", "fused-spill-one-call", "banded-strict")
    got = run_jobs(tmp_path_factory.mktemp("dd_classic"), jobs)
    return n, want, dict(zip(names, got))


@pytest.mark.parametrize("case", ["fused-spill-overlap",
                                  "fused-spill-one-call", "banded-strict"])
def test_classic_4_ranks_match_jax_single_card(classic, case):
    n, want, got = classic
    assert_matches(*got[case], want, n)
