"""The port's replica ensemble and the membrane suspension under the 1-D
decomposition, on 2 gloo ranks on the CPU, started once for both:

- ``run_ensemble``: 2 replicas (tags reseeded) of the classic fluid on
  the main path's settings at L = 6 through K1 (force_path "pallas",
  spill buckets, fast RNG, deferred wrap), 60 steps: replica 0 equals the
  port's single-card chunk loop (``run_bucket_fixed``) on the same start
  bitwise, replica 1's rows decorrelate (max |dx| by tag, the minimum
  image, above 0.1), the
  mean kinetic energy is the replicas' mean on every rank, no overflow;
- BASELINE config 5 (the membrane vesicle in solvent, WLC-POW edges,
  hinges, global and local area and volume) on 2 slabs, the membrane
  scalars summed over the ring, against the JAX package's single-card
  bucket path at the same cadence (as tests/dist/test_bonded_dist.py:
  119-135 holds JAX's): 2 chunks of 3 steps, x < 1e-4, v < 1e-3 by tag,
  no bonded term missing its partner, N conserved.
"""

import numpy as np
import pytest
import torch

from meso_tpu.core.system import run_bucket_chunked as j_run_bucket_chunked
from meso_tpu.models.polymer import membrane_suspension as j_membrane
from meso_tpu_torch import bridge
from meso_tpu_torch.core.system import run_bucket_fixed
from meso_tpu_torch.models.classic import classic_fluid
from meso_tpu_torch.parallel import (build_domain, distribute_state, launch,
                                     replicate_state)
from meso_tpu_torch.parallel.ensemble import ensemble_rank
from test_torch_dd_2d import assert_trajectory, collected, fields_of
from test_torch_dd_slice import by_tag
from test_torch_imports import one_torch_thread  # noqa: F401

N_RANKS = 2
ENSEMBLE_STEPS, EVERY = 60, 3
SPAWN_TIMEOUT_S = 240.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    system, params, state = classic_fluid(
        l=6.0, rng_mode="fast", force_path="pallas", wrap_mode="rebuild",
        rebuild="sort", skin=0.4, rebuild_every=EVERY, device="cpu")
    single, _ = run_bucket_fixed(system, params, state,
                                 ENSEMBLE_STEPS // EVERY, EVERY)
    lx = 6 * 1.3125   # 6 cell columns: 3 a rank
    jsys, jparams, jstate, _ = j_membrane(l=lx, radius=2.5, subdiv=2,
                                          force_path="bucket", skin=0.3,
                                          init_seed=8)
    ref, _ = j_run_bucket_chunked(jsys, jparams, jstate, 2, 3)
    msys = bridge.system_from(jsys)
    dcfg = build_domain(msys, N_RANKS, lx_global=lx, rebuild_every=3)
    jobs = [(ensemble_rank, (system, params, replicate_state(state, 2),
                             ENSEMBLE_STEPS)),
            dict(system=msys, params=bridge.system_params_from(jparams),
                 states=distribute_state(bridge.state_from(jstate), dcfg,
                                         device="cpu"),
                 dcfg=dcfg, nchunks=2)]
    results = launch.spawn(launch.slab_runs, N_RANKS,
                           tmp_path_factory.mktemp("dd_ensemble"),
                           args=(jobs,), device="cpu",
                           timeout_s=SPAWN_TIMEOUT_S)
    want = by_tag({f: np.asarray(getattr(ref, f))
                   for f in ("x", "v", "mask", "tag")})
    n = int(np.asarray(jstate.mask).sum())
    return (single, [r[0] for r in results],
            (collected([r[1] for r in results]), want, n))


def test_replica0_is_the_single_card_run_bitwise(runs):
    single, reps, _ = runs
    got = reps[0]["state"]
    assert got.step == single.step
    for f in ("x", "v", "f", "tag", "mask", "image"):
        assert torch.equal(getattr(got, f), getattr(single, f)), f
    assert all(r["diag"]["bucket_overflow"] == 0 for r in reps)


def test_replica1_decorrelates_and_ke_is_the_mean(runs):
    single, reps, _ = runs
    r0, r1 = (fields_of(r["state"]) for r in reps)
    n = int(r0["mask"].sum())
    assert (np.sort(r1["tag"][r1["mask"]]) == np.arange(1, n + 1) + n).all()
    a, b = by_tag(r0), by_tag(r1)
    d = b["x"] - a["x"]
    assert np.abs(d - 6.0 * np.round(d / 6.0)).max() > 0.1
    kes = [0.5 * float((r["state"].v[r["state"].mask] ** 2).sum())
           for r in reps]
    for r in reps:
        assert r["ke_mean"] == pytest.approx(sum(kes) / 2, rel=1e-5)


def test_membrane_two_ranks_matches_jax_single_card(runs):
    _, _, (got, want, n) = runs
    assert_trajectory(got, want, n, 1e-4, 1e-3, bonded=True)
