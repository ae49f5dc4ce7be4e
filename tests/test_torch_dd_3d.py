"""The port's 3-D bricks and its mesh of ranks on 8 gloo ranks on the CPU
(a 2 x 2 x 2 mesh), started once for every case of this file, against the
JAX package's single-card dense path on the same start, by tag, with the
helpers and bounds of tests/test_torch_dd_2d.py:

- the 2 x 2 x 2 mesh: each rank's id shifted along x, y and z, and summed
  and maxed over each axis and over all three;
- classic DPD through K4 (``halo_forces_pallas_fused`` with ext ("x",
  "y", "z")) on spill buckets in a box of 2 x 5 cell columns along x and
  2 x 3 along y and z (tests/dist/test_spill_dist_2d3d.py's box), 3 chunks
  of 5 steps: x < 2e-4, v < 2e-3;
- FENE chains with special bonds at weight 0.5 (R15) through K4,
  migration and rebuild every step: x < 1e-4, v < 1e-3, no bonded term
  missing its partner.
"""

import pytest

from meso_tpu_torch.parallel import launch
from test_torch_dd_2d import (CHUNKS, EVERY, assert_trajectory, brick_job,
                              collected, fluid_case, polymer_case)
from test_torch_dd_slice import jax_reference
from test_torch_imports import one_torch_thread  # noqa: F401

N_RANKS = 8
SPAWN_TIMEOUT_S = 240.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {"classic-k4-spill": fluid_case((10, 6, 6), spill=True, seed=5),
             "polymer-k4": polymer_case((6, 6, 6))}
    wants, jobs = {}, []
    for name, case in cases.items():
        per_step = name == "polymer-k4"
        wants[name] = jax_reference(case[0], case[1], case[2],
                                    CHUNKS * EVERY)
        jobs.append(brick_job(case, (2, 2, 2),
                              every=1 if per_step else EVERY,
                              chunks=CHUNKS * EVERY if per_step else CHUNKS,
                              force_path="pallas"))
    jobs.append((launch.mesh_shifts, ((2, 2, 2), ("x", "y", "z"))))
    results = launch.spawn(launch.slab_runs, N_RANKS,
                           tmp_path_factory.mktemp("dd_3d"), args=(jobs,),
                           device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    got = {name: collected([r[j] for r in results])
           for j, name in enumerate(cases)}
    got["shifts"] = [r[-1] for r in results]
    return wants, got, {name: case[4] for name, case in cases.items()}


def test_mesh_2x2x2_shifts_and_reductions(runs):
    _, got, _ = runs
    for rank, out in enumerate(got["shifts"]):
        c = {"x": rank // 4, "y": (rank // 2) % 2, "z": rank % 2}
        assert out["coords"] == c
        for axis, stride in (("x", 4), ("y", 2), ("z", 1)):
            base = rank - c[axis] * stride
            line = [base, base + stride]
            other = line[1 - c[axis]]
            assert out[axis] == (other, other, sum(line), max(line))
        assert out["all"] == (28, 7)


def test_classic_k4_2x2x2_matches_jax_single_card(runs):
    wants, got, ns = runs
    assert_trajectory(got["classic-k4-spill"], wants["classic-k4-spill"],
                      ns["classic-k4-spill"], 2e-4, 2e-3)


def test_special_bonds_polymer_2x2x2_r15(runs):
    wants, got, ns = runs
    assert_trajectory(got["polymer-k4"], wants["polymer-k4"],
                      ns["polymer-k4"], 1e-4, 1e-3, bonded=True)
