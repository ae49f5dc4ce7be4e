"""The FENE-polymer case of the port's 1-D domain decomposition on 4 gloo
ranks on the CPU: chains with special bonds (weight 0.25) through K4
(``halo_forces_pallas_fused`` with exclusion channels) and the bonded ghost
rows, from the skinny start of tests/dist/test_bonded_dist.py:24-77, by
tag against the JAX package's single-card paths on the same start, with
the bounds of tests/test_torch_dd_slice.py (x < 2e-4, v < 2e-3), no
overflow, N conserved, tags unique and no bonded term missing its partner.

Two cases on one start of the four ranks. 3 chunks of 5 steps, against
JAX's single-card bucket path at the same rebuild cadence
(``run_bucket_chunked`` on the XLA sweep, as
tests/dist/test_bonded_dist.py:88-99 compares): the random chains' start
moves rows up to 0.32 within a chunk, beyond skin/2 = 0.1, so the cell
method misses pairs that a dense path keeps, and the JAX bucket path at
that cadence misses the same ones. And 15 chunks of 1 step (migration and
rebuild every step, rows moving at most 0.07 a chunk) against the JAX
dense path, where every pair is in reach."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.rng import maxwell_velocities as j_maxwell
from meso_tpu.core.state import zeros_state as j_zeros_state
from meso_tpu.core.system import System as JSystem
from meso_tpu.core.system import SystemParams as JSystemParams
from meso_tpu.core.system import run_bucket_chunked as j_run_bucket_chunked
from meso_tpu.neighbor.bucket_layout import \
    to_bucket_state as j_to_bucket_state
from meso_tpu.ops.bonded import BondedParams as JBondedParams
from meso_tpu.ops.dpd import DPDParams as JDPDParams
from meso_tpu.ops.dpd import build_exclusions as j_build_exclusions
from test_torch_dd_slice import (CHUNKS, DENSITY, EVERY, RC, SKIN,
                                 assert_matches, by_tag, jax_reference,
                                 jax_setup, port_job, run_jobs, skinny_box)
from test_torch_imports import one_torch_thread  # noqa: F401


def polymer_case(special_weight=0.25):
    """Six FENE chains of 10 beads in solvent (the skinny start of
    tests/dist/test_bonded_dist.py), exclusions along the bonds."""
    lx, ly, lz = skinny_box(3)
    n = int(round(DENSITY * lx * ly * lz))
    rs = np.random.RandomState(11)
    n_chains, chain_len = 6, 10
    chains = []
    for _ in range(n_chains):
        pos = [np.array([rs.uniform(0, lx), rs.uniform(0, ly),
                         rs.uniform(0, lz)])]
        for _ in range(chain_len - 1):
            d = rs.normal(size=3)
            pos.append(pos[-1] + d * 0.8 / np.linalg.norm(d))
        chains.append(np.asarray(pos) % [lx, ly, lz])
    x_poly = np.concatenate(chains)
    x_solv = rs.uniform(0, 1, (n - len(x_poly), 3)) * [lx, ly, lz]
    box = JBox.orthorhombic(lx, ly, lz)
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
    system = JSystem.for_fluid([lx, ly, lz], rc=RC, density=DENSITY,
                               dt=0.01, skin=SKIN, rng_mode="fast",
                               rebuild_every=EVERY)
    system = system.replace(bond_style="fene", n_tags=n)
    return system, params, jax_setup(system, params, st), lx, n


@pytest.fixture(scope="module")
def polymer(tmp_path_factory):
    system, params, state, lx, n = polymer_case()
    bucket = system.replace(force_path="bucket")
    ref, _ = j_run_bucket_chunked(bucket, params,
                                  j_to_bucket_state(state, bucket.cells),
                                  CHUNKS, EVERY)
    wants = {"cadence-5-vs-bucket": by_tag(
                 {f: getattr(ref, f) for f in ("x", "v", "mask", "tag")}),
             "every-step-vs-dense": jax_reference(system, params, state,
                                                  CHUNKS * EVERY)}
    jobs = [port_job(system, params, state, lx, force_path="pallas"),
            port_job(system, params, state, lx, every=1,
                     chunks=CHUNKS * EVERY, force_path="pallas")]
    got = run_jobs(tmp_path_factory.mktemp("dd_polymer"), jobs)
    return n, wants, dict(zip(wants, got))


@pytest.mark.parametrize("case", ["cadence-5-vs-bucket",
                                  "every-step-vs-dense"])
def test_polymer_4_ranks_match_jax_single_card(polymer, case):
    n, wants, got = polymer
    assert_matches(*got[case], wants[case], n)
    assert all(d["bonded_missing"] == 0 for d in got[case][0])
