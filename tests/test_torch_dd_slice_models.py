"""The eDPD and tDPD cases of the port's 1-D domain decomposition on 4
gloo ranks on the CPU, against the JAX package's single-card dense path on
the same start, by tag, with the bounds and helpers of
tests/test_torch_dd_slice.py (x < 2e-4, v < 2e-3, and T or C within 2e-4
of max(1, |field|), the same proportion to x's bound as in JAX's
tests/dist/test_pallas_dist_r3.py:126-142).

Cases, on one start of the four ranks: eDPD on spill buckets and tDPD on
strict ones through K4's model form (``halo_forces_pallas_model_fused``),
with the starts of tests/dist/test_pallas_dist_r3.py:90-122 (a sine
profile of T; a step of C, with the random flux on). The polymer case is
in tests/test_torch_dd_slice_polymer.py."""

import jax
import jax.numpy as jnp
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.core.state import zeros_state as j_zeros_state
from meso_tpu.core.system import System as JSystem
from meso_tpu.core.system import SystemParams as JSystemParams
from meso_tpu.ops.edpd import EDPDParams as JEDPDParams
from meso_tpu.ops.tdpd import TDPDParams as JTDPDParams
from test_torch_dd_slice import (CHUNKS, DENSITY, EVERY, RC, SKIN,
                                 assert_matches, jax_reference, jax_setup,
                                 port_job, run_jobs, skinny_box)
from test_torch_imports import one_torch_thread  # noqa: F401


def transport_case(model, spill):
    """eDPD (kappa 0.5, cv 100, T = 1 + 0.2 sin 2 pi x / Lx) or tDPD (one
    species, kappa_c 0.5, eps_c 0.05, rcc = rc, C = 1 on the left half):
    (system, params, start after the dense setup, Lx, N)."""
    lx, ly, lz = skinny_box(5 if spill else 3)
    n = int(round(DENSITY * lx * ly * lz))
    box = JBox.orthorhombic(lx, ly, lz)
    st = j_create_random(jax.random.PRNGKey(9), n, box, kt=1.0)
    base = j_zeros_state(n, box, with_energy=model == "edpd",
                         n_species=1 if model == "tdpd" else 0)
    st = base.replace(x=st.x, v=st.v, tag=st.tag, typ=st.typ,
                      mask=jnp.ones(n, bool))
    if model == "edpd":
        pair = JEDPDParams.build(a=25.0, gamma=4.5, rc=RC, seed=3,
                                 kappa=0.5, cv=100.0)
        st = st.replace(T=1.0 + 0.2 * jnp.sin(2 * jnp.pi * st.x[:, 0] / lx))
    else:
        pair = JTDPDParams.build(a=25.0, gamma=4.5, rc=RC, kt=1.0, seed=3,
                                 kappa_c=[0.5], eps_c=[0.05], rcc=RC)
        st = st.replace(C=(st.x[:, :1] < lx / 2).astype(jnp.float32))
    params = JSystemParams.build_raw(pair)
    system = JSystem.for_fluid([lx, ly, lz], rc=RC, density=DENSITY,
                               dt=0.01, skin=SKIN, rng_mode="fast",
                               rebuild_every=EVERY, spill=spill)
    system = system.replace(model=model)
    return system, params, jax_setup(system, params, st), lx, n


CASES = {"edpd-spill": lambda: transport_case("edpd", True),
         "tdpd-strict": lambda: transport_case("tdpd", False)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    wants, jobs, ns = {}, [], {}
    for name, build in CASES.items():
        system, params, state, lx, n = build()
        wants[name] = jax_reference(system, params, state, CHUNKS * EVERY)
        ns[name] = n
        jobs.append(port_job(system, params, state, lx,
                             force_path="pallas"))
    got = run_jobs(tmp_path_factory.mktemp("dd_models"), jobs)
    return wants, ns, dict(zip(CASES, got))


@pytest.mark.parametrize("case", list(CASES))
def test_models_4_ranks_match_jax_single_card(models, case):
    wants, ns, got = models
    assert_matches(*got[case], wants[case], ns[case])
