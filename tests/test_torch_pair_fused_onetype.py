"""The port's fused classic selector (K5) against the JAX package's
interpreted ``bucket_forces_pallas_fused``, one particle type: spill with
the TEA RNG, and strict with a row whose coordinates wrapped the box while
its bucket is stale (tests/unit/test_pallas_fused.py:87), which only the
minimum image on every axis keeps right. The multi-type, s_exp and
exclusion cases, the rows and the comparison are in
tests/test_torch_pair_fused.py (each file stays under 20 s). Bounds are
the JAX fused-kernel tests' own (tests/unit/test_pallas_fused.py:49-52):
max force error 2e-6 relative to max |f|, pad rows exactly 0, relative
virial error 1e-4."""

import jax.numpy as jnp
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.kernels.pair_dpd_fused import \
    bucket_forces_pallas_fused as j_fused
from meso_tpu.ops.dpd import DPDParams as JDPDParams
from meso_tpu_torch import bridge
from meso_tpu_torch.kernels.pair_dpd_fused import bucket_forces_pallas_fused
from test_torch_pair_fused import assert_classic_match, bucket_rows, jax_rows
from test_torch_imports import one_torch_thread  # noqa: F401

STEP = 7


@pytest.mark.parametrize("spill,rng_mode,wrap_crosser", [
    (True, "tea", False), (False, "fast", True)],
    ids=["spill-tea-onetype", "strict-fast-wrap-crosser"])
def test_fused_onetype_plain_matches_jax_interpret(spill, rng_mode,
                                                   wrap_crosser):
    bst, cfg, jcfg = bucket_rows(spill, 5, n_types=1,
                                 wrap_crosser=wrap_crosser)
    jp = JDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=77)
    want = j_fused(*jax_rows(bst, "x", "v", "typ", "tag", "mask"),
                   JBox.cubic(float(bst.box.lengths[0])), jnp.int32(STEP),
                   jp, 0.01, jcfg, rng_mode=rng_mode, interpret=True)
    got = bucket_forces_pallas_fused(
        bst.x, bst.v, bst.typ, bst.tag, bst.mask, bst.box, STEP,
        bridge.dpd_params_from(jp), 0.01, cfg, rng_mode=rng_mode)
    assert_classic_match(bst, got, want)
