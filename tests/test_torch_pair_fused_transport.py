"""The port's fused eDPD selector (K5, ``pair_kernel="v2"``) against the
JAX package's ``bucket_forces_pallas_edpd_fused`` run in interpret mode, on
the same bucket rows.

The inputs are made with numpy from a seed (uniform positions, normal
velocities, types alternating by tag, T = 1 + 0.3 sin x), placed in bucket
rows by the port's ``to_bucket_state`` (bitwise JAX's placement,
tests/test_torch_bucket_layout.py), moved by <= skin/2 and box-wrapped, so
rows that crossed the boundary sit in their old cells; both packages get
those same rows (``test_torch_pair_fused.bucket_rows``). The port's entry point runs its plain torch version here
(CPU tensors); chip_smoke.py holds the CUDA kernel against it on the card.
Cases: two types (asymmetric a and kappa tables, rc_01 = 0.8) with spill
buckets and the fast RNG, and one type with strict buckets and TEA. The
tDPD cases are in tests/test_torch_pair_fused_tdpd.py (each file stays
under 20 s).

Bounds are the port's transport tests' (tests/test_torch_transport_pair.py,
from tests/unit/test_pallas_v3_transport.py:49-125): max relative error of
f 2e-5, of dT/dt 5e-5, of the virial 1e-4, pad rows exactly 0."""

import jax.numpy as jnp
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.kernels import pair_dpd_fused as jf
from meso_tpu.ops.edpd import EDPDParams as JEDPDParams
from meso_tpu_torch import bridge
from meso_tpu_torch.kernels import pair_dpd_fused as tf
from test_torch_pair_fused import assert_transport_match, bucket_rows, jax_rows
from test_torch_imports import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("spill,rng_mode,n_types", [
    (True, "fast", 2), (False, "tea", 1)],
    ids=["spill-fast-2types", "strict-tea-1type"])
def test_edpd_fused_plain_matches_jax_interpret(spill, rng_mode, n_types):
    bst, cfg, jcfg = bucket_rows(spill, 9, t=True)
    kw = (dict(a=[[25.0, 35.0], [30.0, 40.0]], rc=[[1.0, 0.8], [0.8, 1.0]],
               kappa=[[1.5, 1.0], [1.2, 0.5]]) if n_types == 2
          else dict(a=25.0, rc=1.0, kappa=1.5))
    jp = JEDPDParams.build(gamma=4.5, cv=10.0, seed=7, n_types=n_types, **kw)
    want = jf.bucket_forces_pallas_edpd_fused(
        *jax_rows(bst, "x", "v", "T", "typ", "tag", "mask"),
        JBox.cubic(float(bst.box.lengths[0])), jnp.int32(12), jp, 0.01, jcfg,
        rng_mode=rng_mode, interpret=True)
    got = tf.bucket_forces_pallas_edpd_fused(
        bst.x, bst.v, bst.T, bst.typ, bst.tag, bst.mask, bst.box, 12,
        bridge.edpd_params_from(jp), 0.01, cfg, rng_mode=rng_mode)
    assert_transport_match(bst, got, want)
