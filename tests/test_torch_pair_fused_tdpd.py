"""The port's fused tDPD selector (K5, ``pair_kernel="v2"``) against the
JAX package's ``bucket_forces_pallas_tdpd_fused`` run in interpret mode, on
the same bucket rows (made with numpy from a seed and placed by the port:
``test_torch_pair_fused.bucket_rows``).

Cases: three species with two types (asymmetric a, rc_01 = 0.8; rcc 0.8,
s1 2; strict buckets, TEA) and ten species, more than one register block
of the kernel (one type, spill, fast RNG); and R8: s_exp != 1 is refused.

Bounds are the port's transport tests' (tests/test_torch_transport_pair.py):
max relative error of f 2e-5, of dC/dt 5e-5, of the virial 1e-4, pad rows
exactly 0, and per-species sum of dC/dt over max |dC/dt| below 5e-5."""

import jax.numpy as jnp
import numpy as np
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.kernels import pair_dpd_fused as jf
from meso_tpu.ops.tdpd import TDPDParams as JTDPDParams
from meso_tpu_torch import bridge
from meso_tpu_torch.kernels import pair_dpd_fused as tf
from test_torch_pair_fused import assert_transport_match, bucket_rows, jax_rows
from test_torch_imports import one_torch_thread  # noqa: F401


def _params(n_types, ns):
    kw = (dict(a=[[25.0, 35.0], [30.0, 40.0]], rc=[[1.0, 0.8], [0.8, 1.0]])
          if n_types == 2 else dict(a=25.0, rc=1.0))
    return JTDPDParams.build(gamma=4.5, kt=1.0, n_types=n_types,
                             kappa_c=list(np.linspace(0.5, 1.5, ns)),
                             eps_c=list(np.linspace(0.05, 0.2, ns)),
                             rcc=0.8, s1=2.0, seed=5, **kw)


@pytest.mark.parametrize("spill,rng_mode,n_types,ns", [
    (False, "tea", 2, 3), (True, "fast", 1, 10)],
    ids=["strict-tea-2types-S3", "spill-fast-1type-S10"])
def test_tdpd_fused_plain_matches_jax_interpret(spill, rng_mode, n_types,
                                                ns):
    bst, cfg, jcfg = bucket_rows(spill, 4, ns=ns)
    jp = _params(n_types, ns)
    want = jf.bucket_forces_pallas_tdpd_fused(
        *jax_rows(bst, "x", "v", "C", "typ", "tag", "mask"),
        JBox.cubic(float(bst.box.lengths[0])), jnp.int32(4), jp, 0.01, jcfg,
        rng_mode=rng_mode, interpret=True)
    got = tf.bucket_forces_pallas_tdpd_fused(
        bst.x, bst.v, bst.C, bst.typ, bst.tag, bst.mask, bst.box, 4,
        bridge.tdpd_params_from(jp), 0.01, cfg, rng_mode=rng_mode)
    assert_transport_match(bst, got, want)


def test_tdpd_fused_refuses_s_exp():
    """R8: every JAX tDPD kernel takes s_exp = 1 whatever the parameters
    say, while its dense oracle applies them; the port refuses."""
    bst, cfg, _ = bucket_rows(True, 4, ns=1)
    params = bridge.tdpd_params_from(_params(1, 1)).replace(s_exp=0.5)
    with pytest.raises(ValueError, match="R8"):
        tf.bucket_forces_pallas_tdpd_fused(
            bst.x, bst.v, bst.C, bst.typ, bst.tag, bst.mask, bst.box, 4,
            params, 0.01, cfg)
