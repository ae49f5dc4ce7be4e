"""R9 (ROADMAP Queue 3): with more than one type and rcc above the
smallest rc_ij, the JAX package's tDPD kernels and its dense oracle give
different fluxes, and the port refuses that case on every tDPD kernel
route.

The JAX kernels (``_v3_kernel``, ``_fused_kernel``, the banded
``pair_multiphysics`` kernel) take the flux inside ``ok & (r2 < rcc^2)``,
where ``ok`` is the pair's own cutoff test r2 < rc_ij^2; ``dense_forces_tdpd``
takes it inside r < rcc alone. With rc_01 = 0.8 and rcc = 1.0 the pairs of
unlike types at 0.8 <= r < 1 exchange species in the oracle and not in the
kernels. The first test measures that on the rows of
tests/test_torch_pair_fused_tdpd.py (strict, two types, three species,
TEA), the JAX kernels in interpret mode against the oracle: the fused
kernel's dC/dt within 5e-5 of max |dC/dt| (the transport tests' bound) at
rcc = min rc_ij = 0.8, and the fused and banded kernels' more than 0.1 of
it apart at rcc = 1.0. (``_v3_kernel`` gates the flux the same way,
``pair_dpd_v3.py:228,299``; its interpreted graph takes minutes to compile
here, so it is not run.) The second holds the port's K3, K5
and K7 entry points to a ``ValueError`` naming R9 for rcc = 1.0."""

import jax.numpy as jnp
import numpy as np
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.kernels import pair_dpd_fused as jf
from meso_tpu.kernels import pair_multiphysics as jm
from meso_tpu.ops.tdpd import TDPDParams as JTDPDParams
from meso_tpu.ops.tdpd import dense_forces_tdpd as j_dense_tdpd
from meso_tpu_torch import bridge
from meso_tpu_torch.kernels import pair_dpd_fused, pair_dpd_v3
from meso_tpu_torch.kernels import pair_multiphysics
from test_torch_pair_fused import bucket_rows, jax_rows
from test_torch_imports import one_torch_thread  # noqa: F401

NS = 3


def _params(rcc):
    """Two types with rc_01 = 0.8 (asymmetric a), three species."""
    return JTDPDParams.build(a=[[25.0, 35.0], [30.0, 40.0]],
                             rc=[[1.0, 0.8], [0.8, 1.0]], gamma=4.5, kt=1.0,
                             n_types=2, kappa_c=list(np.linspace(0.5, 1.5, NS)),
                             eps_c=list(np.linspace(0.05, 0.2, NS)), rcc=rcc,
                             s1=2.0, seed=5)


@pytest.mark.parametrize("kernel,rcc,agree", [
    ("K5", 0.8, True), ("K5", 1.0, False), ("K7", 1.0, False)],
    ids=["K5-rcc-min-rc", "K5-rcc-above-rc01", "K7-rcc-above-rc01"])
def test_r9_jax_kernel_and_dense_oracle(kernel, rcc, agree):
    bst, _, jcfg = bucket_rows(False, 4, ns=NS)
    jp = _params(rcc)
    box = JBox.cubic(float(bst.box.lengths[0]))
    names = ("x", "v", "C", "typ", "tag", "mask")
    fn = {"K5": jf.bucket_forces_pallas_tdpd_fused,
          "K7": jm.bucket_forces_pallas_tdpd}[kernel]
    _, q_k, _ = fn(*jax_rows(bst, *names), box, jnp.int32(4), jp, 0.01, jcfg,
                   rng_mode="tea", interpret=True)
    idx = np.flatnonzero(bst.mask.numpy())
    rows = [jnp.asarray(getattr(bst, n).numpy()[idx]) for n in names]
    _, q_d, _ = j_dense_tdpd(*rows, box, jnp.int32(4), jp, 0.01,
                             rng_mode="tea")
    q_d = np.asarray(q_d)
    rel = np.abs(np.asarray(q_k)[idx] - q_d).max() / np.abs(q_d).max()
    assert rel < 5e-5 if agree else rel > 0.1


@pytest.mark.parametrize("route", ["K3", "K5", "K7"])
def test_tdpd_refuses_rcc_above_rc_ij(route):
    bst, cfg, _ = bucket_rows(False, 4, ns=NS)
    fn = {"K3": pair_dpd_v3.bucket_forces_pallas_v3_tdpd,
          "K5": pair_dpd_fused.bucket_forces_pallas_tdpd_fused,
          "K7": pair_multiphysics.bucket_forces_pallas_tdpd}[route]
    with pytest.raises(ValueError, match="R9"):
        fn(bst.x, bst.v, bst.C, bst.typ, bst.tag, bst.mask, bst.box, 4,
           bridge.tdpd_params_from(_params(1.0)), 0.01, cfg)
