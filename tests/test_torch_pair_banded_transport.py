"""The port's banded eDPD and tDPD selectors (K7,
``force_path="pallas_banded"``) against the JAX package's
``meso_tpu.kernels.pair_multiphysics.bucket_forces_pallas_edpd`` and
``_tdpd`` run in interpret mode, on the same strict bucket rows (made with
numpy from a seed, placed by the port's ``to_bucket_state``, moved by
<= skin/2 and box-wrapped: ``test_torch_pair_fused.bucket_rows``): eDPD
with two types (asymmetric a and kappa tables, rc_01 = 0.8; fast RNG) and
tDPD with ten species and two types (rcc 0.8, s1 2; TEA). The port's entry points run their plain torch
versions here (CPU tensors); chip_smoke.py holds the CUDA kernel against
them on the card.

Bounds are the port's transport tests' (tests/test_torch_transport_pair.py):
max relative error of f 2e-5, of dT/dt and dC/dt 5e-5, of the virial 1e-4,
pad rows exactly 0, and per-species sum of dC/dt over max |dC/dt| below
5e-5."""

import jax.numpy as jnp
import numpy as np
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.kernels import pair_multiphysics as jm
from meso_tpu.ops.edpd import EDPDParams as JEDPDParams
from meso_tpu.ops.tdpd import TDPDParams as JTDPDParams
from meso_tpu_torch import bridge
from meso_tpu_torch.kernels import pair_multiphysics as tm
from test_torch_pair_fused import assert_transport_match, bucket_rows, jax_rows
from test_torch_imports import one_torch_thread  # noqa: F401

NS = 10
TWO = dict(a=[[25.0, 35.0], [30.0, 40.0]], rc=[[1.0, 0.8], [0.8, 1.0]],
           n_types=2, gamma=4.5)


@pytest.mark.parametrize("model,rng_mode", [("edpd", "fast"),
                                            ("tdpd", "tea")])
def test_banded_transport_plain_matches_jax_interpret(model, rng_mode):
    bst, cfg, jcfg = bucket_rows(False, 6, t=True, ns=NS)
    field = "T" if model == "edpd" else "C"
    if model == "edpd":
        jp = JEDPDParams.build(kappa=[[1.5, 1.0], [1.2, 0.5]], cv=10.0,
                               seed=7, **TWO)
        tp, jfn, tfn = (bridge.edpd_params_from(jp),
                        jm.bucket_forces_pallas_edpd,
                        tm.bucket_forces_pallas_edpd)
    else:
        jp = JTDPDParams.build(kt=1.0, kappa_c=list(np.linspace(0.5, 1.5, NS)),
                               eps_c=list(np.linspace(0.05, 0.2, NS)),
                               rcc=0.8, s1=2.0, seed=5, **TWO)
        tp, jfn, tfn = (bridge.tdpd_params_from(jp),
                        jm.bucket_forces_pallas_tdpd,
                        tm.bucket_forces_pallas_tdpd)
    want = jfn(*jax_rows(bst, "x", "v", field, "typ", "tag", "mask"),
               JBox.cubic(float(bst.box.lengths[0])), jnp.int32(4), jp, 0.01,
               jcfg, rng_mode=rng_mode, interpret=True)
    got = tfn(bst.x, bst.v, getattr(bst, field), bst.typ, bst.tag, bst.mask,
              bst.box, 4, tp, 0.01, cfg, rng_mode=rng_mode)
    assert_transport_match(bst, got, want)
