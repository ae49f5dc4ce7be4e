"""The port's banded classic selector (K6, ``force_path="pallas_banded"``)
against the JAX package's ``meso_tpu.kernels.pair_dpd.bucket_forces_pallas``
run in interpret mode, on the same strict bucket rows (made with numpy from
a seed, placed by the port's ``to_bucket_state``, moved by <= skin/2 and
box-wrapped). Both RNG tiers, with two types (asymmetric a, rc_01 = 0.8),
s_exp = 0.5 and special-bonds exclusions (E = 2, weight 0.25). And R7: the
TPU kernel has no spill handling and drops pairs under a spill layout, so
the port's K6 and K7 entry points, the system's ``pallas_banded`` path
included, raise ``ValueError`` for a spill ``CellConfig``.

The port's entry point runs its plain torch version here (CPU tensors);
chip_smoke.py holds the CUDA kernel against it on the card. The rows, the
general parameters and the comparison are tests/test_torch_pair_fused.py's. Bounds are the
JAX fused-kernel tests' (tests/unit/test_pallas_fused.py:49-52): max force
error 2e-6 relative to max |f|, pad rows exactly 0, relative virial error
1e-4."""

import jax.numpy as jnp
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.kernels.pair_dpd import bucket_forces_pallas as j_banded
from meso_tpu_torch import bridge
from meso_tpu_torch.core.state import create_random
from meso_tpu_torch.core.system import System, SystemParams, setup
from meso_tpu_torch.kernels import pair_multiphysics
from meso_tpu_torch.kernels.pair_dpd import bucket_forces_pallas
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops.dpd import DPDParams
from meso_tpu_torch.ops.edpd import EDPDParams
from meso_tpu_torch.ops.tdpd import TDPDParams
from test_torch_pair_fused import (assert_classic_match, bucket_rows,
                                   general_params, jax_rows)
from test_torch_imports import one_torch_thread  # noqa: F401

STEP = 42


@pytest.mark.parametrize("rng_mode", ["fast", "tea"])
def test_banded_plain_matches_jax_interpret(rng_mode):
    bst, cfg, jcfg = bucket_rows(False, 3)
    jp = general_params(bst.n_valid().item())
    want = j_banded(*jax_rows(bst, "x", "v", "typ", "tag", "mask"),
                    JBox.cubic(float(bst.box.lengths[0])), jnp.int32(STEP),
                    jp, 0.01, jcfg, rng_mode=rng_mode, interpret=True)
    got = bucket_forces_pallas(
        bst.x, bst.v, bst.typ, bst.tag, bst.mask, bst.box, STEP,
        bridge.dpd_params_from(jp), 0.01, cfg, rng_mode=rng_mode)
    assert_classic_match(bst, got, want)


@pytest.mark.parametrize("model", ["dpd", "edpd", "tdpd"])
def test_banded_refuses_spill_r7(model):
    bst, cfg, _ = bucket_rows(True, 3, t=True, ns=1)
    assert cfg.spill
    args = (bst.typ, bst.tag, bst.mask, bst.box, STEP)
    with pytest.raises(ValueError, match="R7"):
        if model == "dpd":
            bucket_forces_pallas(bst.x, bst.v, *args,
                                 DPDParams.build(a=25.0, gamma=4.5, rc=1.0,
                                                 kt=1.0, seed=1), 0.01, cfg)
        elif model == "edpd":
            pair_multiphysics.bucket_forces_pallas_edpd(
                bst.x, bst.v, bst.T, *args,
                EDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kappa=1.0,
                                 cv=10.0, seed=1), 0.01, cfg)
        else:
            pair_multiphysics.bucket_forces_pallas_tdpd(
                bst.x, bst.v, bst.C, *args,
                TDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                                 kappa_c=[1.0], eps_c=[0.0], rcc=1.0,
                                 seed=1), 0.01, cfg)


def test_banded_system_refuses_spill_r7():
    """Through the entry points: ``setup`` of a pallas_banded system on a
    spill CellConfig raises, where the JAX package runs K6 and drops
    pairs."""
    import torch
    from meso_tpu_torch.core.box import Box
    cfg = CellConfig.for_box([6.5] * 3, 1.0, 3.0, skin=0.3, spill=True)
    system = System(rng_mode="fast", force_path="pallas_banded", cells=cfg)
    params = SystemParams.build(DPDParams.build(a=25.0, gamma=4.5, rc=1.0,
                                                kt=1.0, seed=1))
    state = create_random(torch.Generator().manual_seed(0), 824,
                          Box.cubic(6.5))
    with pytest.raises(ValueError, match="R7"):
        setup(system, params, state)
