"""K2 and K3's remaining cases in the port: per-type-pair tables (two
types, asymmetric a, gamma and kappa tables, rc_01 = 0.8) and, for tDPD,
ten species (more than one register block of the kernel), against the JAX
package's dense O(N^2) oracles on the same rows.

The rows are made with numpy from a seed and placed in bucket rows by the
port's ``to_bucket_state``; they move by <= skin/2 and are box-wrapped
(min-image layout) or left unwrapped (no-min-image layout,
``wrap_at_rebuild``). ``bucket_forces_pallas_v3_edpd``/``_tdpd`` run their
plain torch versions here (CPU tensors); chip_smoke.py holds the CUDA
kernels against those on the card. Bounds are the JAX transport kernel
tests' (tests/unit/test_pallas_v3_transport.py:49-125, as in
tests/test_torch_transport_pair.py): max relative error of f 2e-5 (5e-5
without min-image), of dT/dt and dC/dt 5e-5, of the virial 1e-4 (1e-3
without min-image), pad rows exactly 0, and per-species sum of dC/dt over
max |dC/dt| below 5e-5."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from meso_tpu.core.box import Box as JBox
from meso_tpu.ops.edpd import EDPDParams as JEDPDParams
from meso_tpu.ops.edpd import dense_forces_edpd as j_dense_edpd
from meso_tpu.ops.tdpd import TDPDParams as JTDPDParams
from meso_tpu.ops.tdpd import dense_forces_tdpd as j_dense_tdpd
from meso_tpu_torch import bridge
from meso_tpu_torch.kernels.pair_dpd_v3 import (bucket_forces_pallas_v3_edpd,
                                                bucket_forces_pallas_v3_tdpd)
from meso_tpu_torch.neighbor.bucket_layout import to_bucket_state
from meso_tpu_torch.neighbor.cells import CellConfig
from test_torch_imports import one_torch_thread  # noqa: F401

SKIN = 0.3
NS = 10
TWO = dict(a=[[25.0, 35.0], [30.0, 40.0]], gamma=[[4.5, 6.0], [3.0, 4.5]],
           rc=[[1.0, 0.8], [0.8, 1.0]], n_types=2)
J_EDPD = JEDPDParams.build(kappa=[[1.5, 1.0], [1.2, 0.5]], cv=10.0, seed=7,
                           **TWO)
J_TDPD = JTDPDParams.build(kt=1.0, kappa_c=list(np.linspace(0.5, 1.5, NS)),
                           eps_c=list(np.linspace(0.05, 0.2, NS)), rcc=0.8,
                           s1=2.0, seed=5, **TWO)


@functools.lru_cache(maxsize=None)
def _bucket_rows(spill, min_image, seed=8):
    """Port bucket rows (n=824 at l=6.5 with spill, n=648 at l=6 strict),
    types alternating by tag, T = 1 + 0.3 sin x and ten species."""
    n, l = (824, 6.5) if spill else (648, 6.0)
    rs = np.random.RandomState(seed)
    x = rs.uniform(0.0, l, (n, 3)).astype(np.float32)
    tag = np.arange(1, n + 1, dtype=np.int32)
    src = dict(x=x, v=rs.normal(0.0, 1.0, (n, 3)).astype(np.float32),
               f=np.zeros((n, 3), np.float32), typ=tag % 2, tag=tag,
               image=np.zeros((n, 3), np.int32), mask=np.ones(n, bool),
               mol=np.zeros(n, np.int32), T=1.0 + 0.3 * np.sin(x[:, 0]),
               C=np.stack([1.0 + 0.1 * s + 0.5 * np.cos(x[:, 0] + s)
                           for s in range(NS)], -1),
               lo=np.zeros(3, np.float32), hi=np.full(3, l, np.float32),
               step=0)
    cfg = CellConfig.for_box([l] * 3, 1.0, n / l ** 3, skin=SKIN,
                             spill=spill, wrap_at_rebuild=not min_image)
    bst = to_bucket_state(bridge.state_from(src), cfg)
    x = bst.x + (0.04 * bst.v).clamp(-SKIN / 2, SKIN / 2) * bst.mask[:, None]
    if min_image:
        x = bst.box.wrap(x)[0]
    return bst.replace(x=x), cfg


@pytest.mark.parametrize("model,spill,min_image,rng_mode", [
    ("edpd", True, True, "fast"), ("edpd", False, False, "tea"),
    ("tdpd", True, True, "tea"), ("tdpd", False, False, "fast")],
    ids=["edpd-spill-minimage-fast", "edpd-strict-nominimage-tea",
         "tdpd-spill-minimage-tea", "tdpd-strict-nominimage-fast"])
def test_multitype_plain_matches_jax_dense(model, spill, min_image,
                                           rng_mode):
    bst, cfg = _bucket_rows(spill, min_image)
    field, jp, jfn, tfn, conv = {
        "edpd": ("T", J_EDPD, j_dense_edpd, bucket_forces_pallas_v3_edpd,
                 bridge.edpd_params_from),
        "tdpd": ("C", J_TDPD, j_dense_tdpd, bucket_forces_pallas_v3_tdpd,
                 bridge.tdpd_params_from)}[model]
    f_t, q_t, vir_t = tfn(bst.x, bst.v, getattr(bst, field), bst.typ,
                          bst.tag, bst.mask, bst.box, 12, conv(jp), 0.01,
                          cfg, rng_mode=rng_mode)
    m = bst.mask.numpy()
    idx = np.flatnonzero(m)
    rows = [jnp.asarray(getattr(bst, n).numpy()[idx])
            for n in ("x", "v", field, "typ", "tag", "mask")]
    f_d, q_d, vir_d = jfn(*rows, JBox.cubic(float(bst.box.lengths[0])),
                          jnp.int32(12), jp, 0.01, rng_mode=rng_mode)
    fp, qp = f_t.numpy(), q_t.numpy()
    f_d, q_d = np.asarray(f_d), np.asarray(q_d)
    assert np.isfinite(fp).all() and np.isfinite(qp).all()
    assert np.abs(fp[idx] - f_d).max() / np.abs(f_d).max() < (
        2e-5 if min_image else 5e-5)
    q_scale = np.abs(q_d).max()
    assert np.abs(qp[idx] - q_d).max() / q_scale < 5e-5
    assert (~m).any() and np.abs(fp[~m]).max() == 0.0
    assert np.abs(qp[~m]).max() == 0.0
    assert abs(float(vir_t) - float(vir_d)) / abs(float(vir_d)) < (
        1e-4 if min_image else 1e-3)
    if model == "tdpd":
        assert q_t.shape[1] == NS
        assert np.abs(qp[m].sum(0)).max() / q_scale < 5e-5


def test_multitype_needs_typ():
    bst, cfg = _bucket_rows(True, True)
    with pytest.raises(ValueError, match="typ"):
        bucket_forces_pallas_v3_edpd(bst.x, bst.v, bst.T, None, bst.tag,
                                     bst.mask, bst.box, 12,
                                     bridge.edpd_params_from(J_EDPD), 0.01,
                                     cfg)
