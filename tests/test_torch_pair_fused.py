"""The port's fused classic selector (K5, ``pair_kernel="v2"``) against the
JAX package's ``bucket_forces_pallas_fused`` run in interpret mode, on the
same bucket rows: made with numpy from a seed, placed by the port.

``meso_tpu_torch.kernels.pair_dpd_fused.bucket_forces_pallas_fused`` runs
its plain torch version here (CPU tensors); chip_smoke.py holds the CUDA
kernel against that plain version on the card. Cases here: fast and TEA
RNG, strict and spill buckets, each with two types (an asymmetric a table
and rc_01 = 0.8), s_exp = 0.5 and special-bonds exclusions (E = 2, weight
0.25); the one-type cases and the mid-window wrap-crosser are in
tests/test_torch_pair_fused_onetype.py (each file stays under 20 s). Rows
moved since the rebuild and were box-wrapped, so rows that crossed the
boundary sit in their old cells. The rows, the general parameters and the
comparisons here are shared by the kernel tests of the fused and banded
selectors (tests/test_torch_pair_{fused_*,banded*}.py,
tests/test_torch_tdpd_r9.py).

Bounds are the JAX fused-kernel tests' own
(tests/unit/test_pallas_fused.py:49-52): max force error 2e-6 relative to
max |f|, pad rows exactly 0, relative virial error 1e-4."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.box import Box as JBox
from meso_tpu.kernels.pair_dpd_fused import \
    bucket_forces_pallas_fused as j_fused
from meso_tpu.neighbor.cells import CellConfig as JCellConfig
from meso_tpu.ops.dpd import DPDParams as JDPDParams
from meso_tpu.ops.dpd import build_exclusions as j_build_exclusions
from meso_tpu_torch import bridge
from meso_tpu_torch.kernels.pair_dpd_fused import bucket_forces_pallas_fused
from meso_tpu_torch.neighbor.bucket_layout import to_bucket_state
from meso_tpu_torch.neighbor.cells import CellConfig
from test_torch_imports import one_torch_thread  # noqa: F401

STEP = 42
SKIN = 0.3


def _chains(n, chain_len=8, seed=0):
    """Bonds along random chains of tags 1..n: at most two per tag."""
    perm = np.random.RandomState(seed).permutation(n) + 1
    return np.asarray([(perm[i], perm[i + 1]) for i in range(n - 1)
                       if (i + 1) % chain_len], np.int32)


@functools.lru_cache(maxsize=None)
def bucket_rows(spill, seed, n_types=2, t=False, ns=0, wrap_crosser=False):
    """Port bucket rows and the JAX CellConfig of the same grid (n=824 at
    l=6.5 with spill, 5^3 cells; n=648 at l=6 strict, 4^3 cells), made with
    numpy from a seed: types tag % n_types; with ``t`` T = 1 + 0.3 sin x;
    with ``ns`` species C_s = 1 + 0.1 s + 0.5 cos(x + s). Placed by the
    port's ``to_bucket_state`` (bitwise JAX's placement), then moved by
    <= skin/2 and box-wrapped, so rows that crossed the boundary sit in
    their old cells; with ``wrap_crosser`` one row's x is moved by a box
    length as well. The kernel tests of the fused and banded selectors
    share these rows."""
    n, l = (824, 6.5) if spill else (648, 6.0)
    rs = np.random.RandomState(seed)
    x = rs.uniform(0.0, l, (n, 3)).astype(np.float32)
    tag = np.arange(1, n + 1, dtype=np.int32)
    src = dict(x=x, v=rs.normal(0.0, 1.0, (n, 3)).astype(np.float32),
               f=np.zeros((n, 3), np.float32), typ=tag % n_types, tag=tag,
               image=np.zeros((n, 3), np.int32), mask=np.ones(n, bool),
               mol=np.zeros(n, np.int32), lo=np.zeros(3, np.float32),
               hi=np.full(3, l, np.float32), step=0)
    if t:
        src["T"] = 1.0 + 0.3 * np.sin(x[:, 0])
    if ns:
        src["C"] = np.stack([1.0 + 0.1 * s + 0.5 * np.cos(x[:, 0] + s)
                             for s in range(ns)], -1)
    kw = dict(rc=1.0, density=n / l ** 3, skin=SKIN, spill=spill)
    cfg = CellConfig.for_box([l] * 3, **kw)
    bst = to_bucket_state(bridge.state_from(src), cfg)
    drift = (0.04 * bst.v).clamp(-SKIN / 2, SKIN / 2) * bst.mask[:, None]
    x = bst.box.wrap(bst.x + drift)[0]
    if wrap_crosser:
        r = int(torch.nonzero(bst.mask)[17])
        x[r, 0] += -l if float(x[r, 0]) > l / 2 else l
    return bst.replace(x=x), cfg, JCellConfig.for_box([l] * 3, **kw)


def jax_rows(bst, *names):
    """The named bucket-row fields as JAX arrays."""
    return [jnp.asarray(getattr(bst, n).numpy()) for n in names]


def general_params(n):
    """Two types (a_01 1.4 a, a_11 2 a, rc_01 0.8), s_exp 0.5 and chain
    exclusions at weight 0.25."""
    p = JDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=77,
                         n_types=2, s_exp=0.5)
    p = p.replace(a=p.a * jnp.asarray([[1.0, 1.4], [1.2, 2.0]]),
                  rc=p.rc * jnp.asarray([[1.0, 0.8], [0.8, 1.0]]))
    ex, w = j_build_exclusions(_chains(n), n, weight=0.25, max_excl=2)
    return p.replace(excl=ex, excl_w=w)


def assert_classic_match(bst, got, want):
    """The JAX fused-kernel tests' bounds: max force error 2e-6 relative
    to max |f|, pad rows exactly 0, relative virial error 1e-4."""
    (f_t, vir_t), (f_j, vir_j) = got, want
    fp, fj = np.asarray(f_t), np.asarray(f_j)
    m = bst.mask.numpy()
    assert np.isfinite(fp).all()
    assert np.abs(fp[m] - fj[m]).max() / np.abs(fj).max() < 2e-6
    assert (~m).any() and np.abs(fp[~m]).max() == 0.0
    assert abs(float(vir_t) - float(vir_j)) / abs(float(vir_j)) < 1e-4


def assert_transport_match(bst, got, want):
    """The port's transport tests' bounds: max relative error of f 2e-5,
    of dT/dt or dC/dt 5e-5, of the virial 1e-4, pad rows exactly 0, and
    (tDPD) per-species sum of dC/dt over max |dC/dt| below 5e-5."""
    fp, qp, fj, qj = (np.asarray(a) for a in (*got[:2], *want[:2]))
    m = bst.mask.numpy()
    assert np.isfinite(fp).all() and np.isfinite(qp).all()
    assert np.abs(fp[m] - fj[m]).max() / np.abs(fj).max() < 2e-5
    q_scale = np.abs(qj).max()
    assert np.abs(qp[m] - qj[m]).max() / q_scale < 5e-5
    if qp.ndim == 2:
        assert np.abs(qp[m].sum(0)).max() / q_scale < 5e-5
    assert (~m).any() and np.abs(fp[~m]).max() == 0.0
    assert np.abs(qp[~m]).max() == 0.0
    assert abs(float(got[2]) - float(want[2])) / abs(float(want[2])) < 1e-4


@pytest.mark.parametrize("spill,rng_mode", [(True, "fast"), (False, "tea")],
                         ids=["spill-fast-general", "strict-tea-general"])
def test_fused_plain_matches_jax_interpret(spill, rng_mode):
    bst, cfg, jcfg = bucket_rows(spill, 3)
    jp = general_params(bst.n_valid().item())
    want = j_fused(*jax_rows(bst, "x", "v", "typ", "tag", "mask"),
                   JBox.cubic(float(bst.box.lengths[0])), jnp.int32(STEP),
                   jp, 0.01, jcfg, rng_mode=rng_mode, interpret=True,
                   s_exp=0.5)
    got = bucket_forces_pallas_fused(
        bst.x, bst.v, bst.typ, bst.tag, bst.mask, bst.box, STEP,
        bridge.dpd_params_from(jp), 0.01, cfg, rng_mode=rng_mode, s_exp=0.5)
    assert_classic_match(bst, got, want)


def test_fused_s_exp_must_match_params():
    bst, cfg, _ = bucket_rows(True, 3, n_types=1)
    one = JDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=77)
    with pytest.raises(ValueError, match="s_exp"):
        bucket_forces_pallas_fused(
            bst.x, bst.v, bst.typ, bst.tag, bst.mask, bst.box, STEP,
            bridge.dpd_params_from(one), 0.01, cfg, s_exp=0.5)
