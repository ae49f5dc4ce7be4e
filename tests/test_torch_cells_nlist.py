"""The port's cell binning and neighbour lists (meso_tpu_torch/neighbor/)
against the JAX package's on the same input state: cell ids, the sort
permutation, bucket indices and masks, overflow, the 27-cell stencil and
the padded lists (idx, n_neigh, overflow) are bitwise equal. The overflow
cases mirror tests/unit/test_neighbor.py:93,100."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.neighbor import cells as jcells
from meso_tpu.neighbor import nlist as jnlist
from meso_tpu_torch import bridge
from meso_tpu_torch.neighbor import cells as tcells
from meso_tpu_torch.neighbor import nlist as tnlist
from test_torch_imports import one_torch_thread  # noqa: F401

j_build_cells = jax.jit(jcells.build_cells, static_argnames="cfg")
j_build_nlist = jax.jit(jnlist.build_nlist,
                        static_argnames=("cfg", "rc_max", "m_cap", "block"))

FIELDS = ("x", "v", "f", "tag", "typ", "mol", "image", "mask")


def _case(l=6.0, n=700, n_pad=0, seed=0, outside=True):
    """A JAX random state of n rows, the last n_pad of them padding; with
    ``outside`` two rows sit just outside the box (the clip of the cell
    index), as rows do between wraps."""
    box = JBox.cubic(l)
    st = j_create_random(jax.random.PRNGKey(seed), n, box)
    mask = np.ones(n, bool)
    mask[n - n_pad:] = False
    x = np.asarray(st.x).copy()
    if outside:
        x[0, 0] = -1e-3
        x[1, 2] = l + 1e-3
    return st.replace(x=jnp.asarray(x), mask=jnp.asarray(mask))


def _cfg(l, capacity=None, skin=0.3):
    return (jcells.CellConfig.for_box([l] * 3, 1.0, 3.0, skin=skin,
                                      capacity=capacity),
            tcells.CellConfig.for_box([l] * 3, 1.0, 3.0, skin=skin,
                                      capacity=capacity))


def _eq(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=what)


@pytest.mark.parametrize("n_pad", [0, 37], ids=["full", "padded"])
def test_cell_index_and_sort_bitwise(n_pad):
    jst = _case(n_pad=n_pad)
    jcfg, tcfg = _cfg(6.0)
    tst = bridge.state_from(jst, device="cpu")
    _eq(tcells.cell_index(tst.x, tst.mask, tst.box, tcfg),
        jcells.cell_index(jst.x, jst.mask, jst.box, jcfg), "cid")
    js, jcid = jcells.sort_state(jst, jcfg)
    ts, tcid = tcells.sort_state(tst, tcfg)
    _eq(tcid, jcid, "sorted cid")
    for name in FIELDS:
        _eq(getattr(ts, name), getattr(js, name), name)


@pytest.mark.parametrize("capacity,n_pad", [(None, 0), (None, 37),
                                            (2, 37), (None, 32)],
                         ids=["sized", "padded", "overflow",
                              "trash-row-full"])
def test_build_cells_bitwise(capacity, n_pad):
    """Capacity 2 overflows (tests/unit/test_neighbor.py:93); 32 padding
    rows at K = 32 fill the trash row's last slot, which the rows that do
    not fit also write."""
    jst = _case(n_pad=n_pad)
    jcfg, tcfg = _cfg(6.0, capacity)
    if n_pad == 32:
        assert tcfg.capacity == 32
    js, jc = j_build_cells(jst, jcfg)
    ts, tc = tcells.build_cells(bridge.state_from(jst, device="cpu"), tcfg)
    for name in ("cid", "bucket_idx", "bucket_mask", "x_ref"):
        _eq(getattr(tc, name), getattr(jc, name), name)
    assert int(tc.overflow) == int(jc.overflow)
    assert (int(tc.overflow) > 0) == (capacity == 2)
    for name in FIELDS:
        _eq(getattr(ts, name), getattr(js, name), name)


def test_stencil_cells_bitwise():
    jcfg, tcfg = _cfg(7.0)
    cid = np.arange(tcfg.n_cells + 1, dtype=np.int32)
    _eq(tcells.stencil_cells(torch.from_numpy(cid), tcfg),
        jcells.stencil_cells(jnp.asarray(cid), jcfg), "stencil")


@pytest.mark.parametrize("m_cap,block,n_pad", [(None, 2048, 0),
                                               (None, 256, 37),
                                               (8, 2048, 0)],
                         ids=["sized", "blocked-padded", "overflow"])
def test_build_nlist_bitwise(m_cap, block, n_pad):
    """The padded lists, counts and overflow; M = 8 overflows
    (tests/unit/test_neighbor.py:100) and still reports the true counts.
    A block of 256 splits 700 rows into three blocks, the last partial."""
    jst = _case(n_pad=n_pad)
    jcfg, tcfg = _cfg(6.0)
    assert jnlist.neighbor_capacity(3.0, 1.0, 0.3) \
        == tnlist.neighbor_capacity(3.0, 1.0, 0.3)
    m = m_cap or tnlist.neighbor_capacity(3.0, 1.0, 0.3)
    js, jc = j_build_cells(jst, jcfg)
    jl = j_build_nlist(js.x, js.mask, js.box, jc, jcfg, 1.0, m, block=block)
    ts, tc = tcells.build_cells(bridge.state_from(jst, device="cpu"), tcfg)
    tl = tnlist.build_nlist(ts.x, ts.mask, ts.box, tc, tcfg, 1.0, m,
                            block=block)
    _eq(tl.idx, jl.idx, "idx")
    _eq(tl.n_neigh, jl.n_neigh, "n_neigh")
    # the JAX buckets carried across by the bridge give the same lists
    tb = tnlist.build_nlist(ts.x, ts.mask, ts.box,
                            bridge.cell_list_from(jc, device="cpu"), tcfg,
                            1.0, m, block=block)
    _eq(tb.idx, jl.idx, "idx from the carried buckets")
    assert int(tl.overflow) == int(jl.overflow)
    assert (int(tl.overflow) > 0) == (m_cap == 8)
    if m_cap == 8:
        assert int(torch.max(tl.n_neigh)) > 8
