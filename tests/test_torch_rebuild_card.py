"""The sort rebuild's kernels (``csrc/bucket_assign.cu``) on the card
against the plain torch chains, bit for bit: the cell keys
(``neighbor.bucket_layout.cell_keys``) and the placement
(``place_rows``) on their own, and the whole rebuild (on the spill layout
the one-call ``rebuild_spill_on_card``) against the same rebuild of CPU
copies; at the spill cell's shape (1,029,000 particles at L = 70, K 16,
2,000,000 rows, the deferred wrap and its relief rows), at K 10 (rows that
do not fit) and at the strict cell's (K 28, no spill, no wrap at the
rebuild). One launch counted a call. Run it on a machine with a CUDA
device:
``python -m pytest tests/test_torch_rebuild_card.py -m card``; without
one it skips."""

import pytest
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import PER_PARTICLE, create_random
from meso_tpu_torch.neighbor import bucket_layout as bl
from meso_tpu_torch.neighbor.cells import CellConfig
from test_torch_imports import one_torch_thread  # noqa: F401

L, RHO = 70.0, 3.0
LAYOUTS = {"spill": dict(spill=True, capacity=16, wrap_at_rebuild=True),
           "spill_k10": dict(spill=True, capacity=10, wrap_at_rebuild=True),
           "strict": dict(spill=False, capacity=28, wrap_at_rebuild=False)}


def _bits(t):
    """The tensor's bits, so that -0.0 and 0.0 differ."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_state(a, b) -> list:
    """The per-particle columns in which two states differ in any bit."""
    return [n for n in PER_PARTICLE if getattr(a, n) is not None and
            not torch.equal(_bits(getattr(a, n)).cpu(),
                            _bits(getattr(b, n)).cpu())]


def _on(st, dev):
    box = Box(lo=st.box.lo.to(dev), hi=st.box.hi.to(dev))
    return st.replace(box=box, **{n: getattr(st, n).to(dev)
                                  for n in PER_PARTICLE
                                  if getattr(st, n) is not None})


@pytest.fixture(scope="module", params=list(LAYOUTS))
def drifted_rows(request):
    """A bucket state of the cell's layout whose rows moved since its
    rebuild, some of them out of the box, and its cell grid."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    box = Box.cubic(L, device="cuda")
    n = int(round(RHO * L ** 3))
    st = create_random(torch.Generator(device="cuda").manual_seed(17), n,
                       box)
    cfg = CellConfig.for_box([L] * 3, 1.0, RHO, skin=0.4, rebuild="sort",
                             **LAYOUTS[request.param])
    # a random start overflows a few cells: those rows are dropped
    bst = bl.rebuild_buckets(st, cfg)[0]
    x = bst.x + torch.clamp(0.04 * bst.v, -0.2, 0.2) * bst.mask[:, None]
    # and 60 rows piled into one cell overflow it and its spill room
    pile = torch.nonzero(bst.mask).reshape(-1)[:60]
    x[pile] = torch.tensor([35.3, 35.3, 35.3], device="cuda")
    return bst.replace(x=x), cfg


@pytest.mark.card
def test_cell_keys_kernel_bitwise_on_the_card(drifted_rows):
    bst, cfg = drifted_rows
    assert bst.n == bl.n_rows(cfg)
    assert bool(((bst.x < 0) | (bst.x >= L)).any())
    for wrap in (True, False):
        before = bl.LAUNCHES["bucket_keys"]
        st_k, key_k = bl.cell_keys(bst, cfg, wrap)
        assert bl.LAUNCHES["bucket_keys"] == before + 1
        st_p, key_p = bl.cell_keys_plain(bst, cfg, wrap)
        assert torch.equal(key_k, key_p)
        assert not _same_state(st_k, st_p)


@pytest.mark.card
def test_place_kernel_bitwise_on_the_card(drifted_rows):
    """place_rows on the arguments the rebuild gives it equals its plain
    version in every column, relief rows included."""
    bst, cfg = drifted_rows
    st, order, target, fits, overflow, relief = bl.sorted_targets(bst, cfg)
    assert (relief is not None) == cfg.wrap_at_rebuild
    nr = bl.n_rows(cfg)
    before = bl.LAUNCHES["bucket_place"]
    new = bl.place_rows(st, order, target, fits, nr, relief)
    assert bl.LAUNCHES["bucket_place"] == before + 1
    assert not _same_state(new, bl.place_rows_plain(st, order, target, fits,
                                                    nr, relief))
    if relief is not None:
        # relief rows are there: moved one image left of cell 0's block
        unmoved = bl.place_rows(st, order, target, fits, nr)
        assert bool((new.image[:, 0] - unmoved.image[:, 0] == 1).any())
    assert int(overflow) > 0


@pytest.mark.card
def test_max_displacement_kernel_bitwise_on_the_card(drifted_rows):
    from meso_tpu_torch.neighbor.cells import (max_displacement_sq,
                                               max_displacement_sq_plain)
    bst, cfg = drifted_rows
    moved, _ = bl.cell_keys(bst, cfg, True)
    for x_ref in (bst.x, moved.x, bst.x + 0.3):
        got = max_displacement_sq(moved.x, x_ref, bst.mask, bst.box)
        want = max_displacement_sq_plain(moved.x, x_ref, bst.mask, bst.box)
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.card
def test_rebuild_on_the_card_equals_the_plain_rebuild(drifted_rows):
    bst, cfg = drifted_rows
    before = dict(bl.LAUNCHES)
    new, of = bl.rebuild_buckets(bst, cfg)
    counted = {k: n - before[k] for k, n in bl.LAUNCHES.items()
               if n != before[k]}
    assert counted == ({"bucket_rebuild": 1} if cfg.spill else
                       {"bucket_keys": 1, "bucket_place": 1})
    new_c, of_c = bl.rebuild_buckets(_on(bst, "cpu"), cfg)
    assert int(of) == int(of_c)
    assert not _same_state(new, new_c)
    # bitwise from call to call
    again, _ = bl.rebuild_buckets(bst, cfg)
    assert not _same_state(new, again)
