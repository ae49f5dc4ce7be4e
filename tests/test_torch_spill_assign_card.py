"""The spill rebuild's slot-assignment kernel (``csrc/bucket_assign.cu``)
on the card against its plain version (``spill_assign_plain``), bitwise in
target, fits and overflow: at the spill cell's shape (1,029,000 particles
at L = 70: nx 50, K 16, 2,500 (cy, cz) rows, 2,000,000 sorted rows), with
and without the wrap, and on a brick's rows (the left half of the box's x
cells, the rest masked, ``wrap=False`` as ``parallel/bricks.py`` calls
it); one launch a call. Run it on a machine with a CUDA device:
``python -m pytest tests/test_torch_spill_assign_card.py -m card``;
without one it skips."""

import pytest
import torch

from chip_smoke import check_assign
from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import create_random
from meso_tpu_torch.neighbor import bucket_layout as bl
from meso_tpu_torch.neighbor.cells import CellConfig
from test_torch_imports import one_torch_thread  # noqa: F401

L, RHO, K = 70.0, 3.0, 16


@pytest.fixture(scope="module")
def spill_cell_rows():
    """A bucket state of the spill cell's shape whose rows moved since its
    rebuild, and its cell grid."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    box = Box.cubic(L, device="cuda")
    n = int(round(RHO * L ** 3))
    st = create_random(torch.Generator(device="cuda").manual_seed(16), n,
                       box)
    cfg = CellConfig.for_box([L] * 3, 1.0, RHO, skin=0.4, spill=True,
                             capacity=K, rebuild="sort", wrap_at_rebuild=True)
    # a random start overflows a few cells at K 16: those rows are dropped
    bst = bl.rebuild_buckets(st, cfg)[0]
    x = bst.x + torch.clamp(0.04 * bst.v, -0.2, 0.2) * bst.mask[:, None]
    return bst.replace(x=x), cfg


@pytest.mark.card
def test_spill_assign_kernel_bitwise_on_the_card(spill_cell_rows):
    """chip_smoke's check: target, fits and overflow bitwise the plain
    version's on the sort rows with and without the wrap and on a brick's
    rows, one launch a call."""
    bst, cfg = spill_cell_rows
    args = check_assign(bst, cfg)
    assert (args[3], args[4], args[6]) == (2_000_000, 50, 2_500)
    assert args[0].device.type == "cuda"
