"""The pair bonds' kernel (``csrc/bonds.cu`` through
``ops.bonded.pair_bonds``) on the card against the plain chain, for each
bond style on chip_smoke's inputs: FENE on the polymer path's set-up
(1,029,000 particles, 48,000 bonds), harmonic on the 1,029,000-bead A5B5
melt's (926,100 bonds), WLC-POW on a vesicle's edges. Within 1e-6 of the
plain chain's largest force on the card and on CPU copies; bitwise equal
from call to call and added in place as stored; with an owner mask and
missing partners as the plain chain; two kernel launches a call. Run it
on a machine with a CUDA device:
``python -m pytest tests/test_torch_bonds_card.py -m card``; without one
it skips."""

import pytest
import torch

from chip_smoke import BOND_CASES, check_bonds
from test_torch_imports import one_torch_thread  # noqa: F401


@pytest.mark.card
@pytest.mark.parametrize("style", list(BOND_CASES))
def test_pair_bonds_kernel_on_the_card(style):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    system, params, state = BOND_CASES[style]()
    assert system.bond_style == style
    rec = check_bonds(system, params, state, time_it=False)
    print(rec)
    failed = [k for k, ok in rec["checks"].items() if not ok]
    assert not failed, rec
    assert rec["launches_a_call"] == 2
