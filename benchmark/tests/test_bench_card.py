"""On the card, at the cells' own size: the program correct and the
bfloat16 control and the noise-off program not correct, judged by the
cells' limits on three seeds; and each fault of the timed path, planted
underneath a run of the spill cell, not correct
(``python3 -m pytest benchmark/tests -m card`` on a machine with a CUDA
device; without one they skip)."""

from __future__ import annotations

import pytest
from faults import FAULT_IDS, FAULTS, broken_window
from test_bench_spec import CELLS

import control
import run
from benchlib import spec

SEEDS = (3_000_000_101, 3_000_000_102, 3_000_000_103)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cell_size(cuda_device, cell):
    c = spec.load_cell(cell)
    for seed in SEEDS:
        r = control.readings(c, seed, 10.0, device=cuda_device)
        print(r)
        assert r["program"]["correct"], r
        assert not r["control_bf16"]["correct"], r
        assert not r["noise_off"]["correct"], r
        kt = r["noise_off"]["checks"]["kT_gap"]
        assert kt["value"] > kt["limit"], r


@pytest.mark.card
@pytest.mark.parametrize("fault,number", FAULTS, ids=FAULT_IDS)
def test_fault_fails_at_the_cell_size(cuda_device, monkeypatch, fault,
                                      number):
    c = spec.load_cell("classic_fluid_l70.spill")
    broken_window(monkeypatch, fault)
    out = run.run_cell(c, 3_000_000_111, 2.0, False, device=cuda_device)
    print(out["checks"])
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]
