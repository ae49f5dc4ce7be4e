"""The harness end to end on the CPU at L = 8, with the program's plain
kernels: a sound run is correct; the bfloat16 control fails the check;
and each fault this single-card cell can have, planted in the timed path
underneath an otherwise unchanged run, makes ``correct`` false. (The
exchange between cards does not exist on one card.)"""

from __future__ import annotations

import json

import pytest
from faults import FAULT_IDS, FAULTS, broken_window

import control
import run
from benchlib import spec

SEED = 2**31 + 2024


def run_small(bench, cell, monkeypatch=None, fault=None):
    bench_json, bench_dir = bench
    c = spec.load_cell(cell, bench_json=bench_json, bench_dir=bench_dir)
    if fault is not None:
        broken_window(monkeypatch, fault)
    return run.run_cell(c, SEED, 0.1, False, device="cpu")


@pytest.mark.parametrize("cell", ["classic_fluid_l70.spill",
                                  "classic_fluid_l70.strict"])
def test_sound_run_is_correct(small_bench, cell):
    out = run_small(small_bench, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    assert list(out)[-1] == "checks"
    json.dumps(out)


@pytest.mark.parametrize("fault,number", FAULTS, ids=FAULT_IDS)
def test_fault_in_the_timed_path_is_not_correct(small_bench, monkeypatch,
                                                fault, number):
    out = run_small(small_bench, "classic_fluid_l70.spill", monkeypatch,
                    fault)
    assert not out["correct"]
    c = out["checks"][number]
    assert c["value"] > c["limit"]


def test_control_is_judged_not_correct(small_bench):
    """The control and the noise-off program go through the cell's limits
    as a run does: the program is correct, they are not."""
    bench_json, bench_dir = small_bench
    cell = spec.load_cell("classic_fluid_l70.spill", bench_json=bench_json,
                          bench_dir=bench_dir)
    r = control.readings(cell, SEED, 0.1, device="cpu")
    assert r["program"]["correct"], r["program"]
    assert not r["control_bf16"]["correct"]
    checks = r["control_bf16"]["checks"]
    assert checks["force_gap"]["value"] > checks["force_gap"]["limit"]
    assert checks["velocity_gap"]["value"] > checks["velocity_gap"]["limit"]
    assert not r["noise_off"]["correct"]
