"""On the card, at the cell's own size: the readings the diblock melt's
limits are set from. For each seed, one set-up and window as a run makes
them: the program correct; the reference's controls in the program's
place in the window's last chunk (``reference.diblock.CONTROLS``: the pair
arithmetic in bfloat16, the springs off, the springs at half K) and the
program with the thermostat's noise off (the window run again from the
same set-up) not correct, each with the number that catches it beyond its
limit. ``python3 -m pytest benchmark/tests/test_bench_diblock_card.py -m
card -s`` on a machine with a CUDA device prints every reading; without
one it skips."""

from __future__ import annotations

import json

import pytest
import torch

from benchlib import build, check, spec, window

CELL = "diblock_melt_l70.spill"
SEEDS = (3_000_000_201, 3_000_000_202, 3_000_000_203)
# the number each control has to push beyond its limit
CAUGHT_BY = {"torch.bfloat16": "force_gap", "springs_off": "force_gap",
             "springs_half_k": "force_gap", "noise_off": "kT_gap"}


def readings(cell, seed: int, seconds: float, device: str) -> dict:
    limits = cell.config["limits"]
    cuda = torch.device(device).type == "cuda"
    system, params, state, rate = build.build(cell.config, cell.traffic,
                                              seed, device)
    tr = cell.traffic
    intervals = window.plan_intervals(rate, seconds, tr["thermo_every"])
    ref, phys = check.physics_of(cell.config, seed)
    lay = check.layout_of(ref, system)

    def judged(res, control=None):
        final = {k: getattr(res["state"], k) for k in ("tag", "mask", "f",
                                                       "v")}
        numbers, _ = check.numbers_of(ref, phys, lay, res, final, control)
        ok, checks = check.judge(numbers, limits)
        return {"correct": ok, "checks": checks}

    res = window.run_window(system, params, state, tr["thermo_every"],
                            intervals, cuda)
    out = {"seed": seed, "intervals": intervals, "program": judged(res)}
    for control in ref.CONTROLS:
        out[str(control)] = judged(res, control)
    del res
    quiet = params.replace(pair=params.pair.replace(
        sigma=torch.zeros_like(params.pair.sigma)))
    out["noise_off"] = judged(window.run_window(
        system, quiet, state, tr["thermo_every"], intervals, cuda))
    return out


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_melt_controls_fail_at_the_cell_size(cuda_device, seed):
    r = readings(spec.load_cell(CELL), seed, 10.0, cuda_device)
    print(json.dumps(r))
    assert r["program"]["correct"], r
    for name, number in CAUGHT_BY.items():
        c = r[name]["checks"][number]
        assert not r[name]["correct"] and c["value"] > c["limit"], (name, r)
