#!/usr/bin/env python3
"""The readings that the limits of a cell's check are set from, in one
process on the card:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <run_seconds> [--out readings.json]

For each seed, each judged by the cell's limits as a run judges it
(``correct`` and every number beside its limit): the program, the cell's
set-up and window as a run makes them (the lower readings); the control,
the plain reference put in the program's place in the window's last
chunk with its pair arithmetic in bfloat16, followed from the same
snapshot and compared with the float32 reference (the upper readings; it
has to come out not correct); and the program with the thermostat's
noise switched off, the window run again from the same set-up, which the
temperature's number has to catch. The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import build, check, spec, window  # noqa: E402


def judged(numbers: dict, limits: dict) -> dict:
    ok, checks = check.judge(numbers, limits)
    return {"correct": ok, "checks": checks}


def readings(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    import torch
    cuda = torch.device(device).type == "cuda"
    limits = cell.config["limits"]
    system, params, state, rate = build.build(cell.config, cell.traffic,
                                              seed, device)
    tr = cell.traffic
    intervals = window.plan_intervals(rate, seconds, tr["thermo_every"])
    ref, phys = check.physics_of(cell.config, seed)
    lay = check.layout_of(ref, system)

    def final_of(res):
        return {k: getattr(res["state"], k) for k in ("tag", "mask", "f",
                                                      "v")}

    res = window.run_window(system, params, state, tr["thermo_every"],
                            intervals, cuda)
    final = final_of(res)
    program, _ = check.numbers_of(ref, phys, lay, res, final)
    control, _ = check.numbers_of(ref, phys, lay, res, final,
                                  control=torch.bfloat16)
    # the thermostat's noise off in the program, from the same set-up
    # state (the program's steps make new tensors; they never write into
    # the state they are given)
    quiet = params.replace(pair=params.pair.replace(
        sigma=torch.zeros_like(params.pair.sigma)))
    res_q = window.run_window(system, quiet, state, tr["thermo_every"],
                              intervals, cuda)
    noise_off, _ = check.numbers_of(ref, phys, lay, res_q, final_of(res_q))
    return {"seed": seed, "intervals": intervals,
            "program": judged(program, limits),
            "control_bf16": judged(control, limits),
            "noise_off": judged(noise_off, limits)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    out = []
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(cell, int(s), args.seconds)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        out.append(r)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
