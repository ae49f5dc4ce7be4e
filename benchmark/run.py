#!/usr/bin/env python3
"""The benchmark of meso_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. A run builds the cell's configuration
through the program's deck path on the card, equilibrates it, times a
window of the program's run loop sized to ``--seconds``, checks the
window's last chunk against the plain reference in ``reference/`` and the
window's temperature, and prints one JSON line last on stdout:
end-to-end metrics with ``--trace 0``, per-layer metrics from
torch.profiler with ``--trace 1`` (over the traffic's ``trace_intervals``
thermo intervals). Exits 2 without a result when no card is present, and
1 when the program imported JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import build, check, spec, trace, window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "meso_tpu")


def forbidden_modules(names=None) -> list:
    """Top-level names among ``names`` (the loaded modules by default)
    that the run may not load, compared whole (``meso_tpu_torch`` is not
    ``meso_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(cuda: bool, chips: int) -> dict:
    import torch
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def traced(cell, run_kwargs, tmpdir):
    """Run the window under torch.profiler with the layers' spans. Returns
    (window result, the readers' context without the check's pair count,
    the breakdown)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if run_kwargs["cuda"]:
        acts.append(ProfilerActivity.CUDA)
    with trace.Spans(spec.layer_spans(cell.bench_dir)) as spans, \
            profile(activities=acts) as prof:
        res = window.run_window(
            **run_kwargs,
            span=lambda: record_function(trace.WINDOW_SPAN))
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    att = trace.attribute(trace.read_trace(path))
    os.unlink(path)
    missing = sorted(layer for layer in spec.read_layers(cell)
                     if not spans.opened.get(layer))
    if missing:
        raise RuntimeError(f"no span of layer(s) {missing} opened in the "
                           f"traced window of {cell.name}")
    busy_us, gaps = trace.busy_and_gaps(att["ops"], att["window"])
    w0, w1 = att["window"]
    ctx = {"steps": res["steps"],
           "window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
           "kernels": att["kernels"],
           "layer_s": {k: v / 1e6 for k, v in att["layer_us"].items()},
           "opened": dict(spans.opened), "phases": res["phases"],
           "wall_s": res["wall_s"]}
    return res, ctx, trace.breakdown(att["ops"], gaps)


def run_cell(cell, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run of ``cell``; returns the result object (with "checks")."""
    import torch
    t_start = T_START if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_phases = {"start": time.perf_counter() - t_start}
    system, params, state, rate = build.build(cell.config, cell.traffic,
                                              seed, device, setup_phases)
    tr = cell.traffic
    intervals = (tr["trace_intervals"] if trace_on else
                 window.plan_intervals(rate, seconds, tr["thermo_every"]))
    ref, phys = check.physics_of(cell.config, seed)
    lay = check.layout_of(ref, system)
    run_kwargs = dict(system=system, params=params, state=state,
                      thermo_every=tr["thermo_every"], intervals=intervals,
                      cuda=cuda)
    del system, params, state
    setup_s = time.perf_counter() - t_start
    with tempfile.TemporaryDirectory() as tmpdir:
        if trace_on:
            res, ctx, brk = traced(cell, run_kwargs, tmpdir)
        else:
            res, ctx, brk = window.run_window(**run_kwargs), None, None
    run_kwargs.clear()
    dev = device_info(cuda, cell.chips)
    final = {k: getattr(res["state"], k) for k in ("tag", "mask", "f", "v")}
    n_valid = int(final["mask"].sum())
    res.pop("state")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, n_pairs = check.numbers_of(ref, phys, lay, res, final)
    ok, checks = check.judge(numbers, cell.config["limits"])
    correct = bool(ok and res["code"] == 0
                   and res["steps"] == res["planned"])
    if trace_on:
        ctx.update(n_valid=n_valid, ordered_pairs=n_pairs)
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
    else:
        e2e = {"particle_steps_per_s": n_valid * res["steps"]
               / res["wall_s"], "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {"correct": correct, "attempted": res["planned"],
           "failed": res["planned"] - res["steps"], "metrics": metrics,
           "device": dev}
    if brk is not None:
        out["breakdown"] = brk
    out["power_limit"] = power_limit() if cuda else "none"
    out["setup_phases_s"] = setup_phases
    out["interval_s"] = [r["wall_s"] for r in res["rows"][1:]]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
