"""CLI: ``python -m meso_tpu_torch deck.toml``, the ``lmp -in deck`` analog
(port of ``meso_tpu/__main__.py``, with its flags and exit codes).

Exit codes: 0 done; 1 a checked invariant fired (a capacity overflow, or
under ``--dd`` a bonded partner out of reach), or ``--autotune`` on a path
without buckets; 2 ``--validate`` found the force path off the dense
oracle. ``--device`` (default ``cuda``) takes the place of the JAX
package's ``JAX_PLATFORMS``: the run is on the card unless the caller
asks for the CPU, and with no card torch raises.
"""

from __future__ import annotations

import argparse
import sys


def _overrides(pairs) -> dict:
    """``--var K=V`` pairs; numeric values are coerced to int or float."""
    out = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="meso_tpu_torch",
        description="DPD engine on PyTorch and CUDA (port of meso_tpu)")
    ap.add_argument("deck", help="TOML input deck")
    ap.add_argument("--steps", type=int, default=None,
                    help="override run.steps")
    ap.add_argument("--log", default=None, help="JSONL thermo log path")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace one thermo interval with torch.profiler "
                         "into DIR (a Chrome trace, trace.json)")
    ap.add_argument("--autotune", action="store_true",
                    help="measure (skin, rebuild_every, ...) candidates on "
                         "this deck before the run and use the fastest "
                         "safe config")
    ap.add_argument("--var", action="append", default=[], metavar="K=V",
                    help="override a [variables] entry (repeatable); "
                         "numeric values are auto-coerced")
    ap.add_argument("--dd", type=int, default=0, metavar="N",
                    help="run under the 1-D spatial domain decomposition "
                         "on N ranks (gloo processes; on the card they "
                         "share it)")
    ap.add_argument("--validate", action="store_true",
                    help="before running, validate the configured force "
                         "path against the dense O(N^2) oracle at the "
                         "initial state (validation-scale decks only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: cuda)")
    return ap


def _autotune(deck: dict, system, params, state, device):
    """The fastest safe (skin, cadence, ...) configuration of this deck;
    returns (system, state set up on it)."""
    from meso_tpu_torch.core.system import setup
    from meso_tpu_torch.io.deck import build_from_deck
    from meso_tpu_torch.utils.autotune import autotune_fluid

    def make_system(skin, every, spill=None, z_chunks=None,
                    pair_kernel=None, rebuild=None, capacity=None,
                    wrap_mode=None):
        d = dict(deck)
        d["neighbor"] = {**d.get("neighbor", {}), "skin": skin,
                         "rebuild_every": every}
        eng = dict(d.get("engine", {}))
        if spill is not None:
            eng["spill"] = spill
        d["engine"] = eng
        if "model" in d:  # [neighbor] gives the candidate's to the builder
            d["model"] = {**d["model"], "args": {
                k: v for k, v in d["model"].get("args", {}).items()
                if k not in ("skin", "rebuild_every")}}
        sy, _, _, _ = build_from_deck(d, device=device)
        cell_kw = {"rebuild_every": every}
        if rebuild is not None:
            cell_kw["rebuild"] = rebuild
        if capacity is not None:
            cell_kw["capacity"] = capacity
        if wrap_mode is not None:
            cell_kw["wrap_at_rebuild"] = wrap_mode == "rebuild"
        sy = sy.replace(cells=sy.cells.replace(**cell_kw))
        if z_chunks is not None:
            sy = sy.replace(z_chunks=z_chunks)
        if pair_kernel is not None:
            sy = sy.replace(pair_kernel=pair_kernel)
        if wrap_mode is not None:
            sy = sy.replace(wrap_mode=wrap_mode)
        return sy

    print("autotuning (skin, cadence, spill, kernel, rebuild, K, wrap):",
          flush=True)
    best, _ = autotune_fluid(make_system, params, state,
                             tune_kernel=system.force_path == "pallas")
    system = make_system(best.skin, best.rebuild_every, spill=best.spill,
                         z_chunks=best.z_chunks,
                         pair_kernel=best.pair_kernel, rebuild=best.rebuild,
                         capacity=best.capacity,
                         wrap_mode=best.wrap_mode or None)
    return system, setup(system, params, state)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    import torch

    from meso_tpu_torch.io.deck import build_from_deck, load_deck
    from meso_tpu_torch.io.thermo import ThermoLogger
    from meso_tpu_torch.utils.timer import PhaseTimer

    device = torch.device(args.device)
    deck = load_deck(args.deck, overrides=_overrides(args.var) or None)
    system, params, state, run_cfg = build_from_deck(deck, device=device)
    steps = args.steps if args.steps is not None else run_cfg.steps
    if args.validate:
        from meso_tpu_torch.utils.debug import validate_forces
        report = validate_forces(system, params, state)
        print("validate:", " ".join(f"{k}={v:.3e}" if isinstance(v, float)
                                    else f"{k}={v}"
                                    for k, v in sorted(report.items())))
        if report["max_rel"] > 1e-3:
            print("validate: FORCE PATH DEVIATES from the dense oracle",
                  file=sys.stderr)
            return 2
    if args.autotune:
        if system.force_path not in ("bucket", "pallas"):
            print("--autotune requires a bucketed force path",
                  file=sys.stderr)
            return 1
        system, state = _autotune(deck, system, params, state, device)
    cuda = device.type == "cuda"
    timer = PhaseTimer(sync=(lambda: torch.cuda.synchronize(device))
                       if cuda else None)
    plan = dict(steps=steps, thermo_every=run_cfg.thermo_every,
                dump_every=run_cfg.dump_every, dump_path=run_cfg.dump_path,
                restart_every=run_cfg.restart_every,
                restart_path=run_cfg.restart_path, log=args.log,
                profile=args.profile)
    if args.dd > 1:
        from meso_tpu_torch.parallel.launch import run_deck_distributed
        rank0 = run_deck_distributed(system, params, state, args.dd, plan,
                                     device)
        timer.acc.update(rank0["acc"])
        timer.counts.update(rank0["counts"])
        print(timer.summary())
        return rank0["code"]
    logger = ThermoLogger(every=run_cfg.thermo_every, stream=sys.stdout,
                          jsonl_path=args.log)
    code, state = run_loop(system, params, state, plan, logger, timer)
    print(timer.summary())
    return code


def run_loop(system, params, state, plan: dict, logger, timer,
             runner=None):
    """The deck's run: thermo rows every ``thermo_every`` steps, dumps and
    restarts at their cadences, one interval traced with torch.profiler
    under ``plan["profile"]``. ``runner(system, params, state, n)`` takes
    n steps and returns (state, diag); the default is
    ``run_bucket_chunked`` on bucketed paths (no per-step traces) and
    ``run_adaptive`` on the others. Returns (exit code, state)."""
    import torch

    from meso_tpu_torch.core.system import run_adaptive, run_bucket_chunked
    from meso_tpu_torch.io.dump import write_lammpstrj
    from meso_tpu_torch.io.restart import save_restart

    bucketed = system.force_path in ("bucket", "pallas", "pallas_banded")
    every = system.cells.rebuild_every if system.cells else 1
    if runner is None:
        def runner(sy, pa, st, n):
            if bucketed:
                return run_bucket_chunked(sy, pa, st, max(n // every, 1),
                                          every, thermo_trace=False)
            return run_adaptive(sy, pa, st, n)

    logger.log(system, params, state)
    done = 0
    profiled = False
    while done < plan["steps"]:
        n = min(plan["thermo_every"], plan["steps"] - done)
        if plan.get("profile") and not profiled and done > 0:
            state, diag = _profiled(runner, system, params, state, n,
                                    plan["profile"], timer)
            profiled = True
        else:
            timer.begin("run")
            state, diag = runner(system, params, state, n)
        done += n
        timer.begin("output")
        extra = {}
        if "n_rebuilds" in diag:
            extra["rebuilds"] = int(diag["n_rebuilds"])
        if "worst_skin_ratio" in diag:
            extra["skin_ratio"] = round(float(diag["worst_skin_ratio"]), 2)
        if "bonded_missing" in diag:
            extra["bonded_missing"] = int(diag["bonded_missing"])
        logger.log(system, params, state, extra=extra)
        overflow = sum(int(torch.max(torch.as_tensor(diag[k]))) for k in
                       ("cell_overflow", "nlist_overflow", "bucket_overflow")
                       if k in diag)
        if overflow:
            print("ERROR: neighbor capacity overflow — increase capacity "
                  "(cells/nlist_m)", file=sys.stderr)
            return 1, state
        if extra.get("bonded_missing"):
            print("ERROR: bonded partners beyond the ghost rows' reach",
                  file=sys.stderr)
            return 1, state
        if plan["dump_every"] and done % plan["dump_every"] == 0:
            write_lammpstrj(plan["dump_path"], state)
        if plan["restart_every"] and done % plan["restart_every"] == 0:
            save_restart(plan["restart_path"], state)
    return 0, state


def _profiled(runner, system, params, state, n, out_dir, timer):
    """One interval under torch.profiler (the card's kernels included on a
    CUDA run, synchronised before the trace closes); the trace goes to
    ``out_dir/trace.json``."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = state.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    timer.begin("profile")
    with profile(activities=acts) as prof:
        state, diag = runner(system, params, state, n)
        if cuda:
            torch.cuda.synchronize(state.device)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    return state, diag


if __name__ == "__main__":
    sys.exit(main())
