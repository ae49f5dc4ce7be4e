"""Runtime autotuning: configuration selection by measurement (port of
``meso_tpu/utils/autotune.py``). The tunables are the neighbour
machinery's knobs (skin, rebuild cadence, spill, rebuild engine, bucket
capacity, deferred wrap), measured on ``run_bucket_fixed``.

Candidates that differ only in knobs the port ignores (``z_chunks``;
``pair_kernel`` "v3_dynroll", which runs as "v3") build the same System,
which is measured once. Unlike the JAX package, a sweep in which no
candidate could be built raises instead of calling ``min`` on nothing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch


@dataclass
class TuneResult:
    skin: float
    rebuild_every: int
    ms_per_step: float
    ps_per_s: float
    skin_ratio: float
    spill: bool = False
    z_chunks: int = 0
    pair_kernel: str = "v2"
    rebuild: str = "gather"
    capacity: int = 0
    wrap_mode: str = ""


# the launch-shape knobs swept with tune_kernel, on the first three
# (skin, cadence) candidates
_KERNEL_KNOBS = (dict(spill=True, z_chunks=0),
                 dict(spill=True, z_chunks=2),
                 dict(spill=False, z_chunks=2),
                 dict(spill=True, pair_kernel="v3"),
                 dict(spill=True, pair_kernel="v3", rebuild="sort"),
                 dict(spill=True, pair_kernel="v3", rebuild="sort",
                      wrap_mode="rebuild"),
                 dict(spill=True, pair_kernel="v3_dynroll", z_chunks=2,
                      rebuild="sort", wrap_mode="rebuild"),
                 dict(spill=True, rebuild="sort"),
                 dict(spill=True, capacity=24))


def _same_run(system):
    """The System with the knobs the port ignores set to their defaults:
    two candidates with one key run the same code."""
    kernel = system.pair_kernel
    return system.replace(z_chunks=0,
                          pair_kernel="v3" if kernel.startswith("v3")
                          else kernel)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def autotune_fluid(make_system, params, state0, candidates=None,
                   steps: int = 30, verbose: bool = True,
                   tune_kernel: bool = False):
    """Measure run_bucket_fixed throughput across configuration candidates
    and return (the fastest SAFE config (worst_skin_ratio <= 1; the
    fastest of all where none is safe), every result).

    ``make_system(skin, rebuild_every, **knobs)`` must return a System
    whose cells reflect the knobs, or raise TypeError or ValueError for a
    knob it does not take (that candidate is skipped). ``state0`` is set
    up anew for each candidate. Each is timed over its second run of
    ``steps`` steps, with the card synchronised on both sides."""
    from meso_tpu_torch.core.system import run_bucket_fixed, setup

    if candidates is None:
        candidates = [dict(skin=0.3, every=3), dict(skin=0.4, every=5),
                      dict(skin=0.5, every=5), dict(skin=0.5, every=8),
                      dict(skin=0.65, every=10), dict(skin=0.65, every=14),
                      dict(skin=0.8, every=18)]
    candidates = [dict(skin=c[0], every=c[1]) if isinstance(c, tuple)
                  else dict(c) for c in candidates]
    if tune_kernel:
        candidates = candidates + [{**c, **knobs} for c in candidates[:3]
                                   for knobs in _KERNEL_KNOBS]
    results = []
    measured = []   # (System, its measurement): Systems compare by value
    for cand in candidates:
        skin, every = cand["skin"], cand["every"]
        kw = {k: v for k, v in cand.items() if k not in ("skin", "every")}
        try:
            system = make_system(skin, every, **kw)
        except (TypeError, ValueError):
            continue   # a knob the caller does not take, or an invalid mix
        key = _same_run(system)
        found = [m for k, m in measured if k == key]
        if not found:
            state = setup(system, params, state0)
            n_real = int(state.n_valid())
            nchunks = max(steps // every, 1)
            s, diag = run_bucket_fixed(system, params, state, nchunks, every)
            _sync(s.device)
            t0 = time.perf_counter()
            s, diag = run_bucket_fixed(system, params, s, nchunks, every)
            _sync(s.device)
            dt = (time.perf_counter() - t0) / (nchunks * every)
            found = [(dt, n_real, float(diag["worst_skin_ratio"]))]
            measured.append((key, found[0]))
        dt, n_real, ratio = found[0]
        r = TuneResult(skin=skin, rebuild_every=every,
                       ms_per_step=dt * 1e3, ps_per_s=n_real / dt,
                       skin_ratio=ratio, spill=bool(system.cells.spill),
                       z_chunks=kw.get("z_chunks") or 0,
                       pair_kernel=system.pair_kernel,
                       rebuild=system.cells.rebuild,
                       capacity=system.cells.capacity,
                       wrap_mode=system.wrap_mode)
        results.append(r)
        if verbose:
            print(f"  skin={skin} every={every} spill={r.spill} "
                  f"K={r.capacity} kern={r.pair_kernel} rb={r.rebuild} "
                  f"wrap={r.wrap_mode}: {r.ms_per_step:.2f} ms/step"
                  f" ({r.ps_per_s:.3e} ps/s, skin_ratio={r.skin_ratio:.2f})",
                  flush=True)
    if not results:
        raise ValueError(f"autotune: none of the {len(candidates)} "
                         "candidates could be built")
    safe = [r for r in results if r.skin_ratio <= 1.0]
    best = min(safe or results, key=lambda r: r.ms_per_step)
    if verbose:
        print(f"  -> best: skin={best.skin} every={best.rebuild_every}"
              f" ({best.ps_per_s:.3e} ps/s)", flush=True)
    return best, results
