"""The measured window: the program's own run loop
(``meso_tpu_torch.__main__.run_loop``) with its synchronised PhaseTimer,
thermo rows to a JSONL file under TMPDIR, no dumps, no restarts.

The plan is whole thermo intervals and then one rebuild interval more:
the logger keeps a copy of the state at the row before that last
interval, so that the check can follow the last chunk the window ran,
from its start, and compare its end.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time


def capture(state) -> dict:
    """A copy of what the check reads of a state."""
    return {"x": state.x.clone(), "v": state.v.clone(),
            "f": state.f.clone(), "tag": state.tag.clone(),
            "mask": state.mask.clone(), "step": int(state.step)}


def plan_intervals(rate: float, seconds: float, thermo_every: int) -> int:
    """As many whole thermo intervals as fill ``seconds`` at ``rate``
    steps a second, at least one."""
    return max(1, round(seconds * rate / thermo_every))


def run_window(system, params, state, thermo_every: int, intervals: int,
               cuda: bool, span=contextlib.nullcontext):
    """Drive run_loop over ``intervals`` thermo intervals and one rebuild
    interval, inside ``span()``. Returns a dict: code, state, wall_s,
    steps, planned, rows, snapshot, phases."""
    import torch

    from meso_tpu_torch.__main__ import run_loop
    from meso_tpu_torch.io.thermo import ThermoLogger
    from meso_tpu_torch.utils.timer import PhaseTimer

    every = system.cells.rebuild_every
    step0 = int(state.step)
    snap_step = step0 + intervals * thermo_every

    class Logger(ThermoLogger):
        snapshot = None

        def log(self, system, params, state, virial=None, extra=None):
            row = super().log(system, params, state, virial, extra)
            if row["step"] == snap_step:
                Logger.snapshot = capture(state)
            return row

    sync = (lambda: torch.cuda.synchronize(state.device)) if cuda else None
    fd, log_path = tempfile.mkstemp(prefix="thermo-", suffix=".jsonl")
    os.close(fd)
    try:
        logger = Logger(every=thermo_every, stream=None, jsonl_path=log_path)
        timer = PhaseTimer(sync=sync)
        plan = dict(steps=intervals * thermo_every + every,
                    thermo_every=thermo_every, dump_every=0,
                    dump_path=os.devnull, restart_every=0,
                    restart_path=os.devnull, log=None, profile=None)
        if sync:
            sync()
        with span():
            t0 = time.perf_counter()
            code, state = run_loop(system, params, state, plan, logger,
                                   timer)
            timer.end()
            wall = time.perf_counter() - t0
    finally:
        os.unlink(log_path)
    return {"code": code, "state": state, "wall_s": wall,
            "steps": int(state.step) - step0, "planned": plan["steps"],
            "rows": logger.rows, "snapshot": Logger.snapshot,
            "phases": dict(timer.acc)}
