"""Step-phase wall-clock accounting, the LAMMPS Timer footer (port of
``meso_tpu/utils/timer.py``).

Phases are timed on the host clock at the boundaries of host-side chunks.
Kernels run asynchronously on the card, so a timer given ``sync`` (for
example ``torch.cuda.synchronize``) calls it at every boundary: each phase
then holds the work it queued, not only the time to queue it. Use
``torch.profiler`` for the per-kernel breakdown.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Optional


class PhaseTimer:
    """Accumulate wall-clock per named phase; print a LAMMPS-style footer."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.acc = defaultdict(float)
        self.counts = defaultdict(int)
        self.sync = sync
        self._t0 = None
        self._phase = None
        self.start_wall = self._now()

    def _now(self) -> float:
        if self.sync is not None:
            self.sync()
        return time.perf_counter()

    def begin(self, phase: str):
        now = self._now()
        if self._phase is not None:
            self.acc[self._phase] += now - self._t0
            self.counts[self._phase] += 1
        self._phase = phase
        self._t0 = now

    def end(self):
        if self._phase is not None:
            self.acc[self._phase] += self._now() - self._t0
            self.counts[self._phase] += 1
            self._phase = None

    def summary(self) -> str:
        self.end()
        total = self._now() - self.start_wall
        lines = [f"{'Phase':<12}{'time (s)':>10}{'%':>7}{'calls':>8}"]
        for k, v in sorted(self.acc.items(), key=lambda kv: -kv[1]):
            lines.append(f"{k:<12}{v:>10.3f}{100*v/total:>6.1f}%"
                         f"{self.counts[k]:>8}")
        lines.append(f"{'total':<12}{total:>10.3f}")
        return "\n".join(lines)
