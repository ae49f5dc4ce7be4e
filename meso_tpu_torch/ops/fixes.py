"""Fixes — per-step hooks beside the pair forces (port of
``meso_tpu/ops/fixes.py``).

Only ``FixSourceC`` is ported so far; the wall and force fixes (BodyForce,
BounceBack, WallMove, MomentumZero, SetForce) are ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class FixSourceC:
    """tDPD per-species source/reaction term: dC_s/dt += S_s - k_s C_s,
    applied at end of step (first-order splitting) to mobile particles
    inside an optional slab region along ``axis``."""

    source: Tuple[float, ...] = (0.0,)
    rate: Tuple[float, ...] = (0.0,)
    axis: Optional[int] = None
    lo: float = 0.0
    hi: float = 0.0

    def end_of_step(self, system, params, state):
        if state.C is None:
            return state
        sel = state.mask
        for t in system.frozen_types:
            sel = sel & (state.typ != t)
        if self.axis is not None:
            xa = state.x[:, self.axis]
            sel = sel & (xa >= self.lo) & (xa < self.hi)
        dev = state.device
        s = torch.tensor(self.source, dtype=torch.float32, device=dev)
        k = torch.tensor(self.rate, dtype=torch.float32, device=dev)
        dc = system.dt * (s - k * state.C)
        return state.replace(C=torch.where(sel[:, None], state.C + dc,
                                           state.C))
