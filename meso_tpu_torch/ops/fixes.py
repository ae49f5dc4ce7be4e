"""Fixes — per-step hooks beside the pair forces (port of
``meso_tpu/ops/fixes.py``).

Each fix is a frozen dataclass of Python numbers whose hooks are
elementwise torch ops on the state's device:

* ``post_integrate(system, params, state, x, image, v_tilde)`` -> same triple
* ``post_force(system, params, state, x, v_tilde, f)`` -> f
* ``end_of_step(system, params, state)`` -> state

Vector settings (a force, a wall velocity, per-species rates) enter one
component at a time as Python floats: a tensor made from a list inside the
step would be a host-to-device copy that waits for the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def _mobile(system, state) -> torch.Tensor:
    m = state.mask
    for t in system.frozen_types:
        m = m & (state.typ != t)
    return m


@dataclass(frozen=True)
class FixBodyForce:
    """Constant extra force on mobile particles (optionally of one type):
    drives Poiseuille flow."""

    fx: float = 0.0
    fy: float = 0.0
    fz: float = 0.0
    typ: Optional[int] = None

    def post_force(self, system, params, state, x, v_tilde, f):
        sel = _mobile(system, state)
        if self.typ is not None:
            sel = sel & (state.typ == self.typ)
        add = torch.stack([f[:, c] + val for c, val in
                           enumerate((self.fx, self.fy, self.fz))], -1)
        return torch.where(sel[:, None], add, f)


@dataclass(frozen=True)
class FixBounceBack:
    """Bounce-back reflection at two planes normal to ``axis``: a mobile
    particle that crossed ``lo`` (from above) or ``hi`` (from below) is
    mirrored across the plane and its velocity reflected about the wall's,
    v -> 2 u_wall - v (no-slip; a moving wall imposes its own velocity).
    Applied at end of step, after the corrector."""

    axis: int = 1
    lo: float = 0.0
    hi: float = 1.0
    u_lo: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    u_hi: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def _reflect(self, x, v, mobile):
        xa = x[:, self.axis]
        below = mobile & (xa < self.lo)
        above = mobile & (xa > self.hi)
        xr = torch.where(below, 2.0 * self.lo - xa,
                         torch.where(above, 2.0 * self.hi - xa, xa))
        x = torch.stack([xr if c == self.axis else x[:, c]
                         for c in range(3)], -1)
        v = torch.stack([
            torch.where(below, 2.0 * self.u_lo[c] - v[:, c],
                        torch.where(above, 2.0 * self.u_hi[c] - v[:, c],
                                    v[:, c]))
            for c in range(3)], -1)
        return x, v

    def end_of_step(self, system, params, state):
        x, v = self._reflect(state.x, state.v, _mobile(system, state))
        return state.replace(x=x, v=v)


@dataclass(frozen=True)
class FixWallMove:
    """Couette moving wall: translate the frozen wall particles of ``typ``
    by their (constant) velocity each step."""

    typ: int

    def post_integrate(self, system, params, state, x, image, v_tilde):
        sel = (state.typ == self.typ) & state.mask
        xn, imn = state.box.wrap(x + system.dt * state.v, image)
        x = torch.where(sel[:, None], xn, x)
        image = torch.where(sel[:, None], imn, image)
        return x, image, v_tilde


@dataclass(frozen=True)
class FixMomentumZero:
    """Remove the centre-of-mass velocity from the mobile particles every
    ``every`` steps (``fix momentum``). ``state.step`` is a Python int, so
    the other steps cost nothing. Under domain decomposition the step
    passes ``reduce_sum``, the sum over the ranks, so that the fix removes
    the drift of the whole box and not each slab's own, as LAMMPS's fix
    sums over all ranks (the JAX package's 1-D step takes each slab's:
    ROADMAP Queue 3, R12)."""

    every: int = 100

    def end_of_step(self, system, params, state, reduce_sum=None):
        if state.step % self.every:
            return state
        mass = params.mass[state.typ.long()]
        zero = torch.zeros((), dtype=mass.dtype, device=mass.device)
        mv = torch.where(state.mask[:, None], mass[:, None] * state.v, zero)
        sums = torch.cat([torch.sum(mv, dim=0),
                          torch.sum(torch.where(state.mask, mass, zero))[None]])
        if reduce_sum is not None:
            sums = reduce_sum(sums)
        vcom = sums[:3] / sums[3]
        v = torch.where(_mobile(system, state)[:, None], state.v - vcom,
                        state.v)
        return state.replace(v=v)


@dataclass(frozen=True)
class FixSetForce:
    """Override force components on selected particles (one type, or every
    valid one); None leaves a component as it is (``fix setforce``)."""

    fx: Optional[float] = None
    fy: Optional[float] = None
    fz: Optional[float] = None
    typ: Optional[int] = None

    def post_force(self, system, params, state, x, v_tilde, f):
        sel = state.mask
        if self.typ is not None:
            sel = sel & (state.typ == self.typ)
        return torch.stack([
            f[:, c] if val is None else torch.where(sel, float(val), f[:, c])
            for c, val in enumerate((self.fx, self.fy, self.fz))], -1)


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
        sel = _mobile(system, state)
        if self.axis is not None:
            xa = state.x[:, self.axis]
            sel = sel & (xa >= self.lo) & (xa < self.hi)
        ns = state.C.shape[1]
        # one value for every species, or one each (numpy broadcasting)
        src, rate = (vals * ns if len(vals) == 1 else vals
                     for vals in (tuple(self.source), tuple(self.rate)))
        dc = torch.stack([system.dt * (src[s] - rate[s] * state.C[:, s])
                          for s in range(ns)], -1)
        return state.replace(C=torch.where(sel[:, None], state.C + dc,
                                           state.C))
