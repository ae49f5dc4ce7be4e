"""Geometric regions, the ``region``/``set``/``delete_atoms`` family (port
of ``meso_tpu/core/region.py``).

Each region is a frozen dataclass with an elementwise ``inside(x)``
predicate; the helpers apply one to a State: assign a type, mask rows out
(their slots stay, a later rebuild compacts them) or count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from meso_tpu_torch.core.state import State


@dataclass(frozen=True)
class Block:
    """Axis-aligned box [lo, hi) per axis; +-inf for open faces."""

    lo: Tuple[float, float, float] = (-math.inf,) * 3
    hi: Tuple[float, float, float] = (math.inf,) * 3

    def inside(self, x: torch.Tensor) -> torch.Tensor:
        m = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        for c in range(3):
            m = m & (x[..., c] >= self.lo[c]) & (x[..., c] < self.hi[c])
        return m


@dataclass(frozen=True)
class Sphere:
    center: Tuple[float, float, float]
    radius: float

    def inside(self, x: torch.Tensor) -> torch.Tensor:
        d = [x[..., c] - self.center[c] for c in range(3)]
        return d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < self.radius ** 2


@dataclass(frozen=True)
class Cylinder:
    """Cylinder along ``axis`` through (c1, c2) in the two transverse
    coordinates, radius ``radius``, optionally cut to [lo, hi) along the
    axis."""

    axis: int
    c1: float
    c2: float
    radius: float
    lo: float = -math.inf
    hi: float = math.inf

    def inside(self, x: torch.Tensor) -> torch.Tensor:
        others = [a for a in range(3) if a != self.axis]
        d1 = x[..., others[0]] - self.c1
        d2 = x[..., others[1]] - self.c2
        xa = x[..., self.axis]
        return ((d1 * d1 + d2 * d2 < self.radius ** 2)
                & (xa >= self.lo) & (xa < self.hi))


@dataclass(frozen=True)
class Union:
    regions: tuple

    def inside(self, x: torch.Tensor) -> torch.Tensor:
        m = self.regions[0].inside(x)
        for r in self.regions[1:]:
            m = m | r.inside(x)
        return m


@dataclass(frozen=True)
class Complement:
    region: object

    def inside(self, x: torch.Tensor) -> torch.Tensor:
        return ~self.region.inside(x)


def set_type_in_region(state: State, region, typ: int) -> State:
    """``set region R type T``."""
    sel = state.mask & region.inside(state.x)
    return state.replace(typ=torch.where(sel, typ, state.typ)
                         .to(torch.int32))


def delete_in_region(state: State, region) -> State:
    """``delete_atoms region R``: mask the rows out."""
    sel = state.mask & region.inside(state.x)
    return state.replace(mask=state.mask & ~sel)


def count_in_region(state: State, region) -> torch.Tensor:
    return torch.sum(state.mask & region.inside(state.x))
