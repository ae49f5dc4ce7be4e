"""Orthogonal periodic simulation box (port of ``meso_tpu/core/box.py``).

Only fully periodic orthogonal boxes exist, as in the JAX package.
``lo``/``hi`` are (3,) float32 tensors on the simulation device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Box:
    """Orthogonal periodic box. ``lo``/``hi`` are (3,) float32 tensors."""

    lo: torch.Tensor
    hi: torch.Tensor

    @staticmethod
    def cubic(l: float, device=None) -> "Box":
        return Box(lo=torch.zeros(3, dtype=torch.float32, device=device),
                   hi=torch.full((3,), float(l), dtype=torch.float32,
                                 device=device))

    @staticmethod
    def orthorhombic(lx: float, ly: float, lz: float, device=None) -> "Box":
        return Box(lo=torch.zeros(3, dtype=torch.float32, device=device),
                   hi=torch.tensor([lx, ly, lz], dtype=torch.float32,
                                   device=device))

    @property
    def lengths(self) -> torch.Tensor:
        return self.hi - self.lo

    @property
    def volume(self) -> torch.Tensor:
        return torch.prod(self.lengths)

    def wrap(self, x: torch.Tensor, image: torch.Tensor | None = None):
        """Wrap positions into [lo, hi); update image flags if given.

        Returns ``(x_wrapped, image)`` (image is None iff the input is)."""
        l = self.lengths
        shift = torch.floor((x - self.lo) / l).to(torch.int32)
        xw = x - shift.to(x.dtype) * l
        # guard: floating point can leave xw == hi exactly; nudge inside
        xw = torch.where(xw >= self.hi, self.lo, xw)
        if image is None:
            return xw, None
        return xw, image + shift

    def min_image(self, dr: torch.Tensor) -> torch.Tensor:
        """Minimum-image displacement (valid for rc < L/2 on every axis)."""
        l = self.lengths
        return dr - torch.round(dr / l) * l

    def replace(self, **kw) -> "Box":
        return dataclasses.replace(self, **kw)
