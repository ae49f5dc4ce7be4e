"""Cell-grid configuration (port of the parts of ``meso_tpu/neighbor/cells.py``
that the bucket-resident path uses: ``CellConfig`` and
``max_displacement_sq``)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from meso_tpu_torch.core.box import Box


@dataclass(frozen=True)
class CellConfig:
    """Static cell-grid configuration; cell sides are >= rc + skin, so a
    27-cell (or, with spill, 45-slot-cell) stencil covers the interaction
    range between rebuilds."""

    ncell: tuple[int, int, int]
    capacity: int          # K: slots per cell
    skin: float = 0.3
    rebuild_every: int = 10
    # right-spill packing: a cell's overflow takes the next x-cell's free
    # slots (slot-cell = true cell or true cell + 1); K ~ 1.6x mean occupancy
    spill: bool = False
    # rebuild engine: "gather" or "sort"; both give identical placement
    rebuild: str = "gather"
    # System.wrap_mode="rebuild": positions are box-wrapped at rebuild time
    # only, and the pair kernel skips the per-candidate minimum image
    wrap_at_rebuild: bool = False

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.ncell
        return nx * ny * nz

    @staticmethod
    def for_box(box_lengths, rc: float, density: float, skin: float = 0.3,
                rebuild_every: int = 10, capacity: int | None = None,
                min_image_safe: bool = True, spill: bool = False,
                rebuild: str = "gather",
                wrap_at_rebuild: bool = False) -> "CellConfig":
        """Choose the grid so the cell side is >= rc + skin (host-side)."""
        l = np.asarray(box_lengths, float)
        ncell = np.maximum(np.floor(l / (rc + skin)).astype(int), 1)
        if min_image_safe:
            # a 27-stencil with periodic wrap visits a cell twice below 3
            ncell = np.maximum(ncell, 3)
        if spill and ncell[0] < 5:
            # the +-2 x-window reaches one cell twice below 5 columns
            spill = False
        if capacity is None:
            side = l / ncell
            mean_occ = density * float(np.prod(side))
            if spill:
                capacity = max(8, int(-(-1.6 * mean_occ // 8)) * 8)
            else:
                cap = int(np.ceil(mean_occ + 5.0 * np.sqrt(mean_occ) + 2.0))
                capacity = ((cap + 3) // 4) * 4
        return CellConfig(ncell=tuple(int(v) for v in ncell),
                          capacity=capacity, skin=skin,
                          rebuild_every=rebuild_every, spill=spill,
                          rebuild=rebuild, wrap_at_rebuild=wrap_at_rebuild)

    def replace(self, **kw) -> "CellConfig":
        return dataclasses.replace(self, **kw)


def max_displacement_sq(x: torch.Tensor, x_ref: torch.Tensor,
                        mask: torch.Tensor, box: Box) -> torch.Tensor:
    """Max squared displacement since rebuild (skin-trigger diagnostic)."""
    d = box.min_image(x - x_ref)
    d2 = torch.sum(d * d, dim=-1)
    return torch.max(torch.where(mask, d2, torch.zeros_like(d2)))
