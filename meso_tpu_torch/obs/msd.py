"""Mean-squared displacement and self-diffusion, the ``compute msd``
analog (port of ``meso_tpu/obs/msd.py``).

Uses unwrapped coordinates (x + image * L, exact because the image flags
are integrated with the drift), so box wraps never fold the displacement.
"""

from __future__ import annotations

import torch

from meso_tpu_torch.core.box import Box


def unwrapped(x: torch.Tensor, image: torch.Tensor,
              box: Box) -> torch.Tensor:
    return x + image.to(x.dtype) * box.lengths


def msd(x, image, x0u, mask, box: Box) -> torch.Tensor:
    """Mean squared displacement against the reference unwrapped positions
    ``x0u`` (= unwrapped(x_ref, image_ref, box)), masked mean. ``x0u`` must
    be in the same row order as ``x`` (the rebuilds reorder rows: take both
    in tag order, or take x0u after the last rebuild)."""
    d = unwrapped(x, image, box) - x0u
    w = mask.to(x.dtype)
    return torch.sum(torch.sum(d * d, dim=-1) * w) / torch.clamp(
        torch.sum(w), min=1.0)


def diffusion_coefficient(msd_t, dt_total: float, dim: int = 3):
    """Einstein relation D = MSD / (2 d t)."""
    return msd_t / (2.0 * dim * dt_total)
