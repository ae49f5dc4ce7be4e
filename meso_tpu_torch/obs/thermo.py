"""Scalar thermodynamic observables (port of ``meso_tpu/obs/thermo.py``).

Masked reductions over the state tensors; they return 0-d tensors on the
state's device and never synchronise. Degrees of freedom follow LAMMPS
``compute temp``: dim * (N - 1).
"""

from __future__ import annotations

import torch


def kinetic_energy(v, mass, mask) -> torch.Tensor:
    """Sum of 1/2 m v^2 over valid particles."""
    mv2 = mass * torch.sum(v * v, dim=-1)
    return 0.5 * torch.sum(torch.where(mask, mv2, torch.zeros_like(mv2)))


def kinetic_temperature(v, mass, mask, dim: int = 3) -> torch.Tensor:
    """kT from equipartition with dim*(N-1) degrees of freedom."""
    n = torch.sum(mask.to(torch.float32))
    dof = dim * (n - 1.0)
    return 2.0 * kinetic_energy(v, mass, mask) / dof


def total_momentum(v, mass, mask) -> torch.Tensor:
    """(3,) total momentum."""
    mv = mass[:, None] * v if mass.ndim else mass * v
    return torch.sum(torch.where(mask[:, None], mv, torch.zeros_like(mv)),
                     dim=0)


def pressure(v, mass, mask, virial, volume, dim: int = 3) -> torch.Tensor:
    """P = (sum m v^2 + virial) / (dim V); ``virial`` is the sum over unique
    pairs of dr.F."""
    mv2 = mass * torch.sum(v * v, dim=-1)
    mv2 = torch.sum(torch.where(mask, mv2, torch.zeros_like(mv2)))
    return (mv2 + virial) / (dim * volume)
