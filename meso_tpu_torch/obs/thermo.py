"""Scalar thermodynamic observables (port of ``meso_tpu/obs/thermo.py``).

Masked reductions over the state tensors; they return 0-d tensors on the
state's device and never synchronise. Degrees of freedom follow LAMMPS
``compute temp``: dim * (N - 1).
"""

from __future__ import annotations

import torch

from meso_tpu_torch.ops.dpd import sqrt32


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


def potential_energy_dense(x, typ, mask, box, a_table, rc_table) \
        -> torch.Tensor:
    """Conservative pair energy U = sum_{i<j} a rc/2 (1 - r/rc)^2 over all
    pairs, O(N^2) (validation scale): the Groot-Warren potential whose
    force is a w(r)."""
    dr = box.min_image(x[:, None, :] - x[None, :, :])
    r2 = torch.sum(dr * dr, dim=-1)
    n = x.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    valid = (mask[:, None] & mask[None, :]) & ~eye
    ti, tj = typ[:, None].long(), typ[None, :].long()
    a, rc = a_table[ti, tj], rc_table[ti, tj]
    r = sqrt32(torch.clamp(r2, min=1e-12))
    w = torch.clamp(1.0 - r / rc, min=0.0)
    u = 0.5 * a * rc * w * w
    return 0.5 * torch.sum(torch.where(valid, u, torch.zeros_like(u)))
