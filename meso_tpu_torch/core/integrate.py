"""Modified velocity-Verlet integration, Groot-Warren lambda scheme (port of
``meso_tpu/core/integrate.py``):

    v~ = v + lambda dt f/m              (initial_integrate, predictor)
    x' = x + dt v + 1/2 dt^2 f/m        (initial_integrate, drift)
    f' = F(x', v~)
    v' = v + 1/2 dt (f + f')/m          (final_integrate, corrector)

Frozen particles (``move_mask`` False) feel forces but never move.
"""

from __future__ import annotations

import torch

from meso_tpu_torch.core.box import Box


def initial_integrate(x, v, f, image, box: Box, dt: float, lam: float,
                      inv_mass, move_mask, wrap: bool = True):
    """Predictor: returns (x_new, image_new, v_tilde). ``wrap=False``
    (System.wrap_mode="rebuild") leaves positions unwrapped until the next
    rebuild."""
    m = move_mask[:, None]
    a = f * inv_mass[:, None]
    v_tilde = torch.where(m, v + (lam * dt) * a, v)
    x_new = torch.where(m, x + dt * v + (0.5 * dt * dt) * a, x)
    if wrap:
        x_new, image_new = box.wrap(x_new, image)
    else:
        image_new = image
    return x_new, image_new, v_tilde


def final_integrate(v, f_old, f_new, dt: float, inv_mass, move_mask):
    """Corrector: v' = v + dt/2 (f_old + f_new)/m on mobile particles."""
    a = (f_old + f_new) * inv_mass[:, None]
    return torch.where(move_mask[:, None], v + (0.5 * dt) * a, v)
