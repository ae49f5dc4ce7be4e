"""Modified velocity-Verlet integration, Groot-Warren lambda scheme (port of
``meso_tpu/core/integrate.py``):

    v~ = v + lambda dt f/m              (initial_integrate, predictor)
    x' = x + dt v + 1/2 dt^2 f/m        (initial_integrate, drift)
    f' = F(x', v~)
    v' = v + 1/2 dt (f + f')/m          (final_integrate, corrector)

Frozen particles (``move_mask`` False) feel forces but never move.

On a CUDA tensor each half is one kernel of ``csrc/integrate.cu`` (one
launch where the plain torch chain takes 5 to 17), bitwise the chain's
result; on any other device the plain chain (``initial_integrate_plain``,
``final_integrate_plain``).
"""

from __future__ import annotations

import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.kernels import _build
from meso_tpu_torch.kernels.common import check_cuda


def _rows(what: str, n: int) -> None:
    if n >= 2 ** 31:
        raise ValueError(f"{what}: the kernel takes fewer than 2**31 rows")


def _inv_mass_spec(inv_mass, n: int):
    """(spec, per_row) of a per-row or single inverse mass."""
    per_row = inv_mass.shape[0] != 1 or n == 1
    return (inv_mass, torch.float32, (n,) if per_row else (1,)), int(per_row)


def initial_integrate(x, v, f, image, box: Box, dt: float, lam: float,
                      inv_mass, move_mask, wrap: bool = True):
    """Predictor: returns (x_new, image_new, v_tilde). ``wrap=False``
    (System.wrap_mode="rebuild") leaves positions unwrapped until the next
    rebuild. ``inv_mass`` is (N,) or (1,). On a CUDA tensor the kernel
    ``meso_initial_integrate`` (one launch, counted as
    ``"initial_integrate"``); else the plain chain."""
    if x.device.type != "cuda":
        return initial_integrate_plain(x, v, f, image, box, dt, lam,
                                       inv_mass, move_mask, wrap)
    x, v, f, image, inv_mass, move_mask = (
        t.contiguous() for t in (x, v, f, image, inv_mass, move_mask))
    n = x.shape[0]
    im, per_row = _inv_mass_spec(inv_mass, n)
    specs = {"x": (x, torch.float32, (n, 3)), "v": (v, torch.float32, (n, 3)),
             "f": (f, torch.float32, (n, 3)), "inv_mass": im,
             "move_mask": (move_mask, torch.bool, (n,))}
    if wrap:
        specs.update({"image": (image, torch.int32, (n, 3)),
                      "box.lo": (box.lo, torch.float32, (3,)),
                      "box.hi": (box.hi, torch.float32, (3,))})
    _rows("initial_integrate", n)
    check_cuda(specs)
    x_new = torch.empty_like(x)
    v_tilde = torch.empty_like(v)
    image_new = torch.empty_like(image) if wrap else image
    _build.launch(
        "initial_integrate", "meso_initial_integrate", x.data_ptr(),
        v.data_ptr(), f.data_ptr(),
        image.data_ptr() if wrap else None, inv_mass.data_ptr(), per_row,
        move_mask.data_ptr(), box.lo.data_ptr() if wrap else None,
        box.hi.data_ptr() if wrap else None, x_new.data_ptr(),
        v_tilde.data_ptr(), image_new.data_ptr() if wrap else None, n,
        float(dt), float(lam * dt), float(0.5 * dt * dt), int(wrap),
        device=x.device)
    return x_new, image_new, v_tilde


def initial_integrate_plain(x, v, f, image, box: Box, dt: float, lam: float,
                            inv_mass, move_mask, wrap: bool = True):
    """``initial_integrate`` in plain torch."""
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
    """Corrector: v' = v + dt/2 (f_old + f_new)/m on mobile particles. On a
    CUDA tensor the kernel ``meso_final_integrate`` (one launch, counted
    as ``"final_integrate"``); else the plain chain."""
    if v.device.type != "cuda":
        return final_integrate_plain(v, f_old, f_new, dt, inv_mass,
                                     move_mask)
    v, f_old, f_new, inv_mass, move_mask = (
        t.contiguous() for t in (v, f_old, f_new, inv_mass, move_mask))
    n = v.shape[0]
    im, per_row = _inv_mass_spec(inv_mass, n)
    _rows("final_integrate", n)
    check_cuda({"v": (v, torch.float32, (n, 3)),
                "f_old": (f_old, torch.float32, (n, 3)),
                "f_new": (f_new, torch.float32, (n, 3)), "inv_mass": im,
                "move_mask": (move_mask, torch.bool, (n,))})
    v_new = torch.empty_like(v)
    _build.launch(
        "final_integrate", "meso_final_integrate", v.data_ptr(),
        f_old.data_ptr(), f_new.data_ptr(), inv_mass.data_ptr(), per_row,
        move_mask.data_ptr(), v_new.data_ptr(), n, float(0.5 * dt),
        device=v.device)
    return v_new


def final_integrate_plain(v, f_old, f_new, dt: float, inv_mass, move_mask):
    """``final_integrate`` in plain torch."""
    a = (f_old + f_new) * inv_mass[:, None]
    return torch.where(move_mask[:, None], v + (0.5 * dt) * a, v)
