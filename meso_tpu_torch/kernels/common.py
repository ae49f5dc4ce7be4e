"""What the pair-kernel wrappers share: the checks of what each kernel
takes, and the specs of the CUDA inputs each launch validates.

Used by ``kernels/pair_dpd_v3.py`` (K1-K3), ``kernels/_brick.py`` and the
fused, banded and halo entry points built on it (K4-K7). The refusals name their
entry in ROADMAP Queue 3 where the JAX package's kernels and its dense
oracles disagree (R7, R8, R9): the port refuses such a case rather than
copy either side.
"""

from __future__ import annotations

import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.neighbor.cells import CellConfig


def half_window(cfg: CellConfig, rng_mode: str) -> int:
    """Raise for what no pair kernel covers; return the x half-window: 2
    for spill buckets (a slot-cell may sit one column right of its true
    cell), 1 for strict ones."""
    if rng_mode not in ("fast", "tea"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    nx, ny, nz = cfg.ncell
    xr = 2 if cfg.spill else 1
    if nx < 2 * xr + 1 or ny < 3 or nz < 3:
        raise ValueError(f"ncell={cfg.ncell} too small for the +-{xr} "
                         "x-window and +-1 y/z windows")
    return xr


def check_classic(params, cfg: CellConfig, rng_mode: str, s_exp: float,
                  debug_pairs: bool) -> tuple[int, bool]:
    """Returns the x half-window and whether the case needs K1's general
    variant (more than one type, s_exp != 1, exclusions, debug_pairs)."""
    xr = half_window(cfg, rng_mode)
    check_classic_params(params, s_exp)
    general = (params.n_types != 1 or s_exp != 1.0
               or params.excl is not None or debug_pairs)
    return xr, general


def check_classic_params(params, s_exp: float) -> None:
    """The System's s_exp must be the parameters' own, and exclusions come
    with their weight."""
    if s_exp != params.s_exp:
        raise ValueError(f"System.s_exp={s_exp} differs from the pair "
                         f"parameters' s_exp={params.s_exp}")
    if (params.excl is None) != (params.excl_w is None):
        raise ValueError("excl and excl_w come together")


def halo_window(cfg: CellConfig, ext: tuple, rng_mode: str) -> int:
    """``half_window`` for a brick whose axes named in ``ext`` arrive
    extended by halo layers (x by the half-window, y and z by one layer):
    at least one target column, and an axis padded here with its own
    periodic copy must hold enough cells that the window visits none
    twice. Returns the x half-window."""
    if rng_mode not in ("fast", "tea"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    if not set(ext) <= {"x", "y", "z"}:
        raise ValueError(f"ext={ext} names an axis other than x, y, z")
    xr = 2 if cfg.spill else 1
    if cfg.spill and "x" not in ext:
        raise NotImplementedError(
            "the spill layout under domain decomposition needs the x axis "
            "halo-extended (1-D slabs or x-decomposed bricks)")
    for axis, n, need in zip("xyz", cfg.ncell, (2 * xr + 1, 3, 3)):
        if n < 1 or (axis not in ext and n < need):
            raise ValueError(
                f"ncell={cfg.ncell} with ext={ext}: {axis} has {n} target "
                f"cells, needs at least {1 if axis in ext else need}")
    return xr


def check_tdpd(params, cfg: CellConfig, rng_mode: str) -> int:
    """Raise for what no tDPD pair kernel takes; return the x half-window."""
    xr = half_window(cfg, rng_mode)
    check_tdpd_params(params)
    return xr


def check_tdpd_params(params) -> None:
    """Refused: s_exp != 1 (R8); rcc above the largest rc, which the stencil
    would not cover; and rcc above the smallest rc_ij (R9), where the JAX
    package's tDPD kernels gate the flux on rc_ij as well as rcc, and its
    dense oracle on rcc alone."""
    if params.s_exp != 1.0:
        raise ValueError(
            f"tDPD with s_exp={params.s_exp} is refused (ROADMAP Queue 3, "
            "R8): the JAX package's tDPD kernels take s_exp = 1 whatever "
            "params.s_exp says, and its dense oracle applies it")
    if params.rcc > params.rc_max:
        raise ValueError(
            "bucket tDPD path requires rcc <= rc (rc-based stencil): "
            f"rcc={params.rcc}, rc={params.rc_max}")
    if params.n_types > 1 and params.rcc > params.rc_min:
        raise ValueError(
            f"tDPD with rcc={params.rcc} above the smallest rc_ij="
            f"{params.rc_min} is refused (ROADMAP Queue 3, R9): the JAX "
            "package's tDPD kernels drop the flux of pairs with "
            "rc_ij <= r < rcc, and its dense oracle keeps it")


def check_strict(cfg: CellConfig) -> None:
    """The banded kernels take strict buckets only (R7)."""
    if cfg.spill:
        raise ValueError(
            "force_path 'pallas_banded' takes strict buckets only: the "
            "banded TPU kernels walk a +-1 x-window and drop the pairs of "
            "a spill layout (ROADMAP Queue 3, R7); build the CellConfig "
            "with spill=False or use force_path 'pallas'")


def check_cuda(specs: dict) -> None:
    """specs: name -> (tensor, dtype, shape or None). Every tensor must be
    a contiguous CUDA tensor on the first one's device."""
    dev = next(iter(specs.values()))[0].device
    for name, (t, dtype, shape) in specs.items():
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the CUDA kernel "
                             f"needs every input on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def row_specs(nr: int, x, v, tag, mask, box: Box) -> dict:
    """Specs of the per-row inputs every pair kernel reads."""
    f32 = torch.float32
    return {"x": (x, f32, (nr, 3)), "v": (v, f32, (nr, 3)),
            "tag": (tag, torch.int32, (nr,)), "mask": (mask, torch.bool, (nr,)),
            "box.lo": (box.lo, f32, (3,)), "box.hi": (box.hi, f32, (3,))}


def typ_spec(params, nr: int, typ) -> dict:
    """The per-row types the kernels read with more than one type."""
    if params.n_types == 1:
        return {}
    if typ is None:
        raise ValueError("a multi-type table needs typ")
    return {"typ": (typ, torch.int32, (nr,))}


def tables(params, names) -> dict:
    """Specs of the (T, T) coefficient tables ``names``."""
    nt = params.n_types
    return {name: (getattr(params, name), torch.float32, (nt, nt))
            for name in names}
