"""Classic-DPD bucket forces (port of ``meso_tpu/kernels/pair_dpd_v3.py``,
the classic entry point ``bucket_forces_pallas_v3``).

On a CUDA tensor the wrapper launches the hand-written Hopper kernels of
``csrc/pair_dpd_v3.cu`` (the per-particle hash, then the pair kernel) or
raises. On a CPU tensor, and only there, it runs the plain torch version
``bucket_forces_v3_plain``, which computes the same function. There is no
fallback from one to the other.

Covered: the fast and TEA RNG tiers, spill and strict layouts, the
min-image and no-min-image (``cfg.wrap_at_rebuild``) modes, and
``need_virial``. Multi-type tables, ``s_exp != 1``, exclusions and
``debug_pairs`` raise ``NotImplementedError`` (ROADMAP Queue 2, K1).
``interpret``, ``z_chunks``, ``dyn_roll``, ``lane_pad`` and ``w_pad`` are
TPU lowering knobs: they are accepted and ignored.
"""

from __future__ import annotations

import math

import torch

from meso_tpu_torch.core import rng as rngmod
from meso_tpu_torch.core.box import Box
from meso_tpu_torch.kernels import _build
from meso_tpu_torch.neighbor.bucket_layout import grid_shape, n_rows
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops.dpd import DPDParams

# Launch counts of each kernel, raised by one at each launch and nowhere
# else; chip_smoke.py resets and reads them around the main path.
LAUNCHES = {"pair_dpd_v3": 0, "particle_hash": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_supported(params: DPDParams, cfg: CellConfig, rng_mode: str,
                     s_exp: float, debug_pairs: bool) -> int:
    """Raise for cases the port does not cover; return the x half-window."""
    todo = "is not ported yet (ROADMAP Queue 2, K1 remaining cases)"
    if params.n_types != 1:
        raise NotImplementedError(f"multi-type pair tables {todo}")
    if s_exp != 1.0 or params.s_exp != 1.0:
        raise NotImplementedError(f"s_exp != 1 {todo}")
    if params.excl is not None:
        raise NotImplementedError(f"special-bonds exclusions {todo}")
    if debug_pairs:
        raise NotImplementedError(f"debug_pairs accounting {todo}")
    if rng_mode not in ("fast", "tea"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    nx, ny, nz = cfg.ncell
    xr = 2 if cfg.spill else 1
    if nx < 2 * xr + 1 or ny < 3 or nz < 3:
        raise ValueError(f"ncell={cfg.ncell} too small for the +-{xr} "
                         "x-window and +-1 y/z windows")
    return xr


def _launch_hash(lib, tag: torch.Tensor, step: int, seed: int,
                 rounds: int) -> torch.Tensor:
    """uint32 bits of the per-particle hash, in an int32 tensor."""
    h = torch.empty_like(tag, dtype=torch.int32)
    code = lib.meso_particle_hash(
        tag.data_ptr(), h.data_ptr(), tag.numel(), step & 0xFFFFFFFF, seed,
        rounds, torch.cuda.current_stream(tag.device).cuda_stream)
    _build.check(code, "particle_hash")
    LAUNCHES["particle_hash"] += 1
    return h


def _check_cuda(tensors: dict, nr: int) -> None:
    want = {"x": (torch.float32, (nr, 3)), "v": (torch.float32, (nr, 3)),
            "tag": (torch.int32, (nr,)), "mask": (torch.bool, (nr,)),
            "a": (torch.float32, None), "gamma": (torch.float32, None),
            "sigma": (torch.float32, None), "rc": (torch.float32, None),
            "box.lo": (torch.float32, (3,)), "box.hi": (torch.float32, (3,))}
    dev = tensors["x"].device
    for name, t in tensors.items():
        dtype, shape = want[name]
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


def particle_hash_v3(tag: torch.Tensor, step: int, seed: int,
                     rounds: int = 8) -> torch.Tensor:
    """Per-particle hash as uint32 values in int64: the CUDA hash kernel on
    a CUDA tensor, ``rng.particle_hash`` on a CPU tensor."""
    if tag.device.type == "cpu":
        return rngmod.particle_hash(tag, step, seed, rounds=rounds)
    lib = _build.load_library()
    if tag.device.type != "cuda" or tag.dtype != torch.int32 \
            or not tag.is_contiguous():
        raise ValueError("particle_hash_v3 takes a contiguous int32 CUDA "
                         "tensor")
    return _launch_hash(lib, tag, step, seed, rounds).to(torch.int64) \
        & 0xFFFFFFFF


def bucket_forces_pallas_v3(x, v, typ, tag, mask, box: Box, step: int,
                            params: DPDParams, dt: float, cfg: CellConfig,
                            rng_mode: str = "fast", rng_rounds: int = 8,
                            interpret=None, s_exp: float = 1.0,
                            z_chunks: int = 0, dyn_roll: bool = False,
                            debug_pairs: bool = False, lane_pad: int = 0,
                            w_pad: int = 0, need_virial: bool = True):
    """Classic-DPD forces on bucket rows. Returns (f (nr, 3), virial).

    With need_virial=False the virial is not computed and 0.0 is returned.
    ``typ`` is unused (one particle type)."""
    xr = _check_supported(params, cfg, rng_mode, s_exp, debug_pairs)
    if x.device.type == "cpu":
        return bucket_forces_v3_plain(x, v, tag, mask, box, step, params, dt,
                                      cfg, rng_mode, rng_rounds, need_virial)
    lib = _build.load_library()
    nr = n_rows(cfg)
    _check_cuda({"x": x, "v": v, "tag": tag, "mask": mask, "a": params.a,
                 "gamma": params.gamma, "sigma": params.sigma,
                 "rc": params.rc, "box.lo": box.lo, "box.hi": box.hi}, nr)
    step_u = step & 0xFFFFFFFF
    tea = rng_mode == "tea"
    h = tag if tea else _launch_hash(lib, tag, step_u, params.seed,
                                     rng_rounds)
    f = torch.empty((nr, 3), dtype=torch.float32, device=x.device)
    vir_rows = (torch.empty((nr,), dtype=torch.float32, device=x.device)
                if need_virial else None)
    nx, ny, nz = cfg.ncell
    code = lib.meso_pair_dpd_v3(
        x.data_ptr(), v.data_ptr(), tag.data_ptr(), mask.data_ptr(),
        h.data_ptr(), params.a.data_ptr(), params.gamma.data_ptr(),
        params.sigma.data_ptr(), params.rc.data_ptr(), box.lo.data_ptr(),
        box.hi.data_ptr(), f.data_ptr(),
        None if vir_rows is None else vir_rows.data_ptr(),
        nx, ny, nz, cfg.capacity, xr, int(not cfg.wrap_at_rebuild),
        int(tea), int(need_virial), 1.0 / math.sqrt(dt), step_u,
        params.seed, rng_rounds,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "pair_dpd_v3")
    LAUNCHES["pair_dpd_v3"] += 1
    if need_virial:
        return f, torch.sum(vir_rows)
    return f, torch.zeros((), dtype=torch.float32, device=x.device)


# candidates per group of stencil offsets in the plain version: small grids
# take every offset in one vectorised pass, the 1M-particle grid one offset
# (~32M candidates) at a time
_PLAIN_GROUP_CANDIDATES = 1 << 24


def _axis_shift(n: int, d: int, length, device):
    """(n,) source-coordinate shift for stencil offset d on an axis of n
    cells: -L where c + d wraps below 0, +L where it wraps above n - 1."""
    c = torch.arange(n, device=device) + d
    zero = torch.zeros_like(length)
    return torch.where(c < 0, -length, torch.where(c >= n, length, zero))


def bucket_forces_v3_plain(x, v, tag, mask, box: Box, step: int,
                           params: DPDParams, dt: float, cfg: CellConfig,
                           rng_mode: str = "fast", rng_rounds: int = 8,
                           need_virial: bool = True):
    """The same function as the CUDA kernel, in plain torch.

    Walks the 27 (strict) or 45 (spill) stencil offsets in groups; for each
    offset it rolls the (ny, nz, K, nx) planes so that every target cell
    faces its source cell, applies the same coordinate shifts
    (no-min-image) or the minimum image, and adds the (ny, nz, K, K, nx)
    block of pair forces into the targets. Groups are sized so that no
    pass holds more than ``_PLAIN_GROUP_CANDIDATES`` candidates, unless one
    offset alone does (~32M at the 1M-particle shape)."""
    ny, nz, k, nx = grid_shape(cfg)
    xr = 2 if cfg.spill else 1
    min_image = not cfg.wrap_at_rebuild
    dev = x.device
    lens = box.lengths
    inv_l = 1.0 / lens
    a = params.a[0, 0]
    gamma = params.gamma[0, 0]
    s = params.sigma[0, 0] * (1.0 / math.sqrt(dt))
    rc = params.rc[0, 0]
    rc2, inv_rc = rc * rc, 1.0 / rc

    def planes(t):
        return t.reshape(ny, nz, k, nx)

    xp = [planes(x[:, c]) for c in range(3)]
    vp = [planes(v[:, c]) for c in range(3)]
    mp = planes(mask)
    if rng_mode == "fast":
        ident = planes(rngmod.particle_hash(tag, step, params.seed,
                                            rounds=rng_rounds))
    else:
        ident = planes(tag)

    def tgt(t):   # (1, ny, nz, K, 1, nx): target slot axis
        return t[None, :, :, :, None, :]

    def src(t):   # (G, ny, nz, 1, K, nx): source slot axis
        return t[:, :, :, None, :, :]

    offsets = [(dy, dz, dx) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
               for dx in range(-xr, xr + 1)]
    group = max(1, _PLAIN_GROUP_CANDIDATES // (ny * nz * k * k * nx))
    sizes = (ny, nz, nx)
    shape_of = ((ny, 1, 1, 1), (1, nz, 1, 1), (1, 1, 1, nx))
    f = torch.zeros((ny * nz * k * nx, 3), dtype=torch.float32, device=dev)
    vir = torch.zeros((ny * nz * k * nx,), dtype=torch.float32, device=dev)
    for g0 in range(0, len(offsets), group):
        offs = offsets[g0:g0 + group]

        def sources(t):
            # rolled[g, cy, cz, s, cx] = t[cy+dy_g, cz+dz_g, s, cx+dx_g]
            return torch.stack([torch.roll(t, shifts=(-dy, -dz, -dx),
                                           dims=(0, 1, 3))
                                for dy, dz, dx in offs])

        # the cutoff test over every candidate of the group ...
        dr = []
        for c in range(3):
            d = tgt(xp[c]) - src(sources(xp[c]))
            if min_image:
                d = d - torch.round(d * inv_l[c]) * lens[c]
            else:
                # the source's image shift, on the offset's own axis: y for
                # dy, z for dz, x for dx (channel c is axis c)
                axis = (2, 0, 1)[c]
                d = d - src(torch.stack([
                    _axis_shift(sizes[axis], o[axis], lens[c], dev)
                    .reshape(shape_of[axis]).expand(ny, nz, 1, nx)
                    for o in offs]))
            dr.append(d)
        r2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        ok = tgt(mp) & src(sources(mp)) & (r2 < rc2) & (r2 > 0.0)
        # ... and the force on the few candidates inside rc only
        g, cy, cz, kt, ks, cx = ok.nonzero(as_tuple=True)
        o = torch.tensor(offs, dtype=torch.int64, device=dev)[g]
        sy = (cy + o[:, 0]) % ny
        sz = (cz + o[:, 1]) % nz
        sx = (cx + o[:, 2]) % nx
        d = [dc[g, cy, cz, kt, ks, cx] for dc in dr]
        r2p = r2[g, cy, cz, kt, ks, cx]
        rinv = torch.rsqrt(r2p)
        rr = r2p * rinv
        w = 1.0 - rr * inv_rc
        ev = sum(d[c] * (vp[c][cy, cz, kt, cx] - vp[c][sy, sz, ks, sx])
                 for c in range(3)) * rinv
        id_i, id_j = ident[cy, cz, kt, cx], ident[sy, sz, ks, sx]
        if rng_mode == "fast":
            theta = rngmod.pair_uniform_fast(id_i, id_j)
        else:
            theta = rngmod.pair_uniform_tea(id_i, id_j, step, params.seed,
                                            rounds=rng_rounds)
        fmag = w * (a - (gamma * w) * ev + s * theta)
        fr = fmag * rinv
        row = ((cy * nz + cz) * k + kt) * nx + cx
        f.index_add_(0, row, torch.stack([fr * dc for dc in d], -1))
        if need_virial:
            vir.index_add_(0, row, 0.5 * fmag * rr)
    f_rows = f
    if need_virial:
        return f_rows, torch.sum(vir)
    return f_rows, torch.zeros((), dtype=torch.float32, device=dev)
