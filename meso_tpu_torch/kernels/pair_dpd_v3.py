"""Bucket pair forces for the three pair models (port of
``meso_tpu/kernels/pair_dpd_v3.py``: ``bucket_forces_pallas_v3`` (classic,
K1), ``bucket_forces_pallas_v3_edpd`` (K2) and
``bucket_forces_pallas_v3_tdpd`` (K3)).

On a CUDA tensor each wrapper launches the hand-written Hopper kernels (the
per-particle hash of ``csrc/pair_dpd_v3.cu`` in the fast RNG tier, then the
pair kernel of ``csrc/pair_dpd_v3.cu`` or ``csrc/pair_transport_v3.cu``) or
raises. On a CPU tensor, and only there, it runs its plain torch version
(``bucket_forces_v3_plain``, ``bucket_forces_v3_edpd_plain``,
``bucket_forces_v3_tdpd_plain``), which computes the same function. There
is no fallback from one to the other.

K1, its general variant, K2 and K3 run on the cell tiles of
``csrc/cell_tiles.cuh`` with K1's plan and table
(``kernels/cell_tiles.py::plan``, ``table_on``), all but K1 with the
visitor of ``csrc/pair_visitor.cuh``. A capacity the tiles cannot take
(above 237 spill, 396 strict) raises ``ValueError`` from the plan.

Covered: the fast and TEA RNG tiers, spill and strict layouts, the
min-image and no-min-image (``cfg.wrap_at_rebuild``) modes, and
per-type-pair tables. K1 covers every case of the TPU kernel:
``need_virial``, and, through its general variant
(``pair_dpd_v3_general``), multi-type tables, ``s_exp != 1``,
special-bonds exclusions and ``debug_pairs``; the one-type, s_exp = 1,
no-exclusion case keeps the main path's kernel. K2 and K3 take multi-type
tables and K3 any number of species. K3 raises ``ValueError`` for
``rcc > rc`` (the stencil covers rc only), for ``s_exp != 1`` (every JAX
tDPD kernel takes s_exp = 1 whatever the parameters say, where the JAX
dense oracle applies it; ROADMAP Queue 3, R8) and for rcc above the
smallest rc_ij (the JAX kernels drop the flux of pairs beyond rc_ij, the
oracle keeps it; R9): the port refuses rather than copy either side
(``kernels.common.check_tdpd``).
``interpret``, ``z_chunks``, ``dyn_roll``, ``lane_pad`` and ``w_pad`` are
TPU lowering knobs: they are accepted and ignored.
"""

from __future__ import annotations

import math

import torch

from meso_tpu_torch.core import rng as rngmod
from meso_tpu_torch.core.box import Box
from meso_tpu_torch.kernels import _build, cell_tiles
from meso_tpu_torch.kernels.common import (check_classic, check_cuda,
                                           check_tdpd, half_window,
                                           row_specs, tables, typ_spec)
from meso_tpu_torch.neighbor.bucket_layout import grid_shape, n_rows
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops import edpd as edpdmod
from meso_tpu_torch.ops import tdpd as tdpdmod
from meso_tpu_torch.ops.dpd import DPDParams, pair_force, special_weight

# Launch counts of each kernel, raised by one at each launch and nowhere
# else; chip_smoke.py resets and reads them around each path it drives.
LAUNCHES = {"pair_dpd_v3": 0, "pair_dpd_v3_general": 0, "particle_hash": 0,
            "pair_edpd_v3": 0, "pair_tdpd_v3": 0, "uniform_stream": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _typ_ptr(params, typ):
    return None if params.n_types == 1 else typ.data_ptr()


def launch_hash(lib, tag: torch.Tensor, step: int, seed: int,
                rounds: int) -> torch.Tensor:
    """uint32 bits of the per-particle hash, in an int32 tensor."""
    h = torch.empty_like(tag, dtype=torch.int32)
    code = lib.meso_particle_hash(
        tag.data_ptr(), h.data_ptr(), tag.numel(), step & 0xFFFFFFFF, seed,
        rounds, _build.stream_of(tag.device))
    _build.check(code, "particle_hash")
    LAUNCHES["particle_hash"] += 1
    return h


def _hash_or_tag(lib, tag, step_u: int, seed: int, rng_mode: str,
                 rounds: int):
    """The kernels' h input: the per-particle hash (fast tier, one launch)
    or the tags themselves (TEA tier, read as tags and never as h)."""
    if rng_mode == "tea":
        return tag
    return launch_hash(lib, tag, step_u, seed, rounds)


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
    return launch_hash(lib, tag, step, seed, rounds).to(torch.int64) \
        & 0xFFFFFFFF


def uniform_stream_v3(h: torch.Tensor, salt: int) -> torch.Tensor:
    """``rng.uniform_stream`` of uint32 hashes (held in int64, as the plain
    RNG holds them), through the device helper the transport kernels use:
    a probe that lets the card check that helper bitwise. On a CPU tensor it
    is ``rng.uniform_stream``."""
    if h.device.type == "cpu":
        return rngmod.uniform_stream(h, salt)
    lib = _build.load_library()
    if h.device.type != "cuda" or h.dtype != torch.int64:
        raise ValueError("uniform_stream_v3 takes an int64 CUDA tensor")
    u = h & 0xFFFFFFFF
    bits = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
    out = torch.empty(bits.shape, dtype=torch.float32, device=h.device)
    code = lib.meso_uniform_stream(
        bits.data_ptr(), out.data_ptr(), bits.numel(), salt & 0xFFFFFFFF,
        _build.stream_of(h.device))
    _build.check(code, "uniform_stream")
    LAUNCHES["uniform_stream"] += 1
    return out


def bucket_forces_pallas_v3(x, v, typ, tag, mask, box: Box, step: int,
                            params: DPDParams, dt: float, cfg: CellConfig,
                            rng_mode: str = "fast", rng_rounds: int = 8,
                            interpret=None, s_exp: float = 1.0,
                            z_chunks: int = 0, dyn_roll: bool = False,
                            debug_pairs: bool = False, lane_pad: int = 0,
                            w_pad: int = 0, need_virial: bool = True):
    """Classic-DPD forces on bucket rows. Returns (f (nr, 3), virial).

    With need_virial=False the virial is not computed and 0.0 is returned.
    ``s_exp`` is the System's mirror of ``params.s_exp`` and must equal it.
    With ``debug_pairs`` each row's f holds (its in-range partners, the sum
    of their 14-bit hash keys, 0) and the virial is 0. ``typ`` is read by
    the general variant only."""
    xr, general = check_classic(params, cfg, rng_mode, s_exp, debug_pairs)
    if x.device.type == "cpu":
        return bucket_forces_v3_plain(x, v, tag, mask, box, step, params, dt,
                                      cfg, rng_mode, rng_rounds, need_virial,
                                      typ=typ, debug_pairs=debug_pairs)
    lib = _build.load_library()
    nr = n_rows(cfg)
    check_cuda({**row_specs(nr, x, v, tag, mask, box),
                 **tables(params, ("a", "gamma", "sigma", "rc"))})
    if general:
        return _launch_general(lib, x, v, typ, tag, mask, box, step, params,
                               dt, cfg, xr, rng_mode, rng_rounds,
                               need_virial, debug_pairs)
    step_u = step & 0xFFFFFFFF
    h = _hash_or_tag(lib, tag, step_u, params.seed, rng_mode, rng_rounds)
    plan = cell_tiles.plan(cfg.capacity, xr, cfg.ncell)
    f = torch.empty((nr, 3), dtype=torch.float32, device=x.device)
    vir_rows = (torch.empty((nr,), dtype=torch.float32, device=x.device)
                if need_virial else None)
    table = cell_tiles.table_on(plan, x.device)
    code = lib.meso_pair_dpd_v3(
        x.data_ptr(), v.data_ptr(), h.data_ptr(), mask.data_ptr(),
        params.a.data_ptr(), params.gamma.data_ptr(),
        params.sigma.data_ptr(), params.rc.data_ptr(), box.lo.data_ptr(),
        box.hi.data_ptr(), table.data_ptr(), f.data_ptr(),
        None if vir_rows is None else vir_rows.data_ptr(),
        cfg.ncell[0], cfg.capacity, plan.xr, plan.width, plan.n_blocks,
        plan.threads, plan.list_cap, plan.smem_bytes,
        int(not cfg.wrap_at_rebuild), int(rng_mode == "tea"),
        int(need_virial), 1.0 / math.sqrt(dt), step_u, params.seed,
        rng_rounds, _build.stream_of(x.device))
    _build.check(code, "pair_dpd_v3")
    LAUNCHES["pair_dpd_v3"] += 1
    if need_virial:
        return f, torch.sum(vir_rows)
    return f, torch.zeros((), dtype=torch.float32, device=x.device)


def _launch_general(lib, x, v, typ, tag, mask, box: Box, step: int,
                    params: DPDParams, dt: float, cfg: CellConfig, xr: int,
                    rng_mode: str, rng_rounds: int, need_virial: bool,
                    debug_pairs: bool):
    """K1's general variant on CUDA tensors (the wrapper checked the
    rows and tables)."""
    nr = n_rows(cfg)
    specs = {"x": (x, torch.float32, None), "typ": (typ, torch.int32, (nr,))}
    n_excl = excl_rows = 0
    if params.excl is not None:
        excl_rows, n_excl = params.excl.shape
        specs["excl"] = (params.excl, torch.int32, None)
        specs["excl_w"] = (params.excl_w, torch.float32, ())
    check_cuda(specs)
    step_u = step & 0xFFFFFFFF
    # debug_pairs reads the per-particle hash's keys in both RNG tiers
    h = _hash_or_tag(lib, tag, step_u, params.seed,
                     "fast" if debug_pairs else rng_mode, rng_rounds)
    plan = cell_tiles.plan(cfg.capacity, xr, cfg.ncell)
    table = cell_tiles.table_on(plan, x.device)
    f = torch.empty((nr, 3), dtype=torch.float32, device=x.device)
    # the kernel writes every row's virial but in debug mode
    vir_rows = (None if debug_pairs else
                torch.empty((nr,), dtype=torch.float32, device=x.device))
    code = lib.meso_pair_dpd_v3_general(
        x.data_ptr(), v.data_ptr(), tag.data_ptr(), typ.data_ptr(),
        mask.data_ptr(), h.data_ptr(), params.a.data_ptr(),
        params.gamma.data_ptr(), params.sigma.data_ptr(),
        params.rc.data_ptr(), params.n_types,
        None if params.excl is None else params.excl.data_ptr(), excl_rows,
        n_excl, None if params.excl_w is None else params.excl_w.data_ptr(),
        box.lo.data_ptr(), box.hi.data_ptr(), table.data_ptr(), f.data_ptr(),
        None if vir_rows is None else vir_rows.data_ptr(),
        cfg.ncell[0], cfg.capacity, plan.xr, plan.width, plan.n_blocks,
        plan.threads, plan.list_cap, plan.smem_bytes,
        int(not cfg.wrap_at_rebuild), int(rng_mode == "tea"),
        int(debug_pairs), 1.0 / math.sqrt(dt), params.s_exp, step_u,
        params.seed, rng_rounds,
        _build.stream_of(x.device))
    _build.check(code, "pair_dpd_v3_general")
    LAUNCHES["pair_dpd_v3_general"] += 1
    if need_virial and not debug_pairs:
        return f, torch.sum(vir_rows)
    return f, torch.zeros((), dtype=torch.float32, device=x.device)


def bucket_forces_pallas_v3_edpd(x, v, t, typ, tag, mask, box: Box,
                                 step: int, params, dt: float,
                                 cfg: CellConfig, rng_mode: str = "fast",
                                 rng_rounds: int = 8, interpret=None,
                                 z_chunks: int = 0, lane_pad: int = 0,
                                 w_pad: int = 0):
    """eDPD forces and heat on bucket rows (K2, on K1's cell tiles).
    Returns (f (nr, 3), dTdt (nr,), virial). ``typ`` is read with more
    than one type."""
    xr = half_window(cfg, rng_mode)
    if x.device.type == "cpu":
        return bucket_forces_v3_edpd_plain(x, v, t, tag, mask, box, step,
                                           params, dt, cfg, rng_mode,
                                           rng_rounds, typ=typ)
    lib = _build.load_library()
    nr = n_rows(cfg)
    check_cuda({**row_specs(nr, x, v, tag, mask, box),
                 "t": (t, torch.float32, (nr,)),
                 **typ_spec(params, nr, typ),
                 **tables(params, ("a", "gamma", "kappa", "rc"))})
    step_u = step & 0xFFFFFFFF
    h = _hash_or_tag(lib, tag, step_u, params.seed, rng_mode, rng_rounds)
    plan = cell_tiles.plan(cfg.capacity, xr, cfg.ncell)
    table = cell_tiles.table_on(plan, x.device)
    f = torch.empty((nr, 3), dtype=torch.float32, device=x.device)
    dtdt = torch.empty((nr,), dtype=torch.float32, device=x.device)
    vir_rows = torch.empty((nr,), dtype=torch.float32, device=x.device)
    code = lib.meso_pair_edpd_v3(
        x.data_ptr(), v.data_ptr(), t.data_ptr(), tag.data_ptr(),
        _typ_ptr(params, typ), mask.data_ptr(), h.data_ptr(),
        params.a.data_ptr(), params.gamma.data_ptr(),
        params.kappa.data_ptr(), params.rc.data_ptr(), params.n_types,
        box.lo.data_ptr(), box.hi.data_ptr(), table.data_ptr(),
        f.data_ptr(), dtdt.data_ptr(), vir_rows.data_ptr(),
        cfg.ncell[0], cfg.capacity, plan.xr, plan.width, plan.n_blocks,
        plan.threads, plan.list_cap, plan.smem_bytes,
        int(not cfg.wrap_at_rebuild), int(rng_mode == "tea"),
        1.0 / math.sqrt(dt), params.mass, params.cv, step_u, params.seed,
        rng_rounds, _build.stream_of(x.device))
    _build.check(code, "pair_edpd_v3")
    LAUNCHES["pair_edpd_v3"] += 1
    return f, dtdt, torch.sum(vir_rows)


def bucket_forces_pallas_v3_tdpd(x, v, c, typ, tag, mask, box: Box,
                                 step: int, params, dt: float,
                                 cfg: CellConfig, rng_mode: str = "fast",
                                 rng_rounds: int = 8, interpret=None,
                                 z_chunks: int = 0, lane_pad: int = 0,
                                 w_pad: int = 0):
    """tDPD forces and per-species fluxes on bucket rows (K3). Returns
    (f (nr, 3), dCdt (nr, S), virial). ``typ`` is read with more than one
    type."""
    xr = check_tdpd(params, cfg, rng_mode)
    if x.device.type == "cpu":
        return bucket_forces_v3_tdpd_plain(x, v, c, tag, mask, box, step,
                                           params, dt, cfg, rng_mode,
                                           rng_rounds, typ=typ)
    lib = _build.load_library()
    nr = n_rows(cfg)
    ns = params.n_species
    check_cuda({**row_specs(nr, x, v, tag, mask, box),
                 "c": (c, torch.float32, (nr, ns)),
                 **typ_spec(params, nr, typ),
                 **tables(params, ("a", "gamma", "sigma", "rc")),
                 "kappa_c": (params.kappa_c, torch.float32, (ns,)),
                 "eps_c": (params.eps_c, torch.float32, (ns,))})
    step_u = step & 0xFFFFFFFF
    h = _hash_or_tag(lib, tag, step_u, params.seed, rng_mode, rng_rounds)
    plan = cell_tiles.plan(cfg.capacity, xr, cfg.ncell)
    table = cell_tiles.table_on(plan, x.device)
    f = torch.empty((nr, 3), dtype=torch.float32, device=x.device)
    dcdt = torch.empty((nr, ns), dtype=torch.float32, device=x.device)
    vir_rows = torch.empty((nr,), dtype=torch.float32, device=x.device)
    code = lib.meso_pair_tdpd_v3(
        x.data_ptr(), v.data_ptr(), c.data_ptr(), tag.data_ptr(),
        _typ_ptr(params, typ), mask.data_ptr(), h.data_ptr(),
        params.a.data_ptr(), params.gamma.data_ptr(),
        params.sigma.data_ptr(), params.rc.data_ptr(), params.n_types,
        params.kappa_c.data_ptr(), params.eps_c.data_ptr(),
        box.lo.data_ptr(), box.hi.data_ptr(), table.data_ptr(),
        f.data_ptr(), dcdt.data_ptr(), vir_rows.data_ptr(),
        cfg.ncell[0], cfg.capacity, plan.xr, ns, plan.width, plan.n_blocks,
        plan.threads, plan.list_cap, plan.smem_bytes,
        int(not cfg.wrap_at_rebuild), int(rng_mode == "tea"),
        1.0 / math.sqrt(dt), params.rcc, params.s1, step_u, params.seed,
        rng_rounds, _build.stream_of(x.device))
    _build.check(code, "pair_tdpd_v3")
    LAUNCHES["pair_tdpd_v3"] += 1
    return f, dcdt, torch.sum(vir_rows)


# candidates per group of stencil offsets in the plain versions: small grids
# take every offset in one vectorised pass, the 1M-particle grid one offset
# (~32M candidates) at a time
_PLAIN_GROUP_CANDIDATES = 1 << 24


def _axis_shift(n: int, d: int, length, device):
    """(n,) source-coordinate shift for stencil offset d on an axis of n
    cells: -L where c + d wraps below 0, +L where it wraps above n - 1."""
    c = torch.arange(n, device=device) + d
    zero = torch.zeros_like(length)
    return torch.where(c < 0, -length, torch.where(c >= n, length, zero))


def _stencil_pairs(x, mask, box: Box, cfg: CellConfig, rc2):
    """The candidate walk of the plain versions, shared by the three models.

    Walks the 27 (strict) or 45 (spill) stencil offsets in groups; for each
    offset it rolls the (ny, nz, K, nx) planes so that every target cell
    faces its source cell, applies the same coordinate shifts
    (no-min-image) or the minimum image as the kernels, and tests the
    cutoff over every candidate of the group. It yields, per group, the
    in-range pairs only: (target row, source row, [dx, dy, dz], r2), with
    dr = x_target - x_source. Groups are sized so that no pass holds more
    than ``_PLAIN_GROUP_CANDIDATES`` candidates, unless one offset alone
    does (~32M at the 1M-particle shape)."""
    ny, nz, k, nx = grid_shape(cfg)
    xr = 2 if cfg.spill else 1
    min_image = not cfg.wrap_at_rebuild
    dev = x.device
    lens = box.lengths
    inv_l = 1.0 / lens

    def planes(t):
        return t.reshape(ny, nz, k, nx)

    xp = [planes(x[:, c]) for c in range(3)]
    mp = planes(mask)

    def tgt(t):   # (1, ny, nz, K, 1, nx): target slot axis
        return t[None, :, :, :, None, :]

    def src(t):   # (G, ny, nz, 1, K, nx): source slot axis
        return t[:, :, :, None, :, :]

    offsets = [(dy, dz, dx) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
               for dx in range(-xr, xr + 1)]
    group = max(1, _PLAIN_GROUP_CANDIDATES // (ny * nz * k * k * nx))
    sizes = (ny, nz, nx)
    shape_of = ((ny, 1, 1, 1), (1, nz, 1, 1), (1, 1, 1, nx))
    for g0 in range(0, len(offsets), group):
        offs = offsets[g0:g0 + group]

        def sources(t):
            # rolled[g, cy, cz, s, cx] = t[cy+dy_g, cz+dz_g, s, cx+dx_g]
            return torch.stack([torch.roll(t, shifts=(-dy, -dz, -dx),
                                           dims=(0, 1, 3))
                                for dy, dz, dx in offs])

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
        g, cy, cz, kt, ks, cx = ok.nonzero(as_tuple=True)
        o = torch.tensor(offs, dtype=torch.int64, device=dev)[g]
        sy = (cy + o[:, 0]) % ny
        sz = (cz + o[:, 1]) % nz
        sx = (cx + o[:, 2]) % nx
        row = ((cy * nz + cz) * k + kt) * nx + cx
        src_row = ((sy * nz + sz) * k + ks) * nx + sx
        yield (row, src_row, [dc[g, cy, cz, kt, ks, cx] for dc in dr],
               r2[g, cy, cz, kt, ks, cx])


def _pair_hashes(tag, step: int, seed: int, rng_mode: str, rounds: int):
    """fn(row, src) -> the symmetric pair hash the kernels draw from."""
    if rng_mode == "fast":
        h = rngmod.particle_hash(tag, step, seed, rounds=rounds)
        return lambda i, j: rngmod.combine_symmetric(h[i], h[j])
    return lambda i, j: rngmod.pair_hash_tea(tag[i], tag[j], step, seed,
                                             rounds=rounds)


def classic_fmag(w, ev, theta, a, gamma, s, s_exp: float):
    """The classic kernels' force magnitude of in-range pairs: w = 1 - r/rc,
    ev = e.v, s = sigma / sqrt(dt); with s_exp != 1 the dissipative and
    random weights take w^s_exp, the conservative one keeps w."""
    if s_exp == 1.0:
        return w * (a - (gamma * w) * ev + s * theta)
    wr = torch.pow(torch.clamp(w, min=0.0), s_exp)
    return a * w - gamma * (wr * wr) * ev + s * wr * theta


def bucket_forces_v3_plain(x, v, tag, mask, box: Box, step: int,
                           params: DPDParams, dt: float, cfg: CellConfig,
                           rng_mode: str = "fast", rng_rounds: int = 8,
                           need_virial: bool = True, typ=None,
                           debug_pairs: bool = False):
    """The same function as the classic CUDA kernels, in plain torch: the
    ``_stencil_pairs`` walk out to the largest rc, then, for the pairs
    inside their own rc, the kernels' force (per-type-pair tables,
    ``params.s_exp``, the special-bonds weight), added into their target
    rows; or, with ``debug_pairs``, the partner counts and key sums. ``typ``
    is needed with more than one type."""
    nt = params.n_types
    if nt > 1 and typ is None:
        raise ValueError("a multi-type table needs typ")
    a_t, g_t = params.a.reshape(-1), params.gamma.reshape(-1)
    s_t = params.sigma.reshape(-1) * (1.0 / math.sqrt(dt))
    rc_t = params.rc.reshape(-1)
    inv_rc_t = 1.0 / rc_t
    s_exp = params.s_exp
    if rng_mode == "fast" or debug_pairs:
        h = rngmod.particle_hash(tag, step, params.seed, rounds=rng_rounds)
    ident = h if rng_mode == "fast" else tag
    nr = x.shape[0]
    f = torch.zeros((nr, 3), dtype=torch.float32, device=x.device)
    vir = torch.zeros((nr,), dtype=torch.float32, device=x.device)
    for row, src, d, r2 in _stencil_pairs(x, mask, box, cfg,
                                          torch.max(rc_t * rc_t)):
        if nt > 1:
            p = typ[row].long() * nt + typ[src].long()
            keep = r2 < rc_t[p] * rc_t[p]
            row, src, p, r2 = row[keep], src[keep], p[keep], r2[keep]
            d = [dc[keep] for dc in d]
        else:
            p = 0
        if debug_pairs:
            f[:, 0].index_add_(0, row, torch.ones_like(r2))
            f[:, 1].index_add_(0, row, (h[src] >> 18).to(torch.float32))
            continue
        a, gamma, s = a_t[p], g_t[p], s_t[p]
        rinv = torch.rsqrt(r2)
        rr = r2 * rinv
        w = 1.0 - rr * inv_rc_t[p]
        ev = sum(d[c] * (v[row, c] - v[src, c]) for c in range(3)) * rinv
        if rng_mode == "fast":
            theta = rngmod.pair_uniform_fast(ident[row], ident[src])
        else:
            theta = rngmod.pair_uniform_tea(ident[row], ident[src], step,
                                            params.seed, rounds=rng_rounds)
        fmag = classic_fmag(w, ev, theta, a, gamma, s, s_exp)
        if params.excl is not None:
            fmag = fmag * special_weight(tag[row], tag[src], params)
        fr = fmag * rinv
        f.index_add_(0, row, torch.stack([fr * dc for dc in d], -1))
        if need_virial:
            vir.index_add_(0, row, 0.5 * fmag * rr)
    if need_virial and not debug_pairs:
        return f, torch.sum(vir)
    return f, torch.zeros((), dtype=torch.float32, device=x.device)


def _type_pairs(params, typ, row, src, d, r2):
    """With more than one type: the pairs inside their own rc_ij, and the
    table index of each (typ_i * T + typ_j). With one type: everything, and
    index 0."""
    nt = params.n_types
    if nt == 1:
        return row, src, d, r2, 0
    if typ is None:
        raise ValueError("a multi-type table needs typ")
    p = typ[row].long() * nt + typ[src].long()
    rc = params.rc.reshape(-1)[p]
    keep = r2 < rc * rc
    return (row[keep], src[keep], [dc[keep] for dc in d], r2[keep],
            p[keep])


def bucket_forces_v3_edpd_plain(x, v, t, tag, mask, box: Box, step: int,
                                params, dt: float, cfg: CellConfig,
                                rng_mode: str = "fast", rng_rounds: int = 8,
                                typ=None):
    """The same function as the eDPD CUDA kernel, in plain torch: the
    ``_stencil_pairs`` walk out to the largest rc, then
    ``ops.edpd.edpd_pair`` on the pairs inside their own rc_ij, with the
    pair's coefficients. Returns (f, dTdt, virial). ``typ`` is needed with
    more than one type."""
    nr = x.shape[0]
    dev = x.device
    pair_hash = _pair_hashes(tag, step, params.seed, rng_mode, rng_rounds)
    tabs = [getattr(params, n).reshape(-1) for n in ("a", "gamma", "rc",
                                                     "kappa")]
    f = torch.zeros((nr, 3), dtype=torch.float32, device=dev)
    q = torch.zeros((nr,), dtype=torch.float32, device=dev)
    vir = torch.zeros((nr,), dtype=torch.float32, device=dev)
    for pair in _stencil_pairs(x, mask, box, cfg, torch.max(tabs[2]) ** 2):
        row, src, d, _, p = _type_pairs(params, typ, *pair)
        theta, zeta = edpdmod.noises_from_hash(pair_hash(row, src),
                                               tag[row], tag[src])
        f_p, q_p, vir_p = edpdmod.edpd_pair(
            torch.stack(d, -1), v[row] - v[src], t[row], t[src], theta,
            zeta, *(tab[p] for tab in tabs), params.mass,
            1.0 / math.sqrt(dt))
        f.index_add_(0, row, f_p)
        q.index_add_(0, row, q_p)
        vir.index_add_(0, row, vir_p)
    return f, q / params.cv, torch.sum(vir)


def bucket_forces_v3_tdpd_plain(x, v, c, tag, mask, box: Box, step: int,
                                params, dt: float, cfg: CellConfig,
                                rng_mode: str = "fast", rng_rounds: int = 8,
                                typ=None):
    """The same function as the tDPD CUDA kernel, in plain torch: the
    ``_stencil_pairs`` walk out to the largest rc, then
    ``ops.dpd.pair_force`` and ``ops.tdpd.tdpd_flux`` on the pairs inside
    their own rc_ij, with the pair's coefficients. Returns
    (f, dCdt (nr, S), virial). ``typ`` is needed with more than one type."""
    nr = x.shape[0]
    dev = x.device
    ns = params.n_species
    pair_hash = _pair_hashes(tag, step, params.seed, rng_mode, rng_rounds)
    tabs = [getattr(params, n).reshape(-1) for n in ("a", "gamma", "sigma",
                                                     "rc")]
    dt_inv_sqrt = 1.0 / math.sqrt(dt)
    f = torch.zeros((nr, 3), dtype=torch.float32, device=dev)
    q = torch.zeros((nr, ns), dtype=torch.float32, device=dev)
    vir = torch.zeros((nr,), dtype=torch.float32, device=dev)
    for pair in _stencil_pairs(x, mask, box, cfg, torch.max(tabs[3]) ** 2):
        row, src, d, _, p = _type_pairs(params, typ, *pair)
        dr = torch.stack(d, -1)
        theta, xi = tdpdmod.noises_from_hash(pair_hash(row, src), tag[row],
                                             tag[src], ns)
        f_p, vir_p = pair_force(dr, v[row] - v[src], theta,
                                *(tab[p] for tab in tabs), dt_inv_sqrt,
                                params.s_exp)
        q_p = tdpdmod.tdpd_flux(dr, c[row], c[src], xi, params.kappa_c,
                                params.eps_c, params.rcc, params.s1,
                                dt_inv_sqrt, True)
        f.index_add_(0, row, f_p)
        q.index_add_(0, row, q_p)
        vir.index_add_(0, row, vir_p)
    return f, q, torch.sum(vir)
