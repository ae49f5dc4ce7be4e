"""The padded brick that the ``pair_brick`` CUDA kernels read, their launch,
and the plain torch version of the function they compute (``plain_brick``,
under ``brick_forces_plain`` and ``halo_forces_plain``, the plain versions
of all ten entry points).

One kernel family (``csrc/pair_brick.cu``) serves, on CUDA tensors, the
fused-lane kernel K5 (``kernels/pair_dpd_fused.py``), the banded transport
kernel K7 (``kernels/pair_multiphysics.py``), and the halo forms on the
distributed path, K4 (the fused kernel over a halo-extended brick, and the
2-D and 3-D bricks of ``parallel/bricks.py``) and K6-halo (the banded one
over an x-extended slab). All compute classic, eDPD or tDPD pair terms
over the full stencil of a bucket row, without Newton folding, with the
minimum image on every axis. The banded classic kernel K6
(``kernels/pair_dpd.py``) reads the bucket rows in place on one card and
builds no brick; its plain version is still ``brick_forces_plain``.

The brick: every per-row quantity as a channel plane (ny, nz, K, nx) of the
bucket layout, padded by one cell on each side in y and z and by ``xr``
cells on each side in x (2 for spill buckets, 1 for strict ones). On one
card the pads are the periodic copy (``pad_brick``); on the distributed
path the axes named in ``ext`` arrive extended by halo layers received
from the neighbouring ranks and only the others take the periodic copy
(``halo_brick``, as the JAX package's ``_halo_call``). Float channels
(``fb``): x, y, z, vx, vy, vz, then T (eDPD) or the S species of C (tDPD).
Integer channels (``ib``): tag, valid, then, where present, the
per-particle hash (fast RNG tier), the type (more than one type) and the
row's E exclusion tags (classic, special bonds).
"""

from __future__ import annotations

import collections
import math
from dataclasses import dataclass

import torch

from meso_tpu_torch.core import rng as rngmod
from meso_tpu_torch.core.box import Box
from meso_tpu_torch.kernels import _build, cell_tiles
from meso_tpu_torch.kernels import pair_dpd_v3 as v3
from meso_tpu_torch.kernels.common import (check_cuda, half_window,
                                           halo_window, row_specs, tables,
                                           typ_spec)
from meso_tpu_torch.neighbor.bucket_layout import grid_shape, n_rows
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops import edpd as edpdmod
from meso_tpu_torch.ops import tdpd as tdpdmod
from meso_tpu_torch.ops.dpd import pair_force
from meso_tpu_torch.ops.sweep import make_channels

MODELS = {"dpd": 0, "edpd": 1, "tdpd": 2}
# the (T, T) tables each model reads: a, gamma, its third coefficient, rc
TABLES = {"dpd": ("a", "gamma", "sigma", "rc"),
          "edpd": ("a", "gamma", "kappa", "rc"),
          "tdpd": ("a", "gamma", "sigma", "rc")}
_TAG, _VALID = 0, 1

# Each entry point's launches are counted in ``_build.LAUNCHES`` under its
# name (K5: pair_fused_*, K6: pair_banded_dpd, K7: pair_banded_edpd/tdpd,
# K4: pair_halo_*, K6-halo: pair_halo_banded_dpd). Bricks built for CUDA
# launches, by the same entry names, raised by one in ``launch`` and in
# ``halo_forces`` and nowhere else: K6 on one card reads the bucket rows
# and builds none (1 - BUILDS / LAUNCHES is the share of its launches that
# read the rows in place; chip_smoke.py's classic paths read it).
BUILDS: collections.Counter = collections.Counter()

# candidates per group of stencil offsets in the plain version, as in
# pair_dpd_v3's walk
_PLAIN_GROUP_CANDIDATES = 1 << 24


@dataclass(frozen=True)
class Brick:
    """The padded channel planes and where the optional channels sit
    (-1: absent)."""

    fb: torch.Tensor     # (nf, ny + 2, nz + 2, K, nx + 2 xr)
    ib: torch.Tensor     # (ni, ny + 2, nz + 2, K, nx + 2 xr)
    xr: int
    ch_h: int = -1
    ch_typ: int = -1
    ch_ex: int = -1
    n_excl: int = 0


def pad_brick(planes: torch.Tensor, xr: int, ext: tuple = ()) -> torch.Tensor:
    """(C, ny_e, nz_e, K, nx_e) planes -> (C, ny + 2, nz + 2, K, nx + 2 xr):
    each axis not named in ``ext`` takes the periodic copy of its far side
    as pads (values unshifted); the axes in ``ext`` arrive padded."""
    p = planes
    if "x" not in ext:
        p = torch.cat([p[..., -xr:], p, p[..., :xr]], dim=4)
    if "z" not in ext:
        p = torch.cat([p[:, :, -1:], p, p[:, :, :1]], dim=2)
    if "y" not in ext:
        p = torch.cat([p[:, -1:], p, p[:, :1]], dim=1)
    return p.contiguous()


def exclusion_rows(tag: torch.Tensor, params) -> torch.Tensor:
    """(nr, E) exclusion tags of each row's particle (``params.excl[tag]``);
    -1 for a tag outside the table, which excludes nothing."""
    rows = params.excl.shape[0]
    inside = (tag >= 0) & (tag < rows)
    ex = params.excl[torch.clamp(tag, 0, rows - 1).long()]
    return torch.where(inside[:, None], ex, -1)


def build_brick(cfg: CellConfig, xr: int, x, v, tag, mask, field=None,
                h=None, typ=None, ex=None, idtype=torch.int32) -> Brick:
    """The brick of bucket rows, every pad the periodic copy: ``halo_brick``
    of their channel planes with no axis extended. ``field`` is T (nr,) or
    C (nr, S), ``h`` the per-particle hash, ``typ`` the types, ``ex`` the
    (nr, E) exclusion tags; each of the four is left out where None."""
    extra = {}
    if field is not None:
        extra.update({f"F{i}": c for i, c in
                      enumerate(field.reshape(x.shape[0], -1).t())})
    fields = tuple(extra)
    if typ is not None:
        extra["typ"] = typ
    if ex is not None:
        extra.update({f"EX{e}": c for e, c in enumerate(ex.t())})
    ch = make_channels(x, v, tag, mask, h, extra, cfg.ncell, cfg.capacity)
    return halo_brick(ch, cfg, xr, (), fields, ch.get("h"), typ is not None,
                      0 if ex is None else ex.shape[1], idtype)


def halo_brick(channels: dict, cfg: CellConfig, xr: int, ext: tuple,
               fields: tuple, h, typ: bool, n_excl: int,
               idtype=torch.int32) -> Brick:
    """The brick of halo-extended channel planes. ``channels`` maps names
    to (ny_e, nz_e, K, nx_e) planes whose axes named in ``ext`` carry the
    halo layers (x: ``xr`` columns a side, y and z: one layer); the other
    axes take the periodic copy here. Float channels: x, y, z, vx, vy, vz
    and ``fields`` (T, or C0 .. C{S-1}); integer ones: tag, valid (1 or 0
    in any dtype), the hash ``h`` where given, typ where ``typ``, and
    EX0 .. EX{n_excl-1}, each converted to ``idtype``."""
    nx, ny, nz = cfg.ncell
    shape = (ny + 2 * ("y" in ext), nz + 2 * ("z" in ext), cfg.capacity,
             nx + 2 * xr * ("x" in ext))
    fnames = ("x", "y", "z", "vx", "vy", "vz") + tuple(fields)
    inames = ("tag", "valid") + (("typ",) if typ else ()) + tuple(
        f"EX{e}" for e in range(n_excl))
    planes = {n: channels[n] for n in fnames + inames}
    if h is not None:
        planes["h"] = h
    for name, t in planes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"channel {name} has shape {tuple(t.shape)}; "
                             f"ncell={cfg.ncell}, K={cfg.capacity} and "
                             f"ext={ext} need {shape}")
    fb = pad_brick(torch.stack([planes[n].to(torch.float32)
                                for n in fnames]), xr, ext)
    order = ["tag", "valid"] + (["h"] if h is not None else []) + list(
        inames[2:])
    ib = pad_brick(torch.stack([planes[n].to(idtype) for n in order]), xr,
                   ext)
    return Brick(fb=fb, ib=ib, xr=xr, ch_h=2 if h is not None else -1,
                 ch_typ=order.index("typ") if typ else -1,
                 ch_ex=order.index("EX0") if n_excl else -1, n_excl=n_excl)


def halo_forces(model: str, name: str, channels: dict, box: Box, step: int,
                params, dt: float, cfg: CellConfig, ext: tuple,
                rng_mode: str, rng_rounds: int, fields: tuple = (),
                n_excl: int = 0):
    """A halo entry point's pair terms over the brick of halo-extended
    planes (``halo_brick``), whose target cells are ``cfg.ncell``: on CPU
    planes, and only there, ``halo_forces_plain``; on CUDA planes one
    ``launch_brick`` counted under ``name``; on any other device it
    raises. The fast tier reads the per-particle hash plane "h" of the
    channels (the distributed step hashes its local rows once a step and
    ships "h" with the halo, as the TPU's K6-halo does).
    Returns (f (nr, 3), dT/dt, dC/dt or None, virial)."""
    tag = channels["tag"]
    if tag.device.type == "cpu":
        return halo_forces_plain(model, channels, box, step, params, dt, cfg,
                                 ext, rng_mode, rng_rounds, fields, n_excl)
    xr = halo_window(cfg, ext, rng_mode)
    _build.load_library()   # no brick is built where no kernel can run
    if tag.device.type != "cuda":
        raise ValueError(f"channel tag is on {tag.device}; the halo "
                         "kernels take CPU (plain version) or CUDA planes")
    brick = _check_hash(halo_brick(channels, cfg, xr, ext, fields,
                                 channels.get("h") if rng_mode == "fast"
                                 else None, params.n_types > 1, n_excl),
                      rng_mode)
    BUILDS[name] += 1
    return launch_brick(model, name, brick, box, step, params, dt, cfg,
                        rng_mode, rng_rounds)


def halo_forces_plain(model: str, channels: dict, box: Box, step: int,
                      params, dt: float, cfg: CellConfig, ext: tuple,
                      rng_mode: str, rng_rounds: int, fields: tuple = (),
                      n_excl: int = 0):
    """The plain version of ``halo_forces``, on planes of any device: the
    same brick with int64 integer channels, walked by ``plain_brick``."""
    xr = halo_window(cfg, ext, rng_mode)
    brick = _check_hash(halo_brick(channels, cfg, xr, ext, fields,
                                 channels.get("h") if rng_mode == "fast"
                                 else None, params.n_types > 1, n_excl,
                                 idtype=torch.int64), rng_mode)
    return plain_brick(model, brick, box, step, params, dt, cfg, rng_mode,
                       rng_rounds)


def _check_hash(brick: Brick, rng_mode: str) -> Brick:
    """The brick, refused where the fast tier finds no hash plane "h" in
    the halo channels (``rng.particle_hash`` of each row's tag at the
    step, held as uint32 values)."""
    if rng_mode == "fast" and brick.ch_h < 0:
        raise ValueError("the fast RNG tier reads the per-particle hash "
                         "plane 'h' among the halo channels")
    return brick


def _inputs(model: str, params, x, typ, tag, field):
    """(field, typ, exclusion rows) as the brick takes them."""
    nr = x.shape[0]
    if model == "tdpd" and field.shape != (nr, params.n_species):
        raise ValueError(f"C has shape {tuple(field.shape)}, expected "
                         f"{(nr, params.n_species)}")
    ex = None
    if model == "dpd" and params.excl is not None:
        ex = exclusion_rows(tag, params)
    return (field, typ if params.n_types > 1 else None, ex)


def launch(model: str, name: str, x, v, field, typ, tag, mask, box: Box,
           step: int, params, dt: float, cfg: CellConfig, rng_mode: str,
           rng_rounds: int):
    """One launch of the pair_brick kernel on CUDA tensors: ``card_brick``
    (the hash and the brick, counted in ``BUILDS[name]``), then
    ``launch_brick``, counted under ``name``. Returns (f (nr, 3), the
    field's rate (dT/dt, dC/dt) or None, virial)."""
    brick = card_brick(model, x, v, field, typ, tag, mask, box, step, params,
                       cfg, rng_mode, rng_rounds)
    BUILDS[name] += 1
    return launch_brick(model, name, brick, box, step, params, dt, cfg,
                        rng_mode, rng_rounds)


def card_brick(model: str, x, v, field, typ, tag, mask, box: Box, step: int,
               params, cfg: CellConfig, rng_mode: str, rng_rounds: int):
    """The brick of CUDA bucket rows: the inputs checked, the per-particle
    hash (fast tier, one launch of particle_hash) and ``build_brick``."""
    nr = n_rows(cfg)
    specs = {**row_specs(nr, x, v, tag, mask, box),
             **typ_spec(params, nr, typ)}
    if model == "edpd":
        specs["t"] = (field, torch.float32, (nr,))
    elif model == "tdpd":
        specs["c"] = (field, torch.float32, (nr, params.n_species))
    elif params.excl is not None:
        specs["excl"] = (params.excl, torch.int32, None)
    check_cuda(specs)
    h = None if rng_mode == "tea" else v3.launch_hash(
        tag, step & 0xFFFFFFFF, params.seed, rng_rounds)
    fld, typ_b, ex = _inputs(model, params, x, typ, tag, field)
    return build_brick(cfg, half_window(cfg, rng_mode), x, v, tag, mask,
                       field=fld, h=h, typ=typ_b, ex=ex)


def launch_brick(model: str, name: str, brick: Brick, box: Box,
                 step: int, params, dt: float, cfg: CellConfig,
                 rng_mode: str, rng_rounds: int):
    """One launch of pair_brick_kernel over a built brick on the card,
    whose target cells are ``cfg.ncell``, on the cell tiles of
    ``cell_tiles.brick_plan`` (a capacity no tile fits raises
    ``ValueError``), counted as ``name``.
    Returns (f (nr, 3), dT/dt, dC/dt or None, virial)."""
    specs = {"fb": (brick.fb, torch.float32, None),
             "ib": (brick.ib, torch.int32, None),
             "box.lo": (box.lo, torch.float32, (3,)),
             "box.hi": (box.hi, torch.float32, (3,)),
             **tables(params, TABLES[model])}
    tdpd = model == "tdpd"
    if tdpd:
        ns = params.n_species
        specs.update(kappa_c=(params.kappa_c, torch.float32, (ns,)),
                     eps_c=(params.eps_c, torch.float32, (ns,)))
    elif model == "dpd" and brick.n_excl:
        specs["excl_w"] = (params.excl_w, torch.float32, ())
    check_cuda(specs)
    nr = n_rows(cfg)
    dev = brick.fb.device
    f = torch.empty((nr, 3), dtype=torch.float32, device=dev)
    vir = torch.empty((nr,), dtype=torch.float32, device=dev)
    extra = None
    if model == "edpd":
        extra = torch.empty((nr,), dtype=torch.float32, device=dev)
    elif tdpd:
        extra = torch.empty((nr, params.n_species), dtype=torch.float32,
                            device=dev)
    a, gamma, x3, rc = (getattr(params, n) for n in TABLES[model])
    nx, ny, nz = cfg.ncell
    plan = cell_tiles.brick_plan(cfg.capacity, brick.xr, cfg.ncell)
    table = cell_tiles.table_on(plan, dev, cell_tiles.brick_table)
    excl_w = params.excl_w if model == "dpd" and brick.n_excl else None
    _build.launch(
        name, "meso_pair_brick", MODELS[model], int(rng_mode == "tea"),
        brick.fb.data_ptr(), brick.ib.data_ptr(),
        box.lo.data_ptr(), box.hi.data_ptr(), a.data_ptr(), gamma.data_ptr(),
        x3.data_ptr(), rc.data_ptr(), params.n_types, brick.ch_h,
        brick.ch_typ, brick.ch_ex, brick.n_excl,
        None if excl_w is None else excl_w.data_ptr(),
        params.n_species if tdpd else 0,
        params.kappa_c.data_ptr() if tdpd else None,
        params.eps_c.data_ptr() if tdpd else None, f.data_ptr(),
        None if extra is None else extra.data_ptr(), vir.data_ptr(),
        nx, ny, nz, cfg.capacity, brick.xr, table.data_ptr(), plan.width,
        plan.n_blocks, plan.threads, plan.list_cap, plan.smem_bytes,
        1.0 / math.sqrt(dt),
        getattr(params, "s_exp", 1.0),
        params.mass if model == "edpd" else 1.0,
        params.cv if model == "edpd" else 1.0,
        params.rcc if tdpd else 0.0, params.s1 if tdpd else 1.0,
        step & 0xFFFFFFFF, params.seed, rng_rounds, device=dev)
    return f, extra, torch.sum(vir)


def forces(model: str, name: str, x, v, field, typ, tag, mask, box: Box,
           step: int, params, dt: float, cfg: CellConfig, rng_mode: str,
           rng_rounds: int):
    """An entry point's pair terms: ``brick_forces_plain`` on CPU tensors,
    and only there; on any other, one ``launch`` counted under ``name``.
    Returns (f, virial) for classic DPD, (f, dT/dt or dC/dt, virial) for
    the transport models."""
    if x.device.type == "cpu":
        out = brick_forces_plain(model, x, v, field, typ, tag, mask, box,
                                 step, params, dt, cfg, rng_mode, rng_rounds)
    else:
        out = launch(model, name, x, v, field, typ, tag, mask, box, step,
                     params, dt, cfg, rng_mode, rng_rounds)
    return (out[0], out[2]) if model == "dpd" else out


def _brick_pairs(brick: Brick, cfg: CellConfig, box: Box, rc2):
    """The candidate walk of the plain version over the brick. Per group of
    stencil offsets it slices the source planes out of the brick (no index
    wraps, as in the kernel), takes the minimum image on every axis, and
    yields the in-range pairs (0 < r2 < rc2): (target row, target's brick
    index, source's brick index, [dx, dy, dz], r2), dr = x_target -
    x_source, r2 summed in x, y, z order."""
    ny, nz, k, nx = grid_shape(cfg)
    xr = brick.xr
    pz, px = nz + 2, nx + 2 * xr
    lens = box.lengths
    inv_l = 1.0 / lens
    dev = brick.fb.device

    def interior(t):
        return t[1:ny + 1, 1:nz + 1, :, xr:xr + nx]

    def tgt(t):   # (1, ny, nz, K, 1, nx): target slot axis
        return interior(t)[None, :, :, :, None, :]

    valid = brick.ib[_VALID] != 0
    offsets = [(dy, dz, dx) for dy in range(3) for dz in range(3)
               for dx in range(2 * xr + 1)]
    group = max(1, _PLAIN_GROUP_CANDIDATES // (ny * nz * k * k * nx))
    for g0 in range(0, len(offsets), group):
        offs = offsets[g0:g0 + group]

        def src(t):   # (G, ny, nz, 1, K, nx): source slot axis
            return torch.stack([t[dy:dy + ny, dz:dz + nz, :, dx:dx + nx]
                                for dy, dz, dx in offs])[:, :, :, None]

        dr = []
        for c in range(3):
            d = tgt(brick.fb[c]) - src(brick.fb[c])
            dr.append(d - torch.round(d * inv_l[c]) * lens[c])
        r2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        ok = tgt(valid) & src(valid) & (r2 < rc2) & (r2 > 0.0)
        g, cy, cz, kt, ks, cx = ok.nonzero(as_tuple=True)
        o = torch.tensor(offs, dtype=torch.int64, device=dev)[g]
        row = ((cy * nz + cz) * k + kt) * nx + cx
        tb = (((cy + 1) * pz + cz + 1) * k + kt) * px + cx + xr
        sb = (((cy + o[:, 0]) * pz + cz + o[:, 1]) * k + ks) * px \
            + cx + o[:, 2]
        yield (row, tb, sb, [d[g, cy, cz, kt, ks, cx] for d in dr],
               r2[g, cy, cz, kt, ks, cx])


def brick_forces_plain(model: str, x, v, field, typ, tag, mask, box: Box,
                       step: int, params, dt: float, cfg: CellConfig,
                       rng_mode: str = "fast", rng_rounds: int = 8):
    """The pair_brick kernel's function in plain torch, from the same brick
    (``build_brick``, integer channels in int64), walked by
    ``plain_brick``. Returns (f (nr, 3), dT/dt, dC/dt or None, virial)."""
    fld, typ_b, ex = _inputs(model, params, x, typ, tag, field)
    h = (rngmod.particle_hash(tag, step, params.seed, rounds=rng_rounds)
         if rng_mode == "fast" else None)
    brick = build_brick(cfg, half_window(cfg, rng_mode), x, v, tag, mask,
                        field=fld, h=h, typ=typ_b, ex=ex, idtype=torch.int64)
    return plain_brick(model, brick, box, step, params, dt, cfg, rng_mode,
                       rng_rounds)


def plain_brick(model: str, brick: Brick, box: Box, step: int, params,
                dt: float, cfg: CellConfig, rng_mode: str = "fast",
                rng_rounds: int = 8):
    """The kernel's function over a built brick whose target cells are
    ``cfg.ncell``: the ``_brick_pairs`` walk out to the table's largest
    rc, the pairs inside their own rc_ij, and the model's pair terms
    (``ops.dpd``'s force with s_exp and the special-bonds weight,
    ``ops.edpd.edpd_pair``, or ``ops.dpd.pair_force`` with
    ``ops.tdpd.tdpd_flux``), summed into their target rows. Returns
    (f (nr, 3), dT/dt, dC/dt or None, virial)."""
    nr = n_rows(cfg)
    dev = brick.fb.device
    fbf = brick.fb.reshape(brick.fb.shape[0], -1)
    ibf = brick.ib.reshape(brick.ib.shape[0], -1)
    nt = params.n_types
    tabs = [getattr(params, n).reshape(-1) for n in TABLES[model]]
    rc_t = tabs[3]
    dt_inv_sqrt = 1.0 / math.sqrt(dt)
    f = torch.zeros((nr, 3), dtype=torch.float32, device=dev)
    vir = torch.zeros((nr,), dtype=torch.float32, device=dev)
    extra = None
    if model == "edpd":
        extra = torch.zeros((nr,), dtype=torch.float32, device=dev)
    elif model == "tdpd":
        extra = torch.zeros((nr, params.n_species), dtype=torch.float32,
                            device=dev)
    for row, tb, sb, d, r2 in _brick_pairs(brick, cfg, box,
                                           torch.max(rc_t) ** 2):
        if nt > 1:
            p = (ibf[brick.ch_typ, tb] * nt + ibf[brick.ch_typ, sb])
            keep = r2 < rc_t[p] * rc_t[p]
            row, tb, sb, p, r2 = (t[keep] for t in (row, tb, sb, p, r2))
            d = [dc[keep] for dc in d]
        else:
            p = 0
        coef = [tab[p] for tab in tabs]
        tag_i, tag_j = ibf[_TAG, tb], ibf[_TAG, sb]
        if rng_mode == "fast":
            hp = rngmod.combine_symmetric(ibf[brick.ch_h, tb],
                                          ibf[brick.ch_h, sb])
        else:
            hp = rngmod.pair_hash_tea(tag_i, tag_j, step, params.seed,
                                      rounds=rng_rounds)
        dr = torch.stack(d, -1)
        vij = (fbf[3:6, tb] - fbf[3:6, sb]).t()
        if model == "dpd":
            f_p, vir_p = _classic_pair(params, brick, ibf, tb, tag_j, hp, dr,
                                       vij, r2, coef, dt_inv_sqrt)
        elif model == "edpd":
            theta, zeta = edpdmod.noises_from_hash(hp, tag_i, tag_j)
            f_p, q_p, vir_p = edpdmod.edpd_pair(
                dr, vij, fbf[6, tb], fbf[6, sb], theta, zeta, coef[0],
                coef[1], coef[3], coef[2], params.mass, dt_inv_sqrt)
            extra.index_add_(0, row, q_p)
        else:
            theta, xi = tdpdmod.noises_from_hash(hp, tag_i, tag_j,
                                                 params.n_species)
            f_p, vir_p = pair_force(dr, vij, theta, *coef, dt_inv_sqrt,
                                    params.s_exp)
            c = fbf[6:]
            q_p = tdpdmod.tdpd_flux(dr, c[:, tb].t(), c[:, sb].t(), xi,
                                    params.kappa_c, params.eps_c, params.rcc,
                                    params.s1, dt_inv_sqrt, True)
            extra.index_add_(0, row, q_p)
        f.index_add_(0, row, f_p)
        vir.index_add_(0, row, vir_p)
    if model == "edpd":
        extra = extra / params.cv
    return f, extra, torch.sum(vir)


def _classic_pair(params, brick: Brick, ibf, tb, tag_j, hp, dr, vij, r2,
                  coef, dt_inv_sqrt: float):
    """Classic force and half virial of in-range pairs, with s_exp and the
    special-bonds weight read from the brick's exclusion channels."""
    a, gamma, sigma, rc = coef
    rinv = torch.rsqrt(r2)
    rr = r2 * rinv
    w = 1.0 - rr * (1.0 / rc)
    ev = torch.sum(dr * vij, dim=-1) * rinv
    fmag = v3.classic_fmag(w, ev, rngmod._u32_to_symmetric_uniform(hp), a,
                           gamma, sigma * dt_inv_sqrt, params.s_exp)
    if brick.n_excl:
        ex_i = ibf[brick.ch_ex:brick.ch_ex + brick.n_excl, tb]
        hit = torch.any(ex_i == tag_j[None, :], dim=0)
        fmag = torch.where(hit, fmag * params.excl_w, fmag)
    return (fmag * rinv)[:, None] * dr, 0.5 * fmag * rr
