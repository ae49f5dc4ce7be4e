"""The brick decompositions' machinery, generic over the decomposed axes:
the port of what ``meso_tpu/parallel/domain2d.py`` and ``domain3d.py``
share (the 3-D module imports ``_migrate_axis`` from the 2-D one and
copies the rest, axis for axis). ``parallel/domain2d.py`` and
``domain3d.py`` hold the public names. The 1-D slabs
(``parallel/domain.py``) place their rows and split a start with the
same functions, x their one decomposed axis.

A rank owns a brick of the box: its slab along each decomposed axis (x, y
and, in 3-D, z), every other axis whole, as bucket rows indexed in the
brick's frame. A ``comm.Mesh`` gives each decomposed axis its ring. As in
the JAX package:

* migration is sequential, x then y (then z), through fixed-capacity
  buffers: a corner crosser reaches its owner in one hop an axis; overflow
  is counted, never hidden;
* the halo exchange is sequential too: x first (``xr`` columns a side: 2
  for spill buckets, where a cell's rows may sit in the next cell's
  block), then one layer along y of the x-extended planes, then along z of
  the xy-extended ones, so that edge and corner ghosts ride the later
  exchanges; the links across the periodic boundary carry coordinates
  shifted by the box length;
* classic DPD on force_path "pallas" makes one K4 call a step over the
  extended brick (``halo_forces_pallas_fused`` with ``ext`` the decomposed
  axes); every other model and path runs the 27-offset sweep
  (``ops/sweep.py``) with those axes halo-padded, strict buckets only.
  There is no border/inner split (``dd_overlap`` is ignored here), as in
  the JAX package.

Where the JAX package's brick steps differ from its single-card step, the
port keeps the single-card behaviour: the fixes' post_integrate and
end_of_step hooks run (ROADMAP Queue 3, R11), FixMomentumZero and the
membrane scalars sum over the whole mesh (R12's shape), special-bonds
exclusions reach K4 and the sweep (R15), the sweep draws the system's RNG
tier (R13's shape), and an axis of one rank moves nothing (R10).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from meso_tpu_torch.core.state import State, zeros_state
from meso_tpu_torch.core.system import _FIT_EXTRA_SLOTS, System, SystemParams
from meso_tpu_torch.neighbor.bucket_layout import (n_rows, place_rows,
                                                    slot_targets)
from meso_tpu_torch.neighbor.cells import CellConfig, max_displacement_sq
from meso_tpu_torch.ops.bucket_dpd import exclusion_channels, fast_hash
from meso_tpu_torch.parallel.comm import Mesh
from meso_tpu_torch.parallel.domain import _f32, _migrate_axis, step_with

AXES = ("x", "y", "z")
# each axis's position in a particle's coordinates and in a channel plane
# (ny, nz, K, nx)
COORD = {"x": 0, "y": 1, "z": 2}
PLANE_DIM = {"x": 3, "y": 0, "z": 1}


def check_bricks(system: System, devs: tuple) -> CellConfig:
    """The local CellConfig of ``devs`` ranks along the leading axes, with
    the JAX package's refusals: the global grid divisible by the mesh, at
    least 3 cell columns a rank on each decomposed axis, and 5 along x
    under spill (2-column halos and a column inside)."""
    g = system.cells
    if any(n % d for n, d in zip(g.ncell, devs)):
        raise ValueError(f"global ncell {g.ncell} not divisible by mesh "
                         f"{tuple(devs)}")
    local = [n // d for n, d in zip(g.ncell, devs)] + list(
        g.ncell[len(devs):])
    if min(local[:len(devs)]) < 3:
        raise ValueError("bricks need >= 3 cell columns per device per axis")
    spill = bool(g.spill)
    if spill and local[0] < 5:
        raise ValueError("spill layout under DD needs >= 5 local cell "
                         "columns per brick along x")
    return CellConfig(ncell=tuple(local), capacity=g.capacity, skin=g.skin,
                      rebuild_every=g.rebuild_every, spill=spill)


def origins_of(dcfg, coords: dict) -> dict:
    """The float32 origin of the brick at mesh ``coords`` on each
    decomposed axis, as the JAX step computes it (the float32 product of
    the index and the slab width)."""
    return {a: _f32(np.float32(coords[a]) * np.float32(w))
            for a, w in zip(dcfg.axes, dcfg.slab_widths)}


def sides_of(dcfg) -> dict:
    """The cell side on each decomposed axis."""
    return {a: w / dcfg.cells.ncell[COORD[a]]
            for a, w in zip(dcfg.axes, dcfg.slab_widths)}


# ---------------------------------------------------------------------------
# local rebuild (brick frame)
# ---------------------------------------------------------------------------

def rebuild_brick(state: State, cfg: CellConfig, origins: dict,
                  sides: dict):
    """rebuild_buckets with the cells of each decomposed axis (the keys of
    ``origins``) indexed from the brick's origin, the other axes from the
    box's: the keys in that frame, then ``slot_targets`` and
    ``place_rows``, for any number of input rows. Spill buckets spill right
    within the brick only (``wrap=False``): its first and last columns sit
    in different x-windows, and the halo ships only the boundary columns.
    Returns (state of n_rows(cfg) rows, overflow)."""
    x = state.x
    lens = state.box.lengths
    nx, ny, nz = cfg.ncell
    cells = []
    for a, n in zip(AXES, cfg.ncell):
        d = COORD[a]
        if a in origins:
            c = (x[:, d] - origins[a]) / sides[a]
        else:
            c = x[:, d] / lens[d] * n
        cells.append(torch.clamp(c.to(torch.int32), 0, n - 1)
                     .to(torch.int64))
    cx, cy, cz = cells
    key = torch.where(state.mask, (cy * nz + cz) * nx + cx, nx * ny * nz)
    order, target, fits, overflow, _ = slot_targets(key, cfg, wrap=False)
    return place_rows(state, order, target, fits, n_rows(cfg)), overflow


# ---------------------------------------------------------------------------
# halo exchange and force evaluation
# ---------------------------------------------------------------------------

def exchange_halos(channels: dict, dcfg, mesh: Mesh) -> dict:
    """The channel planes extended along each decomposed axis in turn
    (x: ``xr`` columns a side, y and z: one layer), each axis's layers
    taken from the planes the earlier axes extended; the coordinate
    channel of an axis ("x", "y", "z") shifted by the box length on the
    links across the periodic boundary. An axis of one rank takes its own
    far side."""
    xr = 2 if dcfg.cells.spill else 1
    names = list(channels)
    out = dict(channels)
    for a, n_dev, span in zip(dcfg.axes, dcfg.devs, dcfg.spans):
        ring = mesh.ring(a)
        dim, w = PLANE_DIM[a], (xr if a == "x" else 1)
        got = ring.exchange({
            1: [out[nm].narrow(dim, out[nm].shape[dim] - w, w)
                for nm in names],
            -1: [out[nm].narrow(dim, 0, w) for nm in names]}).wait()
        lo, hi = dict(zip(names, got[1])), dict(zip(names, got[-1]))
        if a in lo:
            if ring.rank == 0:
                lo[a] = lo[a] - _f32(span)
            if ring.rank == n_dev - 1:
                hi[a] = hi[a] + _f32(span)
        out = {nm: torch.cat([lo[nm], out[nm], hi[nm]], dim=dim)
               for nm in names}
    return out


def _channels(state: State, system: System, params: SystemParams,
              cfg: CellConfig, step: int, x, v, extra: dict,
              excl: bool) -> dict:
    """The local channel planes a force evaluation ships: positions,
    velocities, tags, validity, the fast tier's per-particle hash, the
    model's field planes, the types (more than one) and, with ``excl``,
    the exclusion tags."""
    from meso_tpu_torch.ops.sweep import make_channels
    pair = params.pair
    ch = make_channels(x, v, state.tag, state.mask,
                       fast_hash(state.tag, step, pair, system.rng_mode,
                                 system.rng_rounds),
                       extra, cfg.ncell, cfg.capacity)
    if pair.n_types > 1:
        ch["typ"] = state.typ.reshape(ch["tag"].shape)
    if excl:
        ch.update(exclusion_channels(state.tag, pair, ch["tag"].shape))
    return ch


def k4_forces(state: State, system: System, params: SystemParams, dcfg,
              mesh: Mesh, step: int, x, v):
    """Classic forces on K4: the halo exchange of every channel (the hash
    and the exclusion tags included), then one ``halo_forces_pallas_fused``
    call over the brick extended along every decomposed axis. Returns
    (f, virial)."""
    from meso_tpu_torch.kernels.pair_dpd_fused import halo_forces_pallas_fused
    cfg, pair = dcfg.cells, params.pair
    n_excl = 0 if pair.excl is None else pair.excl.shape[1]
    padded = exchange_halos(_channels(state, system, params, cfg, step, x,
                                      v, {}, True), dcfg, mesh)
    return halo_forces_pallas_fused(
        padded, state.box, step, pair, system.dt, cfg, ext=dcfg.axes,
        rng_mode=system.rng_mode, rng_rounds=system.rng_rounds,
        s_exp=system.s_exp, n_types=pair.n_types, n_excl=n_excl)


def sweep_forces(state: State, system: System, params: SystemParams, dcfg,
                 mesh: Mesh, step: int, x, v, t=None, c=None):
    """Any model through the 27-offset sweep over the brick extended along
    the decomposed axes (strict buckets only), in the system's RNG tier,
    with types, s_exp and, for classic DPD, exclusions. Returns (f, aux
    with the virial and dTdt or dCdt)."""
    from meso_tpu_torch.ops.sweep import (classic_pair_fn, edpd_pair_fn,
                                          sweep, tdpd_pair_fn)
    cfg, pair = dcfg.cells, params.pair
    if cfg.spill:
        raise ValueError(
            "the distributed sweep cannot read a spill layout: bricks take "
            "spill buckets on the classic fused-kernel path "
            "(force_path='pallas') only")
    kw = dict(rng_mode=system.rng_mode, step=step,
              rng_rounds=system.rng_rounds)
    multitype = pair.n_types > 1
    extra = {}
    if system.model == "edpd":
        extra["T"] = t
        pair_fn = edpd_pair_fn(pair, system.dt, multitype, **kw)
        n_out = 5
    elif system.model == "tdpd":
        if pair.rcc > pair.rc_max:
            raise ValueError(
                "the tDPD sweep requires rcc <= rc (rc-based stencil): "
                f"rcc={pair.rcc}, rc={pair.rc_max}")
        ns = pair.n_species
        extra.update({f"C{s}": c[:, s] for s in range(ns)})
        pair_fn = tdpd_pair_fn(pair, system.dt, ns, multitype, **kw)
        n_out = 4 + ns
    else:
        pair_fn = classic_pair_fn(
            pair, system.dt, multitype=multitype,
            n_excl=0 if pair.excl is None else pair.excl.shape[1], **kw)
        n_out = 4
    padded = exchange_halos(
        _channels(state, system, params, cfg, step, x, v, extra,
                  system.model == "dpd"), dcfg, mesh)
    halo = ("y" in dcfg.axes, "z" in dcfg.axes, True)
    acc = sweep(padded, cfg.ncell, cfg.capacity, halo, state.box.lengths,
                pair_fn, n_out)
    f = torch.stack([a.reshape(-1) for a in acc[:3]], dim=-1)
    aux = {"virial": torch.sum(acc[3])}
    if system.model == "edpd":
        aux["dTdt"] = acc[4].reshape(-1) / pair.cv
    elif system.model == "tdpd":
        aux["dCdt"] = torch.stack([a.reshape(-1) for a in acc[4:]], dim=-1)
    return f, aux


def brick_forces(state: State, system: System, params: SystemParams, dcfg,
                 mesh: Mesh, step: int, x, v, t=None, c=None):
    """The force evaluation of a brick step, routed as the JAX package
    routes it: classic DPD on force_path "pallas" through K4, everything
    else through the sweep. Returns (f, aux)."""
    if system.model == "dpd" and system.force_path == "pallas":
        f, virial = k4_forces(state, system, params, dcfg, mesh, step, x, v)
        return f, {"virial": virial}
    return sweep_forces(state, system, params, dcfg, mesh, step, x, v, t, c)


def bonded_bricks(system: System, params: SystemParams, dcfg, mesh: Mesh,
                  state: State, x1, image1):
    """Bonded forces over the brick extended by ``reach`` cell layers (1
    for chains, 2 with angles, hinges or triangles) of (x, image, tag,
    mask) along each decomposed axis of more than one rank, in turn (edges
    and corners ride the later exchanges), evaluated in tag space where
    each partner's owner keeps its own side; the membrane scalars sum over
    the whole mesh. Returns (f on local rows, missing-partner count)."""
    from meso_tpu_torch.ops.bonded import bonded_forces_ext
    cfg = dcfg.cells
    nx, ny, nz = cfg.ncell
    k = cfg.capacity
    b = params.bonded
    reach = 2 if (b.hinge_tags is not None or b.tri_tags is not None
                  or b.angle_tags is not None) else 1
    # an axis of one rank holds every partner along it: no ghosts there,
    # whose copies of the rank's own rows would shadow them in the tag map
    ext = [a for a, n in zip(dcfg.axes, dcfg.devs) if n > 1]
    reach = min([reach] + [cfg.ncell[COORD[a]] for a in ext])
    planes = [a.reshape((ny, nz, k, nx) + a.shape[1:])
              for a in (x1, image1, state.tag, state.mask.to(torch.int32))]
    owner = torch.ones((ny, nz, k, nx), dtype=torch.bool, device=x1.device)
    for a in ext:
        dim = PLANE_DIM[a]
        got = mesh.ring(a).exchange({
            1: [p.narrow(dim, p.shape[dim] - reach, reach) for p in planes],
            -1: [p.narrow(dim, 0, reach) for p in planes]}).wait()
        planes = [torch.cat([lo, p, hi], dim=dim)
                  for p, lo, hi in zip(planes, got[1], got[-1])]
        pad = list(owner.shape)
        pad[dim] = reach
        no = torch.zeros(pad, dtype=torch.bool, device=x1.device)
        owner = torch.cat([no, owner, no], dim=dim)
    shape = planes[0].shape[:4]
    gx, gimg, gtag, gmask = (p.reshape((-1,) + p.shape[4:]) for p in planes)
    f_ext, missing = bonded_forces_ext(
        gx, gtag, gmask > 0, state.box, b, system.bond_style, system.n_tags,
        system.n_mols, image=gimg,
        owner_mask=owner.reshape(-1) if ext else None,
        reduce_sum=mesh.all_sum)
    f = f_ext.reshape(shape + (3,))
    for a in ext:
        dim = PLANE_DIM[a]
        f = f.narrow(dim, reach, f.shape[dim] - 2 * reach)
    return f.reshape(-1, 3), missing


def step_bricks(system: System, params: SystemParams, dcfg, mesh: Mesh,
                state: State):
    """One brick step (the single-card step's hooks and order,
    ``domain.step_with``). Returns (new_state, bonded-missing count)."""
    return step_with(
        system, params, state,
        lambda x1, v_tilde, step: brick_forces(
            state, system, params, dcfg, mesh, step, x1, v_tilde, state.T,
            state.C),
        lambda x1, image1: bonded_bricks(system, params, dcfg, mesh, state,
                                         x1, image1),
        mesh.all_sum)


def run_bricks(system: System, params: SystemParams, state: State,
               nchunks: int, mesh: Mesh, dcfg):
    """This rank's share of ``nchunks`` x (migration along each decomposed
    axis in turn, brick rebuild, ``rebuild_every`` steps), as the JAX
    package's ``shard_body``. ``state`` is this rank's brick (from the
    distribute function) on the rank's device; ``mesh`` has the decomposed
    axes' names. The counters are summed over the mesh once a chunk.
    Returns (state, diag): the largest per-chunk "overflow" (migration and
    bucket) and "bonded_missing" counts over the mesh, and
    "worst_skin_ratio", the largest displacement since a rebuild over
    every rank, over skin/2."""
    origins = origins_of(dcfg, mesh.coords)
    sides = sides_of(dcfg)
    counts, disps = [], []
    for _ in range(nchunks):
        overflow = torch.zeros((), dtype=torch.int64, device=state.device)
        for a, w in zip(dcfg.axes, dcfg.slab_widths):
            state, of = _migrate_axis(state, mesh.ring(a),
                                      state.x[:, COORD[a]], w, dcfg.cap_mig)
            overflow = overflow + of
        state, of_cell = rebuild_brick(state, dcfg.cells, origins, sides)
        x_ref = state.x
        misses = []
        for _ in range(dcfg.rebuild_every):
            state, miss = step_bricks(system, params, dcfg, mesh, state)
            misses.append(miss.to(torch.int64))
        counts.append(mesh.all_sum(torch.stack(
            [overflow + of_cell, torch.max(torch.stack(misses))])))
        disps.append(mesh.all_max(max_displacement_sq(
            state.x, x_ref, state.mask, state.box)))
    counts = torch.max(torch.stack(counts), dim=0).values
    return state, {"overflow": counts[0], "bonded_missing": counts[1],
                   "worst_skin_ratio": torch.sqrt(torch.max(
                       torch.stack(disps))) / (0.5 * dcfg.cells.skin)}


# ---------------------------------------------------------------------------
# host-side distribute
# ---------------------------------------------------------------------------

def bricks_of(state: State, dcfg, device):
    """(per-rank brick states in the mesh's row-major rank order, the
    bucket overflow of each), each bucket-ordered in its brick's frame, as
    the JAX package's distribute functions place them."""
    nr_local = n_rows(dcfg.cells)
    mask = state.mask.cpu().numpy()
    x = state.x.cpu().numpy()
    owner = {a: np.clip((x[:, COORD[a]] / w).astype(int), 0, n - 1)
             for a, w, n in zip(dcfg.axes, dcfg.slab_widths, dcfg.devs)}
    box = state.box.replace(lo=state.box.lo.to(device),
                            hi=state.box.hi.to(device))
    sides = sides_of(dcfg)
    out, overflow = [], []
    for index in itertools.product(*(range(n) for n in dcfg.devs)):
        sel = mask.copy()
        for a, i in zip(dcfg.axes, index):
            sel &= owner[a] == i
        idx = torch.from_numpy(np.where(sel)[0])
        if len(idx) > nr_local:
            raise ValueError(f"brick {index}: {len(idx)} rows > {nr_local}")
        local = zeros_state(nr_local, box, n_species=0 if state.C is None
                            else state.C.shape[1],
                            with_energy=state.T is not None)

        def take(a):
            if a is None:
                return None
            got = a.cpu()[idx]
            fill = torch.zeros((nr_local - len(idx),) + got.shape[1:],
                               dtype=got.dtype)
            return torch.cat([got, fill]).to(device)

        local = local.replace(
            **{f: take(getattr(state, f)) for f in
               ("x", "v", "f", "typ", "tag", "image", "mol", "T", "C")},
            mask=torch.arange(nr_local, device=device) < len(idx),
            step=state.step)
        # the JAX package's origin here is float32(index * width)
        origins = {a: _f32(i * w) for a, i, w in
                   zip(dcfg.axes, index, dcfg.slab_widths)}
        local, of = rebuild_brick(local, dcfg.cells, origins, sides)
        out.append(local)
        overflow.append(int(of))
    return out, overflow


def distribute_bricks(state: State, dcfg, device="cuda") -> list[State]:
    """Split a global state into per-rank brick states (rank order, on
    ``device``: the card unless the caller names another). Raises where a
    brick's buckets overflow."""
    bricks, overflow = bricks_of(state, dcfg, device)
    for r, of in enumerate(overflow):
        if of:
            raise ValueError(f"brick {r}: bucket overflow {of}")
    return bricks


def fit_brick_capacity(system: System, state: State, build) -> System:
    """The system with the least bucket capacity, from its own up to
    ``_FIT_EXTRA_SLOTS`` more, whose bricks (``build(system)``: the
    domain config) place this start with no overflow (a
    right-spill brick cannot spill its last column into its first). Where
    none fits, the system comes back unchanged and the distribute function
    raises."""
    cfg = system.cells
    for k in range(cfg.capacity, cfg.capacity + _FIT_EXTRA_SLOTS + 1):
        fitted = system.replace(cells=cfg.replace(capacity=k))
        if not any(bricks_of(state, build(fitted), state.device)[1]):
            return fitted
    return system
