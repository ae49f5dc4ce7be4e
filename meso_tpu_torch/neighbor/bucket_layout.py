"""Bucket-resident state layout (port of
``meso_tpu/neighbor/bucket_layout.py``).

The state rows themselves are the cell buckets:

    row = ((cy * ncz + cz) * K + slot) * ncx + cx

so the per-particle tensors reshape without a copy to planes
(ncy, ncz, K, ncx). Padding slots (mask False) carry zeros. Capacity
overflow (more particles than a cell and its spill room hold) is counted
and checked, never hidden.

A rebuild is one placement, for any number of input rows: the cell keys
with the deferred wrap (``cell_keys``), one stable ``torch.sort`` of them,
the slot assignment in sorted space (``slot_targets``: the right spill's
``spill_assign`` or the strict rank) and the placement of every column
through the inverse of the fitting rows' targets (``place_rows``). The
keys, the spill assignment and the placement are hand-written kernels on a
CUDA tensor (``csrc/bucket_assign.cu``) and plain torch chains on a CPU
tensor, the same bits either way. On the spill layout a CUDA rebuild of
its own rows is one host call (``rebuild_spill_on_card``: the same steps,
the sort a stable radix sort on the card). The bricks
(``parallel/bricks.py``) key their rows in the brick's frame and place
them through ``slot_targets`` and ``place_rows``.

Placement and overflow are bitwise equal to the JAX package's, whose
"gather" and "sort" engines place alike, on the same input. Where JAX
moves the payload through a second multi-operand sort by target row, the
port inverts that permutation with one scatter of row indices and gathers
every column once.
"""

from __future__ import annotations

import ctypes

import torch

from meso_tpu_torch.core.state import PER_PARTICLE, State
from meso_tpu_torch.kernels import _build
from meso_tpu_torch.kernels.common import check_cuda
from meso_tpu_torch.neighbor.cells import CellConfig


def grid_shape(cfg: CellConfig) -> tuple[int, int, int, int]:
    nx, ny, nz = cfg.ncell
    return (ny, nz, cfg.capacity, nx)


def n_rows(cfg: CellConfig) -> int:
    ny, nz, k, nx = grid_shape(cfg)
    return ny * nz * k * nx


def cell_coords(x: torch.Tensor, mask: torch.Tensor, box, cfg: CellConfig):
    """(cx, cy, cz) int64 per row; masked rows get cx = -1. The cell counts
    enter as Python scalars: a tensor made from them would be a host-to-device
    copy, which waits for the card, at every rebuild."""
    frac = (x - box.lo) / box.lengths
    cx, cy, cz = (
        torch.clamp((frac[:, d] * float(n)).to(torch.int32), 0, n - 1)
        .to(torch.int64) for d, n in enumerate(cfg.ncell))
    return torch.where(mask, cx, -1), cy, cz


def _seg_starts(seg: torch.Tensor) -> torch.Tensor:
    """First sorted-row index of each row's segment, for a sorted segment-id
    tensor. JAX takes cummax(boundary ? i : 0); a binary search gives the
    same indices and costs far less than a scan on the card."""
    return torch.searchsorted(seg, seg, side="left")


def spill_assign(base, cxs, valid_s, n_in: int, nx: int, k: int,
                 n_rows_yz: int, wrap: bool = True):
    """Right-spill slot assignment for cell-sorted rows (the function of
    ``spill_assign_plain``): on a CPU tensor its plain version, on a CUDA
    tensor the kernel ``meso_spill_assign`` of ``csrc/bucket_assign.cu``
    (a memset of the overflow and one launch, counted as
    ``"spill_assign"``), on any other device a raise.

    Takes what ``slot_targets`` gives: int64 ``base`` and ``cxs`` and a
    bool ``valid_s`` of ``n_in`` rows, sorted by the key ``base * nx +
    cxs`` with ``cxs`` in [0, nx), masked rows keyed ``nx * ny * nz`` so
    that a row is valid exactly where ``base < n_rows_yz``. The kernel
    writes the rows past the segments (the padding tail) as not fitting
    without reading them; it does not check this contract, which would
    take a host sync. Returns (target_row, fits, overflow), overflow a 0-d
    int64 tensor on the device."""
    if base.device.type == "cpu":
        return spill_assign_plain(base, cxs, valid_s, n_in, nx, k, n_rows_yz,
                                  wrap)
    check_cuda({"base": (base, torch.int64, (n_in,)),
                "cxs": (cxs, torch.int64, (n_in,)),
                "valid_s": (valid_s, torch.bool, (n_in,))})
    if n_rows_yz * k * nx + n_in >= 2 ** 31:
        raise ValueError("spill_assign: the kernel takes fewer than 2**31 "
                         "bucket rows and input rows together")
    dev = base.device
    target = torch.empty(n_in, dtype=torch.int64, device=dev)
    fits = torch.empty(n_in, dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.int64, device=dev)
    _build.launch("spill_assign", "meso_spill_assign", base.data_ptr(),
                  cxs.data_ptr(), valid_s.data_ptr(), target.data_ptr(),
                  fits.data_ptr(), overflow.data_ptr(), n_in, nx, k,
                  n_rows_yz, int(wrap), device=dev)
    return target, fits, overflow


def spill_assign_plain(base, cxs, valid_s, n_in: int, nx: int, k: int,
                       n_rows_yz: int, wrap: bool = True):
    """Right-spill slot assignment for cell-sorted rows, in plain torch.

    Within each (cy, cz) row, the linear slot l = r + cummax_row(cx*K - r)
    places each particle in its own cell's block or spills it right into
    the next cell's free slots. ``wrap=True`` also lets the last cell's
    overflow take cell 0's top free slots. Segmented maxima ride plain
    cummaxes through base-offset packing, as in the JAX package:

        cummax(seg * B + clip(val, 0, B-1)) - seg * B == segmented cummax

    Returns (target_row, fits, overflow)."""
    nr = n_rows_yz * k * nx
    iota = torch.arange(n_in, dtype=torch.int64, device=base.device)
    r_loc = iota - _seg_starts(base)
    a_t = torch.clamp(cxs * k - r_loc, min=0)
    am = torch.cummax(base * (nx * k) + a_t, dim=0).values - base * (nx * k)
    if wrap:
        # slots of cell 0 its own particles use: min(count(cell R*nx), K).
        # JAX carries the prefix count in a second cummax column; wrap_ok
        # reads it only on cx = nx-1 rows, which follow every cell-0 row of
        # their segment, where prefix and full counts agree. The full count
        # comes from two binary searches, with no second scan.
        key, key0 = base * nx + cxs, base * nx
        c0_used = torch.clamp(
            torch.searchsorted(key, key0, side="right")
            - torch.searchsorted(key, key0, side="left"), max=k)
    l_lin = r_loc + am
    in_row = valid_s & (l_lin < torch.clamp((cxs + 2) * k, max=nx * k))
    if wrap:
        m = l_lin - nx * k
        wrap_ok = (valid_s & ~in_row & (cxs == nx - 1) & (m >= 0)
                   & (m < k) & (k - 1 - m >= c0_used))
    else:
        wrap_ok = torch.zeros_like(in_row)
    fits = in_row | wrap_ok
    overflow = torch.sum(valid_s & ~fits)
    cell_a = torch.where(wrap_ok, 0, l_lin // k)
    slot = torch.where(wrap_ok, k - 1 - (l_lin - nx * k),
                       l_lin - (l_lin // k) * k)
    target = (base * k + slot) * nx + cell_a
    # rows that do not fit get distinct out-of-range targets
    target = torch.where(fits, target, nr + iota)
    return target, fits, overflow


def _place(state: State, src, live, n_out: int) -> State:
    """Output row r takes input row src[r] where live[r], zeros elsewhere."""
    kw = {}
    for name in PER_PARTICLE:
        a = getattr(state, name)
        if a is None:
            kw[name] = None
            continue
        g = a[src]
        lv = live.reshape((n_out,) + (1,) * (g.ndim - 1))
        kw[name] = torch.where(lv, g, torch.zeros((), dtype=g.dtype,
                                                  device=g.device))
    return state.replace(**kw)


def _preshift(new: State, wslot) -> State:
    """Move wrap-relief rows one box image left along x, with the image flag
    compensating, so that x + image * L is unchanged."""
    lx = new.box.lengths[0]
    x = new.x.clone()
    x[:, 0] = x[:, 0] + torch.where(wslot, -lx, torch.zeros_like(lx))
    image = new.image.clone()
    image[:, 0] = image[:, 0] + wslot.to(torch.int32)
    return new.replace(x=x, image=image)


def _cell_key(state: State, cfg: CellConfig) -> torch.Tensor:
    """(cy * nz + cz) * nx + cx of each row, int64; nx * ny * nz on masked
    rows."""
    nx, ny, nz = cfg.ncell
    cx, cy, cz = cell_coords(state.x, state.mask, state.box, cfg)
    key = (cy * nz + cz) * nx + cx
    return torch.where(state.mask, key, nx * ny * nz)


def cell_keys_plain(state: State, cfg: CellConfig, wrap: bool):
    """``cell_keys`` in plain torch."""
    if wrap:
        x_w, image_w = state.box.wrap(state.x, state.image)
        state = state.replace(x=x_w, image=image_w)
    return state, _cell_key(state, cfg)


def cell_keys(state: State, cfg: CellConfig, wrap: bool):
    """(state, key): the state with x and image wrapped into the box where
    ``wrap`` (the deferred wrap of System.wrap_mode="rebuild"), and each
    row's cell key from its wrapped x, (cy * nz + cz) * nx + cx as int64,
    nx * ny * nz on masked rows. On a CPU tensor its plain version
    (``cell_keys_plain``); on a CUDA tensor the kernel
    ``meso_bucket_keys`` of ``csrc/bucket_assign.cu`` (one launch, counted
    as ``"bucket_keys"``), bitwise the same; on any other device a
    raise."""
    dev = state.device
    if dev.type == "cpu":
        return cell_keys_plain(state, cfg, wrap)
    n = state.n
    if n >= 2 ** 31:
        raise ValueError("cell_keys: the kernel takes fewer than 2**31 rows")
    box = state.box
    specs = {"x": (state.x, torch.float32, (n, 3)),
             "mask": (state.mask, torch.bool, (n,)),
             "box.lo": (box.lo, torch.float32, (3,)),
             "box.hi": (box.hi, torch.float32, (3,))}
    if wrap:
        specs["image"] = (state.image, torch.int32, (n, 3))
    check_cuda(specs)
    x_out = torch.empty_like(state.x) if wrap else None
    image_out = torch.empty_like(state.image) if wrap else None
    key = torch.empty(n, dtype=torch.int64, device=dev)
    nx, ny, nz = cfg.ncell
    _build.launch(
        "bucket_keys", "meso_bucket_keys", state.x.data_ptr(),
        state.image.data_ptr() if wrap else None, state.mask.data_ptr(),
        box.lo.data_ptr(), box.hi.data_ptr(),
        x_out.data_ptr() if wrap else None,
        image_out.data_ptr() if wrap else None, key.data_ptr(), n, nx, ny,
        nz, int(wrap), device=dev)
    if wrap:
        state = state.replace(x=x_out, image=image_out)
    return state, key


def slot_targets(key: torch.Tensor, cfg: CellConfig, wrap: bool = True):
    """The rebuild between its keys and its placement, for int64 cell keys
    of any number of rows ((cy * nz + cz) * nx + cx on the grid of
    ``cfg``, nx * ny * nz on masked rows): one stable sort of the keys,
    then each sorted row's slot, by the right spill (``spill_assign``;
    ``wrap`` lets the last cell's overflow take cell 0's top free slots,
    as on one card; the bricks pass False) or, on strict buckets, by its
    rank in its cell. Returns (the sort's order, each sorted row's target
    row, whether it fits, the overflow, the wrap relief's (cxs, nx) where
    the spill wraps under the deferred wrap, else None), as
    ``place_rows`` takes them. A row that does not fit has a distinct
    target past the bucket rows."""
    nx, ny, nz = cfg.ncell
    k = cfg.capacity
    n_in = key.shape[0]
    key_s, order = torch.sort(key, stable=True)
    base = key_s // nx
    cxs = key_s - base * nx
    valid_s = key_s < nx * ny * nz
    relief = None
    if cfg.spill:
        target, fits, overflow = spill_assign(base, cxs, valid_s, n_in, nx,
                                              k, ny * nz, wrap)
        if wrap and cfg.wrap_at_rebuild:
            # wrap-relief rows sit in cell 0's block with x ~ lo + Lx; the
            # no-min-image kernel reads them only if they are pre-shifted
            # one image left (meso_tpu bucket_layout.py:392-406)
            relief = (cxs, nx)
    else:
        iota = torch.arange(n_in, dtype=torch.int64, device=key.device)
        rank = iota - _seg_starts(key_s)
        fits = valid_s & (rank < k)
        overflow = torch.sum(valid_s & (rank >= k))
        target = (base * k + torch.clamp(rank, max=k - 1)) * nx + cxs
        target = torch.where(fits, target, n_rows(cfg) + iota)
    return order, target, fits, overflow, relief


def place_rows_plain(state: State, order, target, fits, nr: int,
                     relief=None) -> State:
    """``place_rows`` in plain torch, as its kernel does it: the fitting
    rows' targets inverted into ``inv`` (-1 where no row fits), every
    column gathered through it."""
    inv = torch.full((nr + 1,), -1, dtype=torch.int64, device=state.device)
    # rows that do not fit write the trash slot nr, which is dropped
    inv[torch.where(fits, target, nr)] = torch.arange(
        state.n, dtype=torch.int64, device=state.device)
    inv = inv[:nr]
    live = inv >= 0
    src = torch.clamp(inv, min=0)
    new = _place(state, order[src], live, nr)
    if relief is not None:
        cxs, nx = relief
        wrapped = fits & (cxs == nx - 1) & (target % nx == 0)
        new = _preshift(new, live & wrapped[src])
    return new


# the kernel's limit on columns (csrc/bucket_assign.cu, kMaxColumns)
_PLACE_COLUMNS = 16


def place_rows(state: State, order, target, fits, nr: int,
               relief=None) -> State:
    """The bucket state from n sorted rows, n any number (the stable
    sort's ``order``, each row's ``target`` slot and whether it ``fits``,
    the fitting targets distinct and below nr): bucket row r takes every
    per-particle column of input row order[i] for the sorted row i that
    fits with target[i] = r, zeros where no row does. With ``relief`` =
    (cxs, nx), the wrap-relief rows (fits, cxs == nx - 1 and target % nx ==
    0: rows of cell nx - 1 placed in cell 0's block) move one box image
    left along x (``_preshift``). order, target and cxs are int64, fits
    bool. On a CPU tensor the plain version (``place_rows_plain``); on a
    CUDA tensor ``meso_bucket_place`` of ``csrc/bucket_assign.cu`` (a
    memset and two kernels, counted as ``"bucket_place"``), bitwise the
    same; on any other device a raise."""
    dev = state.device
    if dev.type == "cpu":
        return place_rows_plain(state, order, target, fits, nr, relief)
    n = state.n
    if nr + n >= 2 ** 31:
        raise ValueError("place_rows: the kernel takes fewer than 2**31 "
                         "rows in and out together")
    names = [name for name in PER_PARTICLE if getattr(state, name)
             is not None]
    cols = [getattr(state, name) for name in names]
    specs = {name: (c, c.dtype, (n,) + tuple(c.shape[1:]))
             for name, c in zip(names, cols)}
    specs.update(order=(order, torch.int64, (n,)),
                 target=(target, torch.int64, (n,)),
                 fits=(fits, torch.bool, (n,)))
    x_col = image_col = -1
    cxs, nx = (None, 1) if relief is None else relief
    if relief is not None:
        specs.update({"cxs": (cxs, torch.int64, (n,)),
                      "x": (state.x, torch.float32, (n, 3)),
                      "image": (state.image, torch.int32, (n, 3)),
                      "box.lo": (state.box.lo, torch.float32, (3,)),
                      "box.hi": (state.box.hi, torch.float32, (3,))})
        x_col, image_col = names.index("x"), names.index("image")
    check_cuda(specs)
    widths = [c.element_size() * (c.numel() // n if n else 0) for c in cols]
    if len(cols) > _PLACE_COLUMNS or any(w % 4 and w > 3 for w in widths):
        raise ValueError(f"place_rows: the kernel takes at most "
                         f"{_PLACE_COLUMNS} columns of a multiple of 4 "
                         f"bytes a row or fewer than 4, not {widths}")
    outs = [torch.empty((nr,) + tuple(c.shape[1:]), dtype=c.dtype,
                        device=dev) for c in cols]
    inv = torch.empty(nr, dtype=torch.int64, device=dev)
    k = len(cols)
    _build.launch(
        "bucket_place", "meso_bucket_place",
        (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
        (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]),
        (ctypes.c_int * k)(*widths), k, order.data_ptr(), target.data_ptr(),
        fits.data_ptr(), inv.data_ptr(),
        None if cxs is None else cxs.data_ptr(), x_col, image_col,
        state.box.lo.data_ptr(), state.box.hi.data_ptr(), nx, n, nr,
        device=dev)
    return state.replace(**dict(zip(names, outs)))


def rebuild_buckets(state: State, cfg: CellConfig) -> tuple[State,
                                                            torch.Tensor]:
    """Redistribute rows into bucket order. The input may have any row
    count; the output has exactly n_rows(cfg) rows. With
    System.wrap_mode="rebuild" the rows are wrapped into the box first (the
    deferred global wrap). ``cfg.rebuild`` selects nothing: the JAX
    package's two engines place alike, and the port has one placement.
    Where the placement is the spill layout's own rows on a CUDA tensor it
    is the one call of ``rebuild_spill_on_card``; otherwise ``cell_keys``,
    ``slot_targets`` and ``place_rows``. Returns (bucket_state,
    overflow)."""
    if (cfg.spill and state.device.type == "cuda"
            and state.n == n_rows(cfg)):
        return rebuild_spill_on_card(state, cfg)
    state, key = cell_keys(state, cfg, wrap=cfg.wrap_at_rebuild)
    order, target, fits, overflow, relief = slot_targets(key, cfg)
    return place_rows(state, order, target, fits, n_rows(cfg),
                      relief), overflow


def rebuild_spill_on_card(state: State, cfg: CellConfig):
    """``rebuild_buckets`` of the spill layout's own n_rows(cfg) rows on
    CUDA tensors in one host call, ``meso_bucket_rebuild`` of
    ``csrc/bucket_assign.cu`` (the cell keys, a stable radix sort, the slot
    assignment and the placement: bitwise ``cell_keys``, ``slot_targets``
    and ``place_rows``), counted as ``"bucket_rebuild"``. Returns
    (bucket_state, overflow)."""
    if not cfg.spill:
        raise ValueError("rebuild_spill_on_card takes the spill layout")
    n = state.n
    nx, ny, nz = cfg.ncell
    if n != n_rows(cfg) or 2 * n >= 2 ** 31:
        raise ValueError(f"rebuild_spill_on_card: {n} rows, not the "
                         f"layout's {n_rows(cfg)} (fewer than 2**30)")
    wrap = bool(cfg.wrap_at_rebuild)
    names = [name for name in PER_PARTICLE if getattr(state, name)
             is not None]
    cols = [getattr(state, name) for name in names]
    box = state.box
    specs = {name: (c, c.dtype, (n,) + tuple(c.shape[1:]))
             for name, c in zip(names, cols)}
    specs.update({"x": (state.x, torch.float32, (n, 3)),
                  "image": (state.image, torch.int32, (n, 3)),
                  "mask": (state.mask, torch.bool, (n,)),
                  "box.lo": (box.lo, torch.float32, (3,)),
                  "box.hi": (box.hi, torch.float32, (3,))})
    check_cuda(specs)
    widths = [c.element_size() * (c.numel() // n) for c in cols]
    if len(cols) > _PLACE_COLUMNS or any(w % 4 and w > 3 for w in widths):
        raise ValueError(f"rebuild_spill_on_card: at most {_PLACE_COLUMNS} "
                         f"columns of a multiple of 4 bytes a row or fewer "
                         f"than 4, not {widths}")
    key_bits = max(1, (nx * ny * nz).bit_length())
    work_bytes = _build.query("meso_bucket_rebuild_bytes", n, key_bits,
                              int(wrap))
    if work_bytes < 0:
        raise ValueError(f"rebuild_spill_on_card: no workspace for {n} rows")
    dev = state.device
    work = torch.empty(work_bytes, dtype=torch.uint8, device=dev)
    overflow = torch.empty((), dtype=torch.int64, device=dev)
    outs = [torch.empty_like(c) for c in cols]
    k = len(cols)
    _build.launch(
        "bucket_rebuild", "meso_bucket_rebuild", state.x.data_ptr(),
        state.image.data_ptr(), state.mask.data_ptr(), box.lo.data_ptr(),
        box.hi.data_ptr(),
        (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
        (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]),
        (ctypes.c_int * k)(*widths), k, names.index("x"),
        names.index("image"), work.data_ptr(), overflow.data_ptr(), n, nx,
        ny, nz, cfg.capacity, key_bits, int(wrap), device=dev)
    return state.replace(**dict(zip(names, outs))), overflow


def to_bucket_state(state: State, cfg: CellConfig) -> State:
    """One-time conversion of an N-row state into bucket rows."""
    new, overflow = rebuild_buckets(state, cfg)
    if int(overflow):
        raise ValueError(
            f"bucket capacity K={cfg.capacity} overflowed by {int(overflow)} "
            f"rows at set-up ({int(state.n_valid())} particles in "
            f"{cfg.n_cells} cells); pass a larger capacity")
    return new
