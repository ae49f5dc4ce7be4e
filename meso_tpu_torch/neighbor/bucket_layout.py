"""Bucket-resident state layout (port of
``meso_tpu/neighbor/bucket_layout.py``).

The state rows themselves are the cell buckets:

    row = ((cy * ncz + cz) * K + slot) * ncx + cx

so the per-particle tensors reshape without a copy to planes
(ncy, ncz, K, ncx). Padding slots (mask False) carry zeros. Capacity
overflow (more particles than a cell and its spill room hold) is counted
and checked, never hidden.

The JAX package wrote the rebuild as XLA code, not as a Pallas kernel, so
the port writes it as plain torch ops (one stable ``torch.sort`` of the
cell keys, the dummy slots and the inverse permutation) but for three
steps that are hand-written kernels on a CUDA tensor
(``csrc/bucket_assign.cu``) and plain torch chains on a CPU tensor: the
cell keys with the deferred wrap (``cell_keys``), the spill slot
assignment (``spill_assign``, a ``torch.cummax`` scan in plain torch) and
the placement of every column (``place_rows``). Kernel and chain give the
same bits; the kernels spare the host about 60 launches a rebuild. On the
spill layout a CUDA rebuild is one host call
(``rebuild_spill_on_card``: the same steps, the sort a stable radix sort
on the card).
Placement and overflow are bitwise equal to the JAX package on the same
input. Where JAX moves the payload through a second multi-operand sort by
target row, the port inverts that permutation with one scatter of row
indices and gathers every column once.
"""

from __future__ import annotations

import ctypes

import torch

from meso_tpu_torch.core.state import PER_PARTICLE, State
from meso_tpu_torch.kernels import _build
from meso_tpu_torch.kernels.common import check_cuda
from meso_tpu_torch.neighbor.cells import CellConfig

# Launches of the rebuild's kernels, raised by one at each launch and
# nowhere else (parallel/launch.py::counted_launches reads them).
LAUNCHES = {"spill_assign": 0, "bucket_keys": 0, "bucket_place": 0,
            "bucket_rebuild": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    (a memset of the overflow and one launch, adding one to
    ``LAUNCHES["spill_assign"]``), on any other device a raise.

    Takes what every caller gives (``rebuild_buckets_sort``,
    ``_rebuild_buckets_gather``, ``parallel/bricks.py::_place_cells``):
    int64 ``base`` and ``cxs`` and a bool ``valid_s`` of ``n_in`` rows,
    sorted by the key ``base * nx + cxs`` with ``cxs`` in [0, nx), masked
    rows keyed ``nx * ny * nz`` so that a row is valid exactly where
    ``base < n_rows_yz``. The kernel writes the rows past the segments
    (the padding tail) as not fitting without reading them; it does not
    check this contract, which would take a host sync. Returns (target_row,
    fits, overflow), overflow a 0-d int64 tensor on the device."""
    if base.device.type == "cpu":
        return spill_assign_plain(base, cxs, valid_s, n_in, nx, k, n_rows_yz,
                                  wrap)
    lib = _build.load_library()
    dev = base.device
    if dev.type != "cuda":
        raise ValueError(f"spill_assign takes CPU or CUDA tensors, not {dev}")
    for name, t, dtype in (("base", base, torch.int64),
                           ("cxs", cxs, torch.int64),
                           ("valid_s", valid_s, torch.bool)):
        if (t.device != dev or t.dtype != dtype or t.shape != (n_in,)
                or not t.is_contiguous()):
            raise ValueError(f"spill_assign: {name} must be a contiguous "
                             f"{dtype} tensor of {n_in} rows on {dev}")
    if n_rows_yz * k * nx + n_in >= 2 ** 31:
        raise ValueError("spill_assign: the kernel takes fewer than 2**31 "
                         "bucket rows and input rows together")
    target = torch.empty(n_in, dtype=torch.int64, device=dev)
    fits = torch.empty(n_in, dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.int64, device=dev)
    code = lib.meso_spill_assign(
        base.data_ptr(), cxs.data_ptr(), valid_s.data_ptr(),
        target.data_ptr(), fits.data_ptr(), overflow.data_ptr(), n_in, nx, k,
        n_rows_yz, int(wrap), _build.stream_of(dev))
    _build.check(code, "spill_assign")
    LAUNCHES["spill_assign"] += 1
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


def _dummy_targets(target, fits, nr: int):
    """Key every non-fitting sorted row to a distinct unused bucket slot, so
    that fitting targets and dummies together form a permutation of [0, nr).
    Out-of-range targets land in a trash slot at index nr."""
    dev = target.device
    used = torch.zeros(nr + 1, dtype=torch.int32, device=dev)
    used.index_fill_(0, torch.clamp(target, max=nr), 1)
    unused_first = torch.sort(used[:nr], stable=True).indices
    miss_rank = torch.cumsum((~fits).to(torch.int64), dim=0) - 1
    # fitting rows before the first miss read index -1 (the last slot), as
    # in JAX; their values are never used
    return unused_first[torch.clamp(miss_rank, max=nr - 1)]


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


def _sort_keys(key: torch.Tensor, nx: int):
    """(sorted keys, the stable sort's order, their (cy, cz) row, their
    cx)."""
    key_s, order = torch.sort(key, stable=True)
    base = key_s // nx
    return key_s, order, base, key_s - base * nx


def _sorted_keys(state: State, cfg: CellConfig):
    return _sort_keys(_cell_key(state, cfg), cfg.ncell[0])


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
    ``meso_bucket_keys`` of ``csrc/bucket_assign.cu`` (one launch, adding
    one to ``LAUNCHES["bucket_keys"]``), bitwise the same; on any other
    device a raise."""
    dev = state.device
    if dev.type == "cpu":
        return cell_keys_plain(state, cfg, wrap)
    lib = _build.load_library()
    if dev.type != "cuda":
        raise ValueError(f"cell_keys takes CPU or CUDA tensors, not {dev}")
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
    code = lib.meso_bucket_keys(
        state.x.data_ptr(), state.image.data_ptr() if wrap else None,
        state.mask.data_ptr(), box.lo.data_ptr(), box.hi.data_ptr(),
        x_out.data_ptr() if wrap else None,
        image_out.data_ptr() if wrap else None, key.data_ptr(), n, nx, ny,
        nz, int(wrap), _build.stream_of(dev))
    _build.check(code, "bucket_keys")
    LAUNCHES["bucket_keys"] += 1
    if wrap:
        state = state.replace(x=x_out, image=image_out)
    return state, key


def place_rows_plain(state: State, order, target, fits, nr: int,
                     relief=None) -> State:
    """``place_rows`` in plain torch: the rows that do not fit keyed to the
    free slots (``_dummy_targets``), that permutation of [0, nr) inverted
    with one scatter, every column gathered through it."""
    iota = torch.arange(state.n, dtype=torch.int64, device=state.device)
    t_full = torch.where(fits, target, _dummy_targets(target, fits, nr))
    inv = torch.empty(nr, dtype=torch.int64, device=state.device)
    inv[t_full] = iota
    new = _place(state, order[inv], fits[inv], nr)
    if relief is not None:
        cxs, nx = relief
        wrapped = fits & (cxs == nx - 1) & (target % nx == 0)
        new = _preshift(new, wrapped[inv])
    return new


# the kernel's limit on columns (csrc/bucket_assign.cu, kMaxColumns)
_PLACE_COLUMNS = 16


def place_rows(state: State, order, target, fits, nr: int,
               relief=None) -> State:
    """The sort rebuild's bucket state from its n sorted rows (the stable
    sort's ``order``, each row's ``target`` slot and whether it ``fits``,
    the fitting targets distinct and below nr): bucket row r takes every
    per-particle column of input row order[i] for the sorted row i that
    fits with target[i] = r, zeros where no row does. With ``relief`` =
    (cxs, nx), the wrap-relief rows (fits, cxs == nx - 1 and target % nx ==
    0: rows of cell nx - 1 placed in cell 0's block) move one box image
    left along x (``_preshift``). order, target and cxs are int64, fits
    bool. On a CPU tensor the plain version (``place_rows_plain``); on a
    CUDA tensor ``meso_bucket_place`` of ``csrc/bucket_assign.cu`` (a
    memset and two kernels, adding one to ``LAUNCHES["bucket_place"]``),
    bitwise the same; on any other device a raise."""
    dev = state.device
    if dev.type == "cpu":
        return place_rows_plain(state, order, target, fits, nr, relief)
    lib = _build.load_library()
    if dev.type != "cuda":
        raise ValueError(f"place_rows takes CPU or CUDA tensors, not {dev}")
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
    code = lib.meso_bucket_place(
        (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
        (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]),
        (ctypes.c_int * k)(*widths), k, order.data_ptr(), target.data_ptr(),
        fits.data_ptr(), inv.data_ptr(),
        None if cxs is None else cxs.data_ptr(), x_col, image_col,
        state.box.lo.data_ptr(), state.box.hi.data_ptr(), nx, n, nr,
        _build.stream_of(dev))
    _build.check(code, "bucket_place")
    LAUNCHES["bucket_place"] += 1
    return state.replace(**dict(zip(names, outs)))


def rebuild_buckets(state: State, cfg: CellConfig) -> tuple[State,
                                                            torch.Tensor]:
    """Redistribute rows into bucket order. The input may have any row
    count; the output has exactly n_rows(cfg) rows. With
    System.wrap_mode="rebuild" the rows are wrapped into the box first (the
    deferred global wrap). Returns (bucket_state, overflow)."""
    if cfg.rebuild == "sort" and state.n == n_rows(cfg):
        return rebuild_buckets_sort(state, cfg)
    if cfg.wrap_at_rebuild:
        x_w, image_w = state.box.wrap(state.x, state.image)
        state = state.replace(x=x_w, image=image_w)
    return _rebuild_buckets_gather(state, cfg)


def _rebuild_buckets_gather(state: State, cfg: CellConfig):
    """Index-map placement: scatter the source row index of every fitting
    row to its target slot, then gather every column once."""
    nx, ny, nz = cfg.ncell
    k = cfg.capacity
    nr = n_rows(cfg)
    n_in = state.n
    dev = state.device
    iota = torch.arange(n_in, dtype=torch.int64, device=dev)

    key_s, order, base, cxs = _sorted_keys(state, cfg)
    valid_s = state.mask[order]
    wrapped_s = None
    if cfg.spill:
        target, fits, overflow = spill_assign(
            base, cxs, valid_s, n_in, nx, k, ny * nz, wrap=True)
        if cfg.wrap_at_rebuild:
            wrapped_s = fits & (cxs == nx - 1) & (target % nx == 0)
    else:
        n_cells = nx * ny * nz
        starts = torch.searchsorted(
            key_s, torch.arange(n_cells + 1, dtype=key_s.dtype, device=dev),
            side="left")
        rank = iota - starts[torch.clamp(key_s, max=n_cells)]
        fits = valid_s & (rank < k)
        overflow = torch.sum(valid_s & (rank >= k))
        target = (base * k + torch.clamp(rank, max=k - 1)) * nx + cxs
        target = torch.where(fits, target, nr + iota)

    # out-of-range targets write the trash slot nr, which is dropped
    tgt = torch.clamp(target, max=nr)
    idx_map = torch.full((nr + 1,), -1, dtype=torch.int64, device=dev)
    idx_map[tgt] = iota
    idx_map = idx_map[:nr]
    live = idx_map >= 0
    new = _place(state, order[torch.clamp(idx_map, min=0)], live, nr)
    if wrapped_s is not None:
        wslot = torch.zeros(nr + 1, dtype=torch.bool, device=dev)
        wslot[tgt] = wrapped_s
        new = _preshift(new, wslot[:nr])
    return new, overflow


def rebuild_buckets_sort(state: State, cfg: CellConfig):
    """Sort-engine rebuild for a steady-state nr-row input: the deferred
    wrap where the configuration asks for it, one stable sort by cell key,
    the slot assignment in sorted space, and the placement through the
    inverse of the fitting rows' targets (``sorted_targets``, then
    ``place_rows``). The spill layout on a CUDA tensor runs the same steps
    as one call of ``rebuild_spill_on_card``."""
    if cfg.spill and state.device.type == "cuda":
        return rebuild_spill_on_card(state, cfg)
    state, order, target, fits, overflow, relief = sorted_targets(state, cfg)
    return place_rows(state, order, target, fits, n_rows(cfg),
                      relief), overflow


def sorted_targets(state: State, cfg: CellConfig):
    """The sort rebuild up to its placement: (the state wrapped where the
    configuration defers the wrap to the rebuild, the stable sort's order,
    each sorted row's target slot, whether it fits, the overflow, the wrap
    relief's (cxs, nx) or None), as ``place_rows`` takes them."""
    nx, ny, nz = cfg.ncell
    k = cfg.capacity
    nr = n_rows(cfg)
    n_in = state.n

    state, key = cell_keys(state, cfg, wrap=cfg.wrap_at_rebuild)
    key_s, order, base, cxs = _sort_keys(key, nx)
    valid_s = key_s < nx * ny * nz
    relief = None
    if cfg.spill:
        target, fits, overflow = spill_assign(
            base, cxs, valid_s, n_in, nx, k, ny * nz, wrap=True)
        if cfg.wrap_at_rebuild:
            # wrap-relief rows sit in cell 0's block with x ~ lo + Lx; the
            # no-min-image kernel reads them only if they are pre-shifted
            # one image left (meso_tpu bucket_layout.py:392-406)
            relief = (cxs, nx)
    else:
        iota = torch.arange(n_in, dtype=torch.int64, device=state.device)
        rank = iota - _seg_starts(key_s)
        fits = valid_s & (rank < k)
        overflow = torch.sum(valid_s & (rank >= k))
        target = (base * k + torch.clamp(rank, max=k - 1)) * nx + cxs
        target = torch.where(fits, target, nr + iota)
    return state, order, target, fits, overflow, relief


def rebuild_spill_on_card(state: State, cfg: CellConfig):
    """``rebuild_buckets_sort`` on the spill layout for CUDA tensors in one
    host call, ``meso_bucket_rebuild`` of ``csrc/bucket_assign.cu`` (the
    cell keys, a stable radix sort, the slot assignment and the placement:
    bitwise ``sorted_targets`` and ``place_rows``), adding one to
    ``LAUNCHES["bucket_rebuild"]``. Returns (bucket_state, overflow)."""
    if not cfg.spill:
        raise ValueError("rebuild_spill_on_card takes the spill layout")
    lib = _build.load_library()
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"rebuild_spill_on_card takes CUDA tensors, not "
                         f"{dev}")
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
    work_bytes = lib.meso_bucket_rebuild_bytes(n, key_bits, int(wrap))
    if work_bytes < 0:
        raise ValueError(f"rebuild_spill_on_card: no workspace for {n} rows")
    work = torch.empty(work_bytes, dtype=torch.uint8, device=dev)
    overflow = torch.empty((), dtype=torch.int64, device=dev)
    outs = [torch.empty_like(c) for c in cols]
    k = len(cols)
    code = lib.meso_bucket_rebuild(
        state.x.data_ptr(), state.image.data_ptr(), state.mask.data_ptr(),
        box.lo.data_ptr(), box.hi.data_ptr(),
        (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
        (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]),
        (ctypes.c_int * k)(*widths), k, names.index("x"),
        names.index("image"), work.data_ptr(), overflow.data_ptr(), n, nx,
        ny, nz, cfg.capacity, key_bits, int(wrap), _build.stream_of(dev))
    _build.check(code, "bucket_rebuild")
    LAUNCHES["bucket_rebuild"] += 1
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
