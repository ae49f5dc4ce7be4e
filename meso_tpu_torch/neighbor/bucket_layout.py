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
cell keys and gathers of each column) but for the spill slot assignment:
on a CUDA tensor that is one hand-written kernel
(``csrc/bucket_assign.cu``), on a CPU tensor its plain torch version
(``spill_assign_plain``, a ``torch.cummax`` scan). Placement and overflow
are bitwise equal to the JAX package on the same input. Where JAX moves
the payload through a second multi-operand sort by target row, the port
inverts that permutation with one scatter of row indices and gathers
every column once.
"""

from __future__ import annotations

import torch

from meso_tpu_torch.core.state import PER_PARTICLE, State
from meso_tpu_torch.kernels import _build
from meso_tpu_torch.neighbor.cells import CellConfig

# Launches of the slot-assignment kernel, raised by one at each launch and
# nowhere else (parallel/launch.py::counted_launches reads them).
LAUNCHES = {"spill_assign": 0}


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
        n_rows_yz, int(wrap), torch.cuda.current_stream(dev).cuda_stream)
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


def _sorted_keys(state: State, cfg: CellConfig):
    nx, ny, nz = cfg.ncell
    cx, cy, cz = cell_coords(state.x, state.mask, state.box, cfg)
    key = (cy * nz + cz) * nx + cx
    key = torch.where(state.mask, key, nx * ny * nz)
    key_s, order = torch.sort(key, stable=True)
    base = key_s // nx
    return key_s, order, base, key_s - base * nx


def rebuild_buckets(state: State, cfg: CellConfig) -> tuple[State,
                                                            torch.Tensor]:
    """Redistribute rows into bucket order. The input may have any row
    count; the output has exactly n_rows(cfg) rows. Returns
    (bucket_state, overflow)."""
    if cfg.wrap_at_rebuild:
        # deferred global wrap (System.wrap_mode="rebuild")
        x_w, image_w = state.box.wrap(state.x, state.image)
        state = state.replace(x=x_w, image=image_w)
    if cfg.rebuild == "sort" and state.n == n_rows(cfg):
        return rebuild_buckets_sort(state, cfg)
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
    """Sort-engine rebuild for a steady-state nr-row input: one stable sort
    by cell key, the slot assignment in sorted space, dummy slots for rows
    that do not fit, and the placement as the inverse of the resulting
    permutation of [0, nr)."""
    nx, ny, nz = cfg.ncell
    k = cfg.capacity
    nr = n_rows(cfg)
    n_in = state.n
    dev = state.device
    iota = torch.arange(n_in, dtype=torch.int64, device=dev)

    key_s, order, base, cxs = _sorted_keys(state, cfg)
    valid_s = key_s < nx * ny * nz
    wrapped = None
    if cfg.spill:
        target, fits, overflow = spill_assign(
            base, cxs, valid_s, n_in, nx, k, ny * nz, wrap=True)
        if cfg.wrap_at_rebuild:
            # wrap-relief rows sit in cell 0's block with x ~ lo + Lx; the
            # no-min-image kernel reads them only if they are pre-shifted
            # one image left (meso_tpu bucket_layout.py:392-406)
            wrapped = fits & (cxs == nx - 1) & (target % nx == 0)
    else:
        rank = iota - _seg_starts(key_s)
        fits = valid_s & (rank < k)
        overflow = torch.sum(valid_s & (rank >= k))
        target = (base * k + torch.clamp(rank, max=k - 1)) * nx + cxs
        target = torch.where(fits, target, nr + iota)
    t_full = torch.where(fits, target, _dummy_targets(target, fits, nr))

    inv = torch.empty(nr, dtype=torch.int64, device=dev)
    inv[t_full] = iota
    new = _place(state, order[inv], fits[inv], nr)
    if wrapped is not None:
        new = _preshift(new, wrapped[inv])
    return new, overflow


def to_bucket_state(state: State, cfg: CellConfig) -> State:
    """One-time conversion of an N-row state into bucket rows."""
    new, overflow = rebuild_buckets(state, cfg)
    if int(overflow):
        raise ValueError(
            f"bucket capacity K={cfg.capacity} overflowed by {int(overflow)} "
            f"rows at set-up ({int(state.n_valid())} particles in "
            f"{cfg.n_cells} cells); pass a larger capacity")
    return new
