"""Plain reference of what one rebuild-and-steps chunk of the DPD engine
computes, for the classic Groot-Warren fluid, and the check's numbers
that hold a window of the program against it.

It follows the engine's specification, not its code:

- placement: particles are sorted by cell (stable in their row order);
  a strict cell holds its first K particles; with right spill, the
  particles of one (y, z) line of cells take linear slots in sort order,
  each the next free one at or after its own cell's first slot, up to the
  end of the next cell's block, and the last cell's overflow takes cell
  0's free slots from the top;
- the modified velocity-Verlet step of Groot and Warren with lambda;
- F_ij = [a w - gamma w^2 (e.v_ij) + sigma w theta_ij / sqrt(dt)] e_ij,
  w = 1 - r/rc, sigma^2 = 2 gamma kT, found by its own cell list with the
  minimum image.

Everything is float32 unless ``pair_dtype`` lowers the pair arithmetic
(the control). Positions, velocities and forces are held in tag order:
row i is tag i + 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from reference import rng


@dataclass(frozen=True)
class Physics:
    lengths: tuple          # box edge lengths (the box starts at 0)
    a: float
    gamma: float
    rc: float
    kt: float
    dt: float
    lam: float
    seed: int
    rng_rounds: int = 8


@dataclass(frozen=True)
class Layout:
    ncell: tuple            # (nx, ny, nz) cells of the buckets
    capacity: int
    spill: bool
    wrap_at_rebuild: bool   # wrap at the rebuild only, else every step
    rebuild_every: int      # steps of a chunk


def wrap(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Positions wrapped into [0, L): x - floor(x / L) L, and L itself
    (a rounding) back to 0."""
    shift = torch.floor(x / lengths).to(torch.int32)
    xw = x - shift.to(x.dtype) * lengths
    return torch.where(xw >= lengths, torch.zeros_like(xw), xw)


def placement(x: torch.Tensor, mask: torch.Tensor, lengths: torch.Tensor,
              lay: Layout):
    """Bucket row of every input row (-1 where it does not fit) and
    whether it sits in cell 0 as the last cell's overflow. ``x`` are the
    positions the rebuild sees (wrapped first where the layout wraps at
    rebuild time); ties keep the input row order."""
    nx, ny, nz = lay.ncell
    k = lay.capacity
    frac = x / lengths
    c = [torch.clamp((frac[:, d] * float(n)).to(torch.int32), 0, n - 1)
         for d, n in enumerate(lay.ncell)]
    cx, cy, cz = (t.cpu().numpy().astype(np.int64) for t in c)
    valid = mask.cpu().numpy()
    line = cy * nz + cz
    key = np.where(valid, line * nx + cx, nx * ny * nz)
    order = np.argsort(key, kind="stable")
    order = order[valid[order]]
    row = np.full(x.shape[0], -1, np.int64)
    relief = np.zeros(x.shape[0], bool)
    lines, cxs = line[order].tolist(), cx[order].tolist()
    if not lay.spill:
        prev, rank = -1, 0
        for n, (b, cxi) in enumerate(zip(lines, cxs)):
            cell = b * nx + cxi
            rank = rank + 1 if cell == prev else 0
            prev = cell
            if rank < k:
                row[order[n]] = (b * k + rank) * nx + cxi
        return row, relief
    in_cell0 = np.bincount(line[valid & (cx == 0)], minlength=ny * nz)
    used0 = np.minimum(in_cell0, k).tolist()
    prev_line, last = -1, 0
    for n, (b, cxi) in enumerate(zip(lines, cxs)):
        if b != prev_line:
            prev_line, last = b, -1
        slot_l = max(last + 1, cxi * k)
        last = slot_l
        if slot_l < min((cxi + 2) * k, nx * k):
            row[order[n]] = (b * k + slot_l % k) * nx + slot_l // k
        elif cxi == nx - 1:
            m = slot_l - nx * k
            if 0 <= m < k and k - 1 - m >= used0[b]:
                row[order[n]] = (b * k + (k - 1 - m)) * nx
                relief[order[n]] = True
    return row, relief


def _cell_table(x: torch.Tensor, lengths: torch.Tensor, rc: float):
    """Cells of side >= rc: (cell coordinates per particle, cell counts,
    (cells, M) table of particle indices padded with -1)."""
    nc = [max(3, int(math.floor(float(l) / (rc * 1.0001)))) for l in
          lengths.tolist()]
    frac = x / lengths
    frac = frac - torch.floor(frac)
    c = torch.stack([torch.clamp((frac[:, d] * n).long(), 0, n - 1)
                     for d, n in enumerate(nc)], 1)
    cell = (c[:, 0] * nc[1] + c[:, 1]) * nc[2] + c[:, 2]
    n_cells = nc[0] * nc[1] * nc[2]
    counts = torch.bincount(cell, minlength=n_cells)
    m = int(counts.max())
    order = torch.argsort(cell)
    starts = torch.cumsum(counts, 0) - counts
    cs = cell[order]
    rank = torch.arange(x.shape[0], device=x.device) - starts[cs]
    table = torch.full((n_cells, m), -1, dtype=torch.int64, device=x.device)
    table[cs, rank] = order
    return nc, c, table


def pair_forces(x, v, tag, step: int, phys: Physics, pair_dtype=None,
                block: int | None = None):
    """(f (N, 3) float32, in-range ordered pairs) of the DPD pair term."""
    dev = x.device
    n = x.shape[0]
    lengths = torch.tensor(phys.lengths, dtype=torch.float32, device=dev)
    nc, c, table = _cell_table(x, lengths, phys.rc)
    offs = torch.tensor([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                         for k in (-1, 0, 1)], device=dev)
    ncv = torch.tensor(nc, device=dev)
    h = rng.particle_words(tag, step, phys.seed, phys.rng_rounds)
    dt_inv_sqrt = 1.0 / math.sqrt(phys.dt)
    kt32 = torch.tensor(phys.kt, dtype=torch.float32)
    sigma = float(torch.sqrt(2.0 * kt32 * torch.tensor(phys.gamma)))
    rc2 = phys.rc * phys.rc
    f = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    n_pairs = 0
    if block is None:
        block = 32768 if dev.type == "cuda" else 4096
    for i0 in range(0, n, block):
        i = torch.arange(i0, min(i0 + block, n), device=dev)
        nb = (c[i][:, None, :] + offs[None]) % ncv
        cells = (nb[..., 0] * nc[1] + nb[..., 1]) * nc[2] + nb[..., 2]
        cand = table[cells].reshape(i.shape[0], -1)
        j = torch.clamp(cand, min=0)
        dr = x[i][:, None, :] - x[j]
        dr = dr - torch.round(dr / lengths) * lengths
        r2 = torch.sum(dr * dr, -1)
        inside = (cand >= 0) & (cand != i[:, None]) & (r2 < rc2) & (r2 > 0)
        ti, tj = inside.nonzero(as_tuple=True)
        ii, jj = i[ti], j[ti, tj]
        d = dr[ti, tj]
        vij = v[ii] - v[jj]
        theta = rng.pair_uniform(h[ii], h[jj])
        if pair_dtype is not None:
            d, vij, theta = d.to(pair_dtype), vij.to(pair_dtype), \
                theta.to(pair_dtype)
        rr2 = torch.sum(d * d, -1)
        rinv = torch.rsqrt(rr2)
        r = rr2 * rinv
        w = 1.0 - r / phys.rc
        ev = torch.sum(d * vij, -1) * rinv
        fmag = (phys.a * w - phys.gamma * w * w * ev
                + sigma * w * theta * dt_inv_sqrt)
        f.index_add_(0, ii, ((fmag * rinv)[:, None] * d).to(torch.float32))
        n_pairs += int(ii.numel())
    return f, n_pairs


def follow(x, v, f, tag, relief, step0: int, nsteps: int, phys: Physics,
           lay: Layout, pair_dtype=None):
    """One chunk from a state in tag order: the rebuild's wrap (and the
    last cell's overflow moved one box length left in x, where the layout
    wraps only at rebuild time), then ``nsteps`` steps. Returns (x, v, f,
    in-range ordered pairs of the last force evaluation)."""
    lengths = torch.tensor(phys.lengths, dtype=torch.float32, device=x.device)
    if lay.wrap_at_rebuild:
        x = wrap(x, lengths)
        x = x.clone()
        x[:, 0] = x[:, 0] + torch.where(relief, -lengths[0],
                                        torch.zeros_like(lengths[0]))
    n_pairs = 0
    for s in range(1, nsteps + 1):
        vt = v + (phys.lam * phys.dt) * f
        x = x + phys.dt * v + (0.5 * phys.dt * phys.dt) * f
        if not lay.wrap_at_rebuild:
            x = wrap(x, lengths)
        f_new, n_pairs = pair_forces(x, vt, tag, step0 + s, phys,
                                     pair_dtype)
        v = v + (0.5 * phys.dt) * (f + f_new)
        f = f_new
    return x, v, f, n_pairs


# The check's numbers --------------------------------------------------

NUMBERS = ("placement_miss", "force_gap", "velocity_gap", "kT_gap")


def by_tag(t, tag, mask, n: int):
    """Rows of ``t`` in tag order (tag t at row t - 1; zeros for a tag
    that is missing)."""
    out = torch.zeros((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[(tag[mask] - 1).long()] = t[mask]
    return out


def _known(final: dict, n: int):
    tag, mask = final["tag"], final["mask"]
    return mask & (tag >= 1) & (tag <= n)


def _snapshot_start(snap: dict, phys: Physics, lay: Layout):
    """The snapshot's state in tag order, with the row that the chunk's
    rebuild gives each tag: (row, relief, x, v, f, tag)."""
    x, mask, tag = snap["x"], snap["mask"], snap["tag"]
    n = int(mask.sum())
    tags = torch.sort(tag[mask]).values
    if not torch.equal(tags.cpu(), torch.arange(1, n + 1, dtype=tags.dtype)):
        raise ValueError("the snapshot's tags are not 1..N")
    lengths = torch.tensor(phys.lengths, dtype=torch.float32,
                           device=x.device)
    x_reb = wrap(x, lengths) if lay.wrap_at_rebuild else x
    row, relief = placement(x_reb, mask, lengths, lay)
    row_t = np.full(n, -1, np.int64)
    relief_t = np.zeros(n, bool)
    tg = tag.cpu().numpy()
    m = mask.cpu().numpy()
    row_t[tg[m] - 1] = row[m]
    relief_t[tg[m] - 1] = relief[m]
    return (row_t, torch.from_numpy(relief_t).to(x.device),
            by_tag(x, tag, mask, n), by_tag(snap["v"], tag, mask, n),
            by_tag(snap["f"], tag, mask, n),
            torch.arange(1, n + 1, dtype=torch.int32, device=x.device))


def placement_miss(final: dict, row_t) -> int:
    """Particles whose row in the program's final state is not the
    reference's (lost ones and rows with an unknown tag included)."""
    n = row_t.shape[0]
    known = _known(final, n)
    rows = torch.nonzero(known).reshape(-1).cpu().numpy()
    prog_row = np.full(n, -2, np.int64)
    prog_row[final["tag"][known].cpu().numpy().astype(np.int64) - 1] = rows
    return (int(np.sum(prog_row != row_t))
            + int((final["mask"] & ~known).sum()))


def gap(a, b) -> float:
    """The largest |a - b| of a component over the root mean square of
    ``b`` (both in tag order)."""
    d = float(torch.max(torch.abs(a - b)))
    scale = float(torch.sqrt(torch.mean(b.double() * b.double())))
    return d / scale if np.isfinite(d) else float("inf")


def kt_gap(rows: list, kt: float) -> float:
    """|mean kT over the window's rows (the rows after its start) - kT|."""
    temps = [r["temp"] for r in rows[1:]]
    if not temps or not all(np.isfinite(temps)):
        return float("inf")
    return abs(float(np.mean(temps)) - kt)


def numbers(final: dict, snap: dict, rows: list, phys: Physics,
            lay: Layout, control=None) -> tuple:
    """The check's numbers of a window: placement_miss, force_gap and
    velocity_gap of ``final`` (tag, mask, f, v of the state the window's
    last chunk ended in) against the reference followed through that
    chunk from ``snap`` (the state the chunk started from), and kT_gap of
    the window's thermo ``rows``. With ``control`` (a torch dtype) the
    control takes the program's place in the last chunk: the reference
    with its pair arithmetic in that dtype, followed from the same
    snapshot. Returns (numbers, in-range ordered pairs of the reference's
    last force evaluation)."""
    row_t, relief, x, v, f, tag = _snapshot_start(snap, phys, lay)
    _, vr, fr, n_pairs = follow(x, v, f, tag, relief, snap["step"],
                                lay.rebuild_every, phys, lay)
    n = row_t.shape[0]
    if control is None:
        known = _known(final, n)
        miss = placement_miss(final, row_t)
        fp = by_tag(final["f"], final["tag"], known, n)
        vp = by_tag(final["v"], final["tag"], known, n)
    else:
        miss = 0        # the control places by the reference's own rule
        _, vp, fp, _ = follow(x, v, f, tag, relief, snap["step"],
                              lay.rebuild_every, phys, lay, control)
    return ({"placement_miss": miss, "force_gap": gap(fp, fr),
             "velocity_gap": gap(vp, vr), "kT_gap": kt_gap(rows, phys.kt)},
            n_pairs)
