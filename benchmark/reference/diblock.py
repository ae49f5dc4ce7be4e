"""Plain reference of what one rebuild-and-steps chunk of the DPD engine
computes for the block-copolymer melt of Groot and Madden (J. Chem. Phys.
108, 8713 (1998)), and the check's numbers that hold a window of the
program against it.

It follows the model, not the program's code. Every particle is a bead of
a linear chain of ``chain_len`` beads that fill the box: tag t is bead
(t - 1) mod chain_len of its chain, type A (0) for the chain's first
``n_a`` beads and type B (1) for the rest, and is bonded to tag t + 1
unless it ends its chain. Types and bonds are found from the tags alone.

- F_ij = [a_ij w - gamma_ij w^2 (e.v_ij) + sigma_ij w theta_ij / sqrt(dt)]
  e_ij over every pair inside rc, bonded ones included at full weight,
  w = 1 - r/rc, sigma_ij^2 = 2 gamma_ij kT, the noise theta_ij as in
  ``reference.rng``, found by the cell list of ``reference.dpd``;
- each bond's harmonic spring, E = K (r - r0)^2 (Groot and Madden's
  F = -C r is K = C / 2, r0 = 0), on both its beads;
- placement, the wrap and the modified velocity-Verlet step as in
  ``reference.dpd``.

Everything is float32 unless a control lowers the pair arithmetic
(bfloat16) or plants a fault in the springs. Arrays are in tag order:
row i is tag i + 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from reference import rng
from reference.dpd import (Layout, _cell_table, _known, _snapshot_start,
                           by_tag, gap, kt_gap, placement_miss, wrap)

__all__ = ["Physics", "Layout", "NUMBERS", "CONTROLS", "numbers"]

NUMBERS = ("placement_miss", "force_gap", "velocity_gap", "kT_gap")
# the controls the reference can put in the program's place: the pair
# arithmetic in bfloat16, and two planted faults of the bonded term
CONTROLS = (torch.bfloat16, "springs_off", "springs_half_k")


@dataclass(frozen=True)
class Physics:
    lengths: tuple          # box edge lengths (the box starts at 0)
    a: tuple                # 2 x 2 conservative coefficients by type
    gamma: tuple            # 2 x 2 dissipative coefficients by type
    rc: float
    kt: float
    dt: float
    lam: float
    chain_len: int
    n_a: int                # A beads at the head of each chain
    bond_k: float           # harmonic K of E = K (r - r0)^2
    bond_r0: float
    seed: int
    rng_rounds: int = 8


def types_of(tag: torch.Tensor, phys: Physics) -> torch.Tensor:
    """0 (A) or 1 (B) of each tag."""
    bead = (tag.to(torch.int64) - 1) % phys.chain_len
    return (bead >= phys.n_a).to(torch.int64)


def pair_forces(x, v, tag, step: int, phys: Physics, pair_dtype=None,
                block: int | None = None):
    """(f (N, 3) float32, in-range ordered pairs) of the two-type DPD pair
    term, bonded pairs included."""
    dev = x.device
    n = x.shape[0]
    lengths = torch.tensor(phys.lengths, dtype=torch.float32, device=dev)
    nc, c, table = _cell_table(x, lengths, phys.rc)
    offs = torch.tensor([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                         for k in (-1, 0, 1)], device=dev)
    ncv = torch.tensor(nc, device=dev)
    h = rng.particle_words(tag, step, phys.seed, phys.rng_rounds)
    typ = types_of(tag, phys)
    a_t = torch.tensor(phys.a, dtype=torch.float32, device=dev)
    g_t = torch.tensor(phys.gamma, dtype=torch.float32, device=dev)
    kt32 = torch.tensor(phys.kt, dtype=torch.float32, device=dev)
    s_t = torch.sqrt(2.0 * kt32 * g_t)
    dt_inv_sqrt = 1.0 / math.sqrt(phys.dt)
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
        a = a_t[typ[ii], typ[jj]]
        gamma = g_t[typ[ii], typ[jj]]
        sigma = s_t[typ[ii], typ[jj]]
        if pair_dtype is not None:
            d, vij, theta = (d.to(pair_dtype), vij.to(pair_dtype),
                             theta.to(pair_dtype))
            a, gamma, sigma = (a.to(pair_dtype), gamma.to(pair_dtype),
                               sigma.to(pair_dtype))
        rr2 = torch.sum(d * d, -1)
        rinv = torch.rsqrt(rr2)
        r = rr2 * rinv
        w = 1.0 - r / phys.rc
        ev = torch.sum(d * vij, -1) * rinv
        fmag = (a * w - gamma * w * w * ev
                + sigma * w * theta * dt_inv_sqrt)
        f.index_add_(0, ii, ((fmag * rinv)[:, None] * d).to(torch.float32))
        n_pairs += int(ii.numel())
    return f, n_pairs


def spring_forces(x, phys: Physics, fault=None) -> torch.Tensor:
    """(N, 3) float32: each bond (t, t + 1) of a chain, its harmonic force
    -2K (1 - r0 / r) d (d = x_t - x_{t+1} under the minimum image) on
    bead t and the opposite on bead t + 1. ``fault`` "springs_off" drops
    them, "springs_half_k" halves K."""
    n = x.shape[0]
    f = torch.zeros_like(x)
    if fault == "springs_off":
        return f
    k = phys.bond_k * (0.5 if fault == "springs_half_k" else 1.0)
    lengths = torch.tensor(phys.lengths, dtype=torch.float32,
                           device=x.device)
    i = torch.arange(n, device=x.device)
    i = i[(i % phys.chain_len) != phys.chain_len - 1]
    d = x[i] - x[i + 1]
    d = d - torch.round(d / lengths) * lengths
    if phys.bond_r0 == 0.0:
        fb = (-2.0 * k) * d
    else:
        r = torch.sqrt(torch.sum(d * d, -1, keepdim=True))
        fb = (-2.0 * k) * (1.0 - phys.bond_r0 / r) * d
    f[i] += fb
    f[i + 1] -= fb
    return f


def forces(x, v, tag, step: int, phys: Physics, control=None):
    """(f, in-range ordered pairs): the pair term and the springs."""
    pair_dtype = control if isinstance(control, torch.dtype) else None
    fault = control if isinstance(control, str) else None
    f, n_pairs = pair_forces(x, v, tag, step, phys, pair_dtype)
    return f + spring_forces(x, phys, fault), n_pairs


def follow(x, v, f, tag, relief, step0: int, nsteps: int, phys: Physics,
           lay: Layout, control=None):
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
        f_new, n_pairs = forces(x, vt, tag, step0 + s, phys, control)
        v = v + (0.5 * phys.dt) * (f + f_new)
        f = f_new
    return x, v, f, n_pairs


def numbers(final: dict, snap: dict, rows: list, phys: Physics,
            lay: Layout, control=None) -> tuple:
    """The check's numbers of a window: placement_miss, force_gap and
    velocity_gap of ``final`` (tag, mask, f, v of the state the window's
    last chunk ended in) against the reference followed through that
    chunk from ``snap`` (the state the chunk started from), and kT_gap of
    the window's thermo ``rows``. With ``control`` (one of ``CONTROLS``)
    the control takes the program's place in the last chunk: the reference
    with its pair arithmetic in that dtype, or with that fault planted in
    its springs, followed from the same snapshot. Returns (numbers,
    in-range ordered pairs of the reference's last force evaluation)."""
    row_t, relief, x, v, f, tag = _snapshot_start(snap, phys, lay)
    n = row_t.shape[0]
    if n % phys.chain_len:
        raise ValueError(f"{n} beads are not chains of {phys.chain_len}")
    _, vr, fr, n_pairs = follow(x, v, f, tag, relief, snap["step"],
                                lay.rebuild_every, phys, lay)
    if control is None:
        known = _known(final, n)
        miss = placement_miss(final, row_t)
        fp = by_tag(final["f"], final["tag"], known, n)
        vp = by_tag(final["v"], final["tag"], known, n)
    else:
        if control not in CONTROLS:
            raise ValueError(f"unknown control {control!r}")
        miss = 0        # the control places by the reference's own rule
        _, vp, fp, _ = follow(x, v, f, tag, relief, snap["step"],
                              lay.rebuild_every, phys, lay, control)
    return ({"placement_miss": miss, "force_gap": gap(fp, fr),
             "velocity_gap": gap(vp, vr), "kT_gap": kt_gap(rows, phys.kt)},
            n_pairs)
