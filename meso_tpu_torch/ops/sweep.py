"""The 27-offset bucket sweep, by axis mode and physics (port of
``meso_tpu/ops/sweep.py``).

Each of the three cell axes is either rolled (periodic within this grid:
one card) or read from a plane padded by one ghost layer a side (the
decomposed axis of the distributed path). For each of the 27 cell offsets
the sweep forms the (ny, nz, K, K, nx) block of slot pairs between every
cell and its neighbour cell, hands it to a per-pair physics callback, and
sums the callback's outputs over the neighbour slots: no gathers, no
scatters, one writer per row. Classic DPD, eDPD and tDPD share it through
``classic_pair_fn``, ``edpd_pair_fn`` and ``tdpd_pair_fn``. Distances are
minimum-imaged against the global box.

Channels are (ny[+2], nz[+2], K, nx[+2]) planes (``make_channels``). This
is the JAX package's XLA path (force_path "bucket"), so it is plain torch:
on the card it runs as many elementwise launches as it has operations,
each over a full block of slot pairs.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from meso_tpu_torch.core import rng as rngmod
from meso_tpu_torch.ops.dpd import sqrt32


def sweep(channels: dict, ncell, capacity: int, halo: tuple, box_lengths,
          pair_fn: Callable, n_out: int) -> list:
    """Run the 27-offset traversal over the target cells ``ncell``.

    channels: name -> plane; 'x', 'y', 'z', 'vx', 'vy', 'vz' and 'valid'
    (0/1) float32, 'tag' int32, 'h' (the fast tier's per-particle hash)
    where the caller gives it, and model channels. ``halo`` = (y, z, x)
    bools: a True axis arrives padded by one ghost layer a side.
    pair_fn(dr, sv, nv, ok, hp, sign) returns a tuple of ``n_out`` per-pair
    tensors, each summed over the neighbour slot axis. Returns the list of
    ``n_out`` (ny, nz, K, nx) sums."""
    nx, ny, nz = ncell
    k = capacity
    hy, hz, hx = halo

    def selfe(p):
        q = p
        if hy:
            q = q[1:-1]
        if hz:
            q = q[:, 1:-1]
        if hx:
            q = q[..., 1:-1]
        return q[:, :, None, :, :]

    def neigh(p, dy, dz, dx):
        q = p[1 + dy:1 + dy + ny] if hy else torch.roll(p, -dy, 0)
        q = q[:, 1 + dz:1 + dz + nz] if hz else torch.roll(q, -dz, 1)
        q = q[..., 1 + dx:1 + dx + nx] if hx else torch.roll(q, -dx, 3)
        return q[:, :, :, None, :]

    lens = [box_lengths[d] for d in range(3)]

    def mi(d, axis):
        return d - torch.round(d / lens[axis]) * lens[axis]

    dev = channels["x"].device
    eye = torch.eye(k, dtype=torch.bool, device=dev)[None, None, :, :, None]
    acc = [torch.zeros((ny, nz, k, nx), dtype=torch.float32, device=dev)
           for _ in range(n_out)]
    sv = {name: selfe(p) for name, p in channels.items()}
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nv = {name: neigh(p, dy, dz, dx)
                      for name, p in channels.items()}
                dr = (mi(sv["x"] - nv["x"], 0), mi(sv["y"] - nv["y"], 1),
                      mi(sv["z"] - nv["z"], 2))
                ok = (sv["valid"] * nv["valid"]) > 0.5
                if dx == 0 and dy == 0 and dz == 0:
                    ok = ok & ~eye
                hp = (rngmod.combine_symmetric(sv["h"], nv["h"])
                      if "h" in channels else None)
                sign = torch.where(sv["tag"] < nv["tag"], 1.0, -1.0)
                for i, o in enumerate(pair_fn(dr, sv, nv, ok, hp, sign)):
                    acc[i] = acc[i] + torch.sum(o, dim=2)
    return acc


def make_channels(x, v, tag, mask, h, extra: dict, ncell,
                  capacity: int) -> dict:
    """Reshape per-row tensors into plane channels (no halos): x, y, z, vx,
    vy, vz, tag, valid (the mask as float32, as in the JAX package), "h"
    where ``h`` is given (the per-particle hash of the fast tier) and each
    entry of ``extra`` under its own name. The planes are views where the
    input allows it."""
    nx, ny, nz = ncell
    shape = (ny, nz, capacity, nx)
    ch = {"x": x[:, 0].reshape(shape), "y": x[:, 1].reshape(shape),
          "z": x[:, 2].reshape(shape),
          "vx": v[:, 0].reshape(shape), "vy": v[:, 1].reshape(shape),
          "vz": v[:, 2].reshape(shape),
          "tag": tag.reshape(shape),
          "valid": mask.to(torch.float32).reshape(shape)}
    if h is not None:
        ch["h"] = h.reshape(shape)
    for name, arr in extra.items():
        ch[name] = arr.reshape(shape)
    return ch


def _coeffs(params, names, sv, nv, multitype: bool):
    """Per-pair coefficients from the (T, T) tables: looked up by the 'typ'
    channels with more than one type, the single entry otherwise."""
    if multitype:
        ti, tj = sv["typ"].long(), nv["typ"].long()
        return [getattr(params, nm)[ti, tj] for nm in names]
    return [getattr(params, nm)[0, 0] for nm in names]


def _geometry(dr, sv, nv, ok, rc):
    """(ok within rc, rinv, r, w, e.v_ij) of a block of pairs."""
    drx, dry, drz = dr
    r2 = drx * drx + dry * dry + drz * drz
    ok = ok & (r2 < rc * rc) & (r2 > 0.0)
    r2s = torch.where(ok, r2, torch.ones_like(r2))
    rinv = torch.rsqrt(r2s)
    r = r2s * rinv
    w = 1.0 - r / rc
    ev = (drx * (sv["vx"] - nv["vx"]) + dry * (sv["vy"] - nv["vy"])
          + drz * (sv["vz"] - nv["vz"])) * rinv
    return ok, rinv, r, w, ev


def _zero(t):
    return torch.zeros((), dtype=torch.float32, device=t.device)


def classic_pair_fn(params, dt: float, rng_mode: str = "fast", step=None,
                    rng_rounds: int = 8, multitype: bool = False,
                    n_excl: int = 0):
    """Classic DPD pair physics -> (fx, fy, fz, virial half).

    The fast tier draws theta from the combined per-particle hashes, the
    TEA tier from TEA on the sorted tag pair. n_excl > 0: channels EX0 ..
    EX{n_excl-1} carry each row's excluded tags, and a pair whose tag is
    among them is scaled by excl_w."""
    dt_inv_sqrt = 1.0 / math.sqrt(dt)
    if rng_mode not in ("fast", "tea"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")

    def fn(dr, sv, nv, ok, hp, sign):
        a, gamma, sigma, rc = _coeffs(params, ("a", "gamma", "sigma", "rc"),
                                      sv, nv, multitype)
        ok, rinv, r, w, ev = _geometry(dr, sv, nv, ok, rc)
        wr = w if params.s_exp == 1.0 else torch.pow(w, params.s_exp)
        if rng_mode == "tea":
            theta = rngmod.pair_uniform_tea(sv["tag"], nv["tag"], step,
                                            params.seed, rounds=rng_rounds)
        else:
            theta = rngmod._u32_to_symmetric_uniform(hp)
        fmag = a * w - gamma * (wr * wr) * ev + sigma * wr * theta \
            * dt_inv_sqrt
        fmag = torch.where(ok, fmag, _zero(fmag))
        if n_excl:
            hit = sv["EX0"] == nv["tag"]
            for e in range(1, n_excl):
                hit = hit | (sv[f"EX{e}"] == nv["tag"])
            fmag = fmag * torch.where(hit, params.excl_w.to(torch.float32),
                                      torch.ones_like(fmag))
        fr = fmag * rinv
        drx, dry, drz = dr
        return fr * drx, fr * dry, fr * drz, 0.5 * fmag * r

    return fn


def _pair_hash(hp, sv, nv, rng_mode, step, seed, rounds):
    """The transport models' pair hash: the combined per-particle hashes
    (fast) or TEA on the sorted tag pair."""
    if rng_mode == "tea":
        return rngmod.pair_hash_tea(sv["tag"], nv["tag"], step, seed,
                                    rounds=rounds)
    if rng_mode != "fast":
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    return hp


def edpd_pair_fn(params, dt: float, multitype: bool = False,
                 rng_mode: str = "fast", step=None, rng_rounds: int = 8):
    """eDPD pair physics -> (fx, fy, fz, virial half, q): the momentum
    force with the generalized-FDT sigma_ij and the heat rate q^C + q^V +
    q^R (``ops.edpd``), from the 'T' channels."""
    inv_m = 1.0 / params.mass
    dt_inv_sqrt = 1.0 / math.sqrt(dt)

    def fn(dr, sv, nv, ok, hp, sign):
        hp = _pair_hash(hp, sv, nv, rng_mode, step, params.seed, rng_rounds)
        a, gamma, rc, kappa = _coeffs(params, ("a", "gamma", "rc", "kappa"),
                                      sv, nv, multitype)
        ok, rinv, r, w, ev = _geometry(dr, sv, nv, ok, rc)
        w2 = w * w
        ti, tj = sv["T"], nv["T"]
        sigma2 = 4.0 * gamma * ti * tj / torch.clamp(ti + tj, min=1e-12)
        sigma = sqrt32(torch.clamp(sigma2, min=0.0))
        theta = rngmod.uniform_stream(hp, 0)
        fmag = a * w - gamma * w2 * ev + sigma * w * theta * dt_inv_sqrt
        fmag = torch.where(ok, fmag, _zero(fmag))
        k_ij = kappa * 0.25 * (ti + tj) ** 2
        q_c = k_ij * w2 * (1.0 / torch.clamp(ti, min=1e-12)
                           - 1.0 / torch.clamp(tj, min=1e-12))
        q_v = 0.5 * (w2 * (gamma * ev * ev - sigma2 * inv_m)
                     - sigma * w * ev * theta * dt_inv_sqrt)
        zeta = sign * rngmod.uniform_stream(hp, 1)
        beta = sqrt32(torch.clamp(2.0 * k_ij, min=0.0))
        q_r = beta * w * zeta * dt_inv_sqrt
        q = torch.where(ok, q_c + q_v + q_r, _zero(fmag))
        fr = fmag * rinv
        drx, dry, drz = dr
        return fr * drx, fr * dry, fr * drz, 0.5 * fmag * r, q

    return fn


def tdpd_pair_fn(params, dt: float, ns: int, multitype: bool = False,
                 rng_mode: str = "fast", step=None, rng_rounds: int = 8):
    """tDPD pair physics -> (fx, fy, fz, virial half, dC_0 .. dC_{ns-1}),
    held to the dense oracle (``ops.tdpd``): the classic momentum force
    with w_R = w^s_exp, and per species the flux of ``tdpd_flux`` from the
    'C{s}' channels, gated on r < rcc alone. rcc must not exceed the
    largest rc, which the stencil covers (the bucket wrapper checks it).
    The JAX package's sweep takes s_exp = 1 and gates the flux on rc_ij as
    well (ROADMAP Queue 3, R8 and R9); this one does neither."""
    from meso_tpu_torch.ops.tdpd import tdpd_flux
    dt_inv_sqrt = 1.0 / math.sqrt(dt)

    def fn(dr, sv, nv, ok, hp, sign):
        hp = _pair_hash(hp, sv, nv, rng_mode, step, params.seed, rng_rounds)
        a, gamma, sigma0, rc = _coeffs(params, ("a", "gamma", "sigma", "rc"),
                                       sv, nv, multitype)
        pair_ok = ok
        ok, rinv, r, w, ev = _geometry(dr, sv, nv, ok, rc)
        wr = w if params.s_exp == 1.0 else torch.pow(w, params.s_exp)
        theta = rngmod.uniform_stream(hp, 0)
        fmag = (a * w - gamma * (wr * wr) * ev
                + sigma0 * wr * theta * dt_inv_sqrt)
        fmag = torch.where(ok, fmag, _zero(fmag))
        fr = fmag * rinv
        drx, dry, drz = dr
        xi = torch.stack([sign * rngmod.uniform_stream(hp, 2 + s)
                          for s in range(ns)], dim=-1)
        c_i = torch.stack([sv[f"C{s}"] for s in range(ns)], dim=-1)
        c_j = torch.stack([nv[f"C{s}"] for s in range(ns)], dim=-1)
        q = tdpd_flux(torch.stack(dr, dim=-1), c_i, c_j, xi, params.kappa_c,
                      params.eps_c, params.rcc, params.s1, dt_inv_sqrt,
                      pair_ok)
        return (fr * drx, fr * dry, fr * drz, 0.5 * fmag * r,
                *torch.unbind(q, dim=-1))

    return fn
