"""tDPD — transport DPD with per-particle concentration fields (port of
``meso_tpu/ops/tdpd.py``).

momentum:  classic Groot-Warren DPD (``ops.dpd.pair_force``)
transport: dC_i/dt = sum_j (Q^D + Q^R) per species s,
           Q^D = -kappa_s w_dc(r) (C_i - C_j),  w_dc = (1 - r/r_cc)^s1
           Q^R = eps_s w_dc^{1/2} xi_ij dt^-1/2, xi antisymmetric, so the
           total of each species is conserved exactly.

``dense_forces_tdpd`` is the port's own O(N^2) oracle. The bucket kernel
(K3) is ``kernels.pair_dpd_v3.bucket_forces_pallas_v3_tdpd``;
``bucket_forces_tdpd`` is the 27-offset sweep over the same rows
(force_path "bucket"), held to the dense oracle.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import torch

from meso_tpu_torch.core import rng as rngmod
from meso_tpu_torch.core.box import Box
from meso_tpu_torch.ops.dpd import f32, pair_force, sqrt32


@dataclass(frozen=True)
class TDPDParams:
    """Momentum tables (as DPDParams) + per-species transport coefficients.

    a, gamma, sigma, rc are (T, T) and kappa_c, eps_c (S,) float32 tensors
    on the simulation device; rcc, s1 and s_exp are Python floats (float32
    values) and ``seed`` the uint32 value of the RNG seed."""

    a: torch.Tensor
    gamma: torch.Tensor
    sigma: torch.Tensor
    rc: torch.Tensor
    kappa_c: torch.Tensor
    eps_c: torch.Tensor
    rcc: float
    s1: float
    seed: int
    s_exp: float = 1.0

    @staticmethod
    def build(a, gamma, rc, kt: float, kappa_c, eps_c, rcc: float,
              seed: int, n_types: int = 1, s1: float = 1.0,
              device=None) -> "TDPDParams":
        def table(val):
            arr = torch.as_tensor(val, dtype=torch.float32, device=device)
            if arr.ndim == 0:
                arr = torch.full((n_types, n_types), float(arr),
                                 dtype=torch.float32, device=device)
            return arr

        def species(val):
            return torch.atleast_1d(torch.as_tensor(val, dtype=torch.float32,
                                                    device=device))
        g = table(gamma)
        kt32 = torch.tensor(kt, dtype=torch.float32, device=device)
        return TDPDParams(a=table(a), gamma=g, sigma=torch.sqrt(2.0 * kt32 * g),
                          rc=table(rc), kappa_c=species(kappa_c),
                          eps_c=species(eps_c), rcc=f32(rcc), s1=f32(s1),
                          seed=int(seed) & 0xFFFFFFFF)

    @property
    def n_types(self) -> int:
        return self.a.shape[0]

    @property
    def n_species(self) -> int:
        return self.kappa_c.shape[0]

    @functools.cached_property
    def rc_max(self) -> float:
        """Largest momentum cutoff, read from the table once per params
        object (the bucket kernel checks rcc against it at every call)."""
        return float(self.rc.max())

    @functools.cached_property
    def rc_min(self) -> float:
        """Smallest momentum cutoff, read once per params object (the
        bucket kernels refuse rcc above it with more than one type)."""
        return float(self.rc.min())

    def to(self, device) -> "TDPDParams":
        return dataclasses.replace(
            self, **{name: getattr(self, name).to(device) for name in
                     ("a", "gamma", "sigma", "rc", "kappa_c", "eps_c")})

    def replace(self, **kw) -> "TDPDParams":
        return dataclasses.replace(self, **kw)


def tdpd_flux(dr, c_i, c_j, xi, kappa_c, eps_c, rcc: float, s1: float,
              dt_inv_sqrt: float, inside_m):
    """Per-pair concentration flux into particle i, per species.

    c_i, c_j: (..., S); xi: (..., S) antisymmetric noise. Returns (..., S)."""
    # summed in x, y, z order, as the CUDA kernel sums it for w_dc
    r2 = (dr[..., 0] * dr[..., 0] + dr[..., 1] * dr[..., 1]) \
        + dr[..., 2] * dr[..., 2]
    inside = (r2 < rcc * rcc) & (r2 > 0.0) & inside_m
    r = sqrt32(torch.where(inside, r2, torch.ones_like(r2)))
    wdc = torch.clamp(1.0 - r / rcc, min=0.0)
    if s1 != 1.0:
        wdc = torch.pow(wdc, s1)
    q_d = -kappa_c * wdc[..., None] * (c_i - c_j)
    q_r = eps_c * sqrt32(wdc)[..., None] * xi * dt_inv_sqrt
    return torch.where(inside[..., None], q_d + q_r,
                       torch.zeros((), device=dr.device))


def noises_from_hash(hp, tag_i, tag_j, n_species: int):
    """(theta symmetric, xi (..., S) antisymmetric) from a pair hash."""
    theta = rngmod.uniform_stream(hp, 0)
    sign = torch.where(tag_i < tag_j, 1.0, -1.0)
    xi = torch.stack([sign * rngmod.uniform_stream(hp, 2 + s)
                      for s in range(n_species)], dim=-1)
    return theta, xi


def _noises(tag_i, tag_j, step, seed, rounds, n_species, rng_mode="fast"):
    hp = rngmod.pair_hash(tag_i, tag_j, step, seed, rounds, rng_mode)
    return noises_from_hash(hp, tag_i, tag_j, n_species)


def dense_forces_tdpd(x, v, c, typ, tag, mask, box: Box, step: int,
                      params: TDPDParams, dt: float, rng_rounds: int = 8,
                      rng_mode: str = "fast"):
    """O(N^2) tDPD oracle. Returns (f, dCdt, virial)."""
    n = x.shape[0]
    dr = box.min_image(x[:, None, :] - x[None, :, :])
    vij = v[:, None, :] - v[None, :, :]
    theta, xi = _noises(tag[:, None], tag[None, :], step, params.seed,
                        rng_rounds, params.n_species, rng_mode)
    ti, tj = typ[:, None].long(), typ[None, :].long()
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    valid = (mask[:, None] & mask[None, :]) & ~eye
    rc = torch.where(valid, params.rc[ti, tj],
                     torch.zeros((), device=x.device))
    dt_inv_sqrt = 1.0 / math.sqrt(dt)
    f_p, vir = pair_force(dr, vij, theta, params.a[ti, tj],
                          params.gamma[ti, tj], params.sigma[ti, tj], rc,
                          dt_inv_sqrt, params.s_exp)
    q_p = tdpd_flux(dr, c[:, None, :], c[None, :, :], xi, params.kappa_c,
                    params.eps_c, params.rcc, params.s1, dt_inv_sqrt, valid)
    return torch.sum(f_p, dim=1), torch.sum(q_p, dim=1), torch.sum(vir)


def bucket_forces_tdpd(x, v, c, typ, tag, mask, box: Box, step: int,
                       params: TDPDParams, dt: float, cfg, rng_rounds: int = 8,
                       rng_mode: str = "fast"):
    """tDPD forces over bucket-resident rows through the sweep, strict
    buckets only; rcc must not exceed the largest rc, which the stencil
    covers. s_exp and a multi-type rc table act as in the dense oracle
    (the JAX package's sweep departs from it there: ROADMAP Queue 3, R8
    and R9). Returns (f (nr, 3), dCdt (nr, S), virial)."""
    from meso_tpu_torch.ops.bucket_dpd import model_channels, require_strict
    from meso_tpu_torch.ops.sweep import sweep, tdpd_pair_fn
    require_strict(cfg, "bucket_forces_tdpd")
    if params.rcc > params.rc_max:
        raise ValueError(
            "bucket tDPD path requires rcc <= rc (rc-based stencil): "
            f"rcc={params.rcc}, rc={params.rc_max}")
    nr = x.shape[0]
    ns = params.n_species
    ch = model_channels(x, v, typ, tag, mask, step, params, cfg,
                        {f"C{s}": c[:, s] for s in range(ns)}, rng_mode,
                        rng_rounds)
    acc = sweep(ch, cfg.ncell, cfg.capacity, (False, False, False),
                box.lengths,
                tdpd_pair_fn(params, dt, ns, params.n_types > 1,
                             rng_mode=rng_mode, step=step,
                             rng_rounds=rng_rounds), 4 + ns)
    f = torch.stack([acc[0].reshape(nr), acc[1].reshape(nr),
                     acc[2].reshape(nr)], dim=-1)
    dcdt = torch.stack([acc[4 + s].reshape(nr) for s in range(ns)], dim=-1)
    return f, dcdt, torch.sum(acc[3])
