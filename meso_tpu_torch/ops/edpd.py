"""eDPD — energy-conserving DPD with a per-particle internal temperature
(port of ``meso_tpu/ops/edpd.py``).

momentum:  F = a w e - gamma w^2 (e.v) e + sigma_ij w theta dt^-1/2 e,
           sigma_ij^2 = 4 gamma T_i T_j / (T_i + T_j)   (generalized FDT)
energy:    C_v dT_i/dt = sum_j (q^C + q^V + q^R)
           q^C = k_ij w^2 (1/T_i - 1/T_j),  k_ij = kappa (T_i + T_j)^2 / 4
           q^V = 1/2 [w^2 (gamma (e.v)^2 - sigma_ij^2/m)
                      - sigma_ij w (e.v) theta dt^-1/2]
           q^R = sqrt(2 k_ij) w zeta dt^-1/2, zeta antisymmetric.

``dense_forces_edpd`` is the port's own O(N^2) oracle. The bucket kernel
(K2) is ``kernels.pair_dpd_v3.bucket_forces_pallas_v3_edpd``;
``bucket_forces_edpd`` is the 27-offset sweep over the same rows
(force_path "bucket").
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from meso_tpu_torch.core import rng as rngmod
from meso_tpu_torch.core.box import Box
from meso_tpu_torch.ops.dpd import f32, sqrt32


@dataclass(frozen=True)
class EDPDParams:
    """Coefficients for eDPD: (T, T) float32 tables on the simulation
    device; ``cv`` and ``mass`` are Python floats (the float32 values of
    the JAX package's scalars) and ``seed`` the uint32 value of the RNG
    seed."""

    a: torch.Tensor
    gamma: torch.Tensor
    rc: torch.Tensor
    kappa: torch.Tensor
    cv: float
    mass: float
    seed: int

    @staticmethod
    def build(a, gamma, rc, kappa, cv: float, seed: int, n_types: int = 1,
              mass: float = 1.0, device=None) -> "EDPDParams":
        def table(val):
            arr = torch.as_tensor(val, dtype=torch.float32, device=device)
            if arr.ndim == 0:
                arr = torch.full((n_types, n_types), float(arr),
                                 dtype=torch.float32, device=device)
            return arr
        return EDPDParams(a=table(a), gamma=table(gamma), rc=table(rc),
                          kappa=table(kappa), cv=f32(cv), mass=f32(mass),
                          seed=int(seed) & 0xFFFFFFFF)

    @property
    def n_types(self) -> int:
        return self.a.shape[0]

    def to(self, device) -> "EDPDParams":
        return dataclasses.replace(
            self, **{name: getattr(self, name).to(device)
                     for name in ("a", "gamma", "rc", "kappa")})

    def replace(self, **kw) -> "EDPDParams":
        return dataclasses.replace(self, **kw)


def edpd_pair(dr, vij, t_i, t_j, theta, zeta, a, gamma, rc, kappa,
              mass: float, dt_inv_sqrt: float):
    """Per-pair momentum force and heat rate for particle i.

    Returns (f (..., 3), q (...), virial_half (...)). theta symmetric,
    zeta antisymmetric under i <-> j."""
    r2 = torch.sum(dr * dr, dim=-1)
    inside = (r2 < rc * rc) & (r2 > 0.0)
    r2s = torch.where(inside, r2, torch.ones_like(r2))
    rinv = torch.rsqrt(r2s)
    r = r2s * rinv
    w = 1.0 - r / rc
    ev = torch.sum(dr * vij, dim=-1) * rinv
    zero = torch.zeros_like(r2)
    # generalized FDT
    sigma2 = 4.0 * gamma * t_i * t_j / torch.clamp(t_i + t_j, min=1e-12)
    sigma = sqrt32(torch.clamp(sigma2, min=0.0))
    w2 = w * w
    fmag = a * w - gamma * w2 * ev + sigma * w * theta * dt_inv_sqrt
    fmag = torch.where(inside, fmag, zero)
    f = (fmag * rinv)[..., None] * dr

    k_ij = kappa * 0.25 * (t_i + t_j) ** 2
    q_c = k_ij * w2 * (1.0 / torch.clamp(t_i, min=1e-12)
                       - 1.0 / torch.clamp(t_j, min=1e-12))
    q_v = 0.5 * (w2 * (gamma * ev * ev - sigma2 / mass)
                 - sigma * w * ev * theta * dt_inv_sqrt)
    beta = sqrt32(torch.clamp(2.0 * k_ij, min=0.0))
    q_r = beta * w * zeta * dt_inv_sqrt
    q = torch.where(inside, q_c + q_v + q_r, zero)
    return f, q, 0.5 * fmag * r


def noises_from_hash(hp, tag_i, tag_j):
    """(theta symmetric, zeta antisymmetric) from a symmetric pair hash."""
    theta = rngmod.uniform_stream(hp, 0)
    sign = torch.where(tag_i < tag_j, 1.0, -1.0)
    return theta, sign * rngmod.uniform_stream(hp, 1)


def _pair_noises(tag_i, tag_j, step, seed, rounds, rng_mode="fast"):
    """(theta, zeta) from one pair hash; rng_mode 'tea' uses the TEA hash
    of the sorted tag pair."""
    hp = rngmod.pair_hash(tag_i, tag_j, step, seed, rounds, rng_mode)
    return noises_from_hash(hp, tag_i, tag_j)


def dense_forces_edpd(x, v, t, typ, tag, mask, box: Box, step: int,
                      params: EDPDParams, dt: float, rng_rounds: int = 8,
                      rng_mode: str = "fast"):
    """O(N^2) eDPD oracle. Returns (f, dTdt, virial)."""
    n = x.shape[0]
    dr = box.min_image(x[:, None, :] - x[None, :, :])
    vij = v[:, None, :] - v[None, :, :]
    theta, zeta = _pair_noises(tag[:, None], tag[None, :], step, params.seed,
                               rng_rounds, rng_mode)
    ti, tj = typ[:, None].long(), typ[None, :].long()
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    valid = (mask[:, None] & mask[None, :]) & ~eye
    rc = torch.where(valid, params.rc[ti, tj],
                     torch.zeros((), device=x.device))
    f_p, q_p, vir = edpd_pair(dr, vij, t[:, None], t[None, :], theta, zeta,
                              params.a[ti, tj], params.gamma[ti, tj], rc,
                              params.kappa[ti, tj], params.mass,
                              1.0 / math.sqrt(dt))
    return (torch.sum(f_p, dim=1), torch.sum(q_p, dim=1) / params.cv,
            torch.sum(vir))


def bucket_forces_edpd(x, v, t, typ, tag, mask, box: Box, step: int,
                       params: EDPDParams, dt: float, cfg, rng_rounds: int = 8,
                       rng_mode: str = "fast"):
    """eDPD forces over bucket-resident rows through the sweep
    (``ops/sweep.py``), strict buckets only. Returns (f (nr, 3), dTdt (nr,),
    virial)."""
    from meso_tpu_torch.ops.bucket_dpd import model_channels, require_strict
    from meso_tpu_torch.ops.sweep import edpd_pair_fn, sweep
    require_strict(cfg, "bucket_forces_edpd")
    nr = x.shape[0]
    ch = model_channels(x, v, typ, tag, mask, step, params, cfg, {"T": t},
                        rng_mode, rng_rounds)
    acc = sweep(ch, cfg.ncell, cfg.capacity, (False, False, False),
                box.lengths,
                edpd_pair_fn(params, dt, params.n_types > 1,
                             rng_mode=rng_mode, step=step,
                             rng_rounds=rng_rounds), 5)
    f = torch.stack([acc[0].reshape(nr), acc[1].reshape(nr),
                     acc[2].reshape(nr)], dim=-1)
    return f, acc[4].reshape(nr) / params.cv, torch.sum(acc[3])
