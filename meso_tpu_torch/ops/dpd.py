"""Classic Groot-Warren DPD pair forces (port of ``meso_tpu/ops/dpd.py``).

    F_ij = [a w - gamma w^2 (e.v_ij) + sigma w theta_ij / sqrt(dt)] e,
    w(r) = 1 - r/rc,  sigma^2 = 2 gamma kT.

``dense_forces`` is the port's own O(N^2) oracle for the bucket kernel;
``nlist_forces`` sums the same pair term over a padded neighbour list
(force_path "nlist").
Special-bonds exclusions (``special_weight``, ``build_exclusions``) scale
the whole pair force and virial of a bonded pair by one weight.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from meso_tpu_torch.core import rng as rngmod
from meso_tpu_torch.core.box import Box


@dataclass(frozen=True)
class DPDParams:
    """Per-type-pair coefficient tables.

    The (T, T) tables are float32 tensors on the simulation device. ``seed``
    is the uint32 value of the global RNG seed, held as a Python int; ``kt``
    and ``s_exp`` are Python floats. ``excl`` is the special-bonds table,
    (n_tags + 1, E) int32 indexed by tag, 0 for an empty slot, and
    ``excl_w`` its 0-d float32 weight; both None without exclusions."""

    a: torch.Tensor
    gamma: torch.Tensor
    sigma: torch.Tensor
    rc: torch.Tensor
    kt: float
    seed: int
    s_exp: float = 1.0
    excl: torch.Tensor | None = None
    excl_w: torch.Tensor | None = None

    @staticmethod
    def build(a, gamma, rc, kt: float, seed: int, n_types: int = 1,
              s_exp: float = 1.0, device=None) -> "DPDParams":
        def table(val):
            arr = torch.as_tensor(val, dtype=torch.float32, device=device)
            if arr.ndim == 0:
                arr = torch.full((n_types, n_types), float(arr),
                                 dtype=torch.float32, device=device)
            return arr
        a_t, g_t, rc_t = table(a), table(gamma), table(rc)
        kt32 = torch.tensor(kt, dtype=torch.float32, device=device)
        return DPDParams(a=a_t, gamma=g_t, sigma=torch.sqrt(2.0 * kt32 * g_t),
                         rc=rc_t, kt=float(kt), seed=int(seed) & 0xFFFFFFFF,
                         s_exp=float(s_exp))

    @property
    def n_types(self) -> int:
        return self.a.shape[0]

    def to(self, device) -> "DPDParams":
        def move(t):
            return None if t is None else t.to(device)
        return dataclasses.replace(
            self, a=self.a.to(device), gamma=self.gamma.to(device),
            sigma=self.sigma.to(device), rc=self.rc.to(device),
            excl=move(self.excl), excl_w=move(self.excl_w))

    def replace(self, **kw) -> "DPDParams":
        return dataclasses.replace(self, **kw)


def f32(val) -> float:
    """The float32 value of a Python number, as a Python float."""
    return float(torch.tensor(float(val), dtype=torch.float32))


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, through float64.

    PyTorch's float32 CPU ``sqrt`` (2.13 CPU build) is up to 1 ulp off, and
    has returned values accurate to only 2^-12 for one worker thread's
    chunk on a process's first calls; the float64 root rounded to float32
    is exact, as XLA's and the CUDA kernels' ``sqrtf`` are."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def pair_force(dr, vij, theta, a, gamma, sigma, rc, dt_inv_sqrt: float,
               s_exp: float):
    """Groot-Warren force for a batch of pairs.

    dr, vij: (..., 3); theta, a, gamma, sigma, rc: (...). Returns the force
    on particle i (zero where r >= rc or r == 0) and 0.5 * dr.f per pair."""
    r2 = torch.sum(dr * dr, dim=-1)
    inside = (r2 < rc * rc) & (r2 > 0.0)
    r2s = torch.where(inside, r2, torch.ones_like(r2))
    rinv = torch.rsqrt(r2s)
    r = r2s * rinv
    w = 1.0 - r / rc
    wr = w if s_exp == 1.0 else torch.pow(w, s_exp)
    wd = wr * wr
    ev = torch.sum(dr * vij, dim=-1) * rinv
    fmag = a * w - gamma * wd * ev + sigma * wr * theta * dt_inv_sqrt
    fmag = torch.where(inside, fmag, torch.zeros_like(fmag))
    f = (fmag * rinv)[..., None] * dr
    return f, 0.5 * fmag * r


def special_weight(tag_i, tag_j, params: DPDParams) -> torch.Tensor:
    """Pairwise special-bonds weight: ``excl_w`` where tag_j is in tag_i's
    exclusion list, else 1. Shapes broadcast like tag_i and tag_j."""
    shape = torch.broadcast_shapes(tag_i.shape, tag_j.shape)
    if params.excl is None:
        return torch.ones(shape, dtype=torch.float32, device=tag_i.device)
    ex = params.excl[tag_i.long()]                      # (..., E)
    hit = torch.any(ex == tag_j[..., None], dim=-1)
    return torch.where(hit, params.excl_w.to(torch.float32),
                       torch.ones((), dtype=torch.float32,
                                  device=tag_i.device))


def build_exclusions(bond_tags, n_tags: int, weight: float = 0.0,
                     max_excl: int = 6, device=None):
    """Host-side: per-tag exclusion lists from an (NB, 2) bond-tag table.
    Returns (excl (n_tags + 1, max_excl) int32, weight 0-d float32) on
    ``device``; the table is filled in bond order, as the JAX package's."""
    ex = np.zeros((n_tags + 1, max_excl), np.int32)
    cnt = np.zeros(n_tags + 1, np.int32)
    for a, b in np.asarray(bond_tags):
        if a <= 0:
            continue
        for s, t in ((a, b), (b, a)):
            if cnt[s] >= max_excl:
                raise ValueError(f"tag {s}: more than {max_excl} exclusions")
            ex[s, cnt[s]] = t
            cnt[s] += 1
    return (torch.from_numpy(ex).to(device),
            torch.tensor(weight, dtype=torch.float32, device=device))


def _theta_dense(tag, step: int, params: DPDParams, rng_mode: str,
                 rng_rounds: int):
    """(N, N) symmetric noise matrix for the dense path."""
    if rng_mode == "tea":
        return rngmod.pair_uniform_tea(tag[:, None], tag[None, :], step,
                                       params.seed, rounds=rng_rounds)
    if rng_mode == "fast":
        h = rngmod.particle_hash(tag, step, params.seed, rounds=rng_rounds)
        return rngmod.pair_uniform_fast(h[:, None], h[None, :])
    raise ValueError(f"unknown rng_mode {rng_mode!r}")


def nlist_forces(x, v, typ, tag, mask, box: Box, step: int,
                 params: DPDParams, dt: float, nlist_idx,
                 rng_mode: str = "tea", rng_rounds: int = 8):
    """O(N M) forces over a padded full neighbour matrix (N, M), whose pad
    entries are N: one writer per particle, the noise recomputed per pair
    from the tags. Lists reach rc + skin; the cutoff test of
    ``pair_force`` drops the skin shell. Returns (f, virial)."""
    n = x.shape[0]
    valid = nlist_idx < n
    j = torch.clamp(nlist_idx, max=n - 1).long()             # (N, M)
    dr = box.min_image(x[:, None, :] - x[j])
    vij = v[:, None, :] - v[j]
    tag_j = tag[j]
    if rng_mode == "tea":
        theta = rngmod.pair_uniform_tea(tag[:, None], tag_j, step,
                                        params.seed, rounds=rng_rounds)
    elif rng_mode == "fast":
        h = rngmod.particle_hash(tag, step, params.seed, rounds=rng_rounds)
        theta = rngmod.pair_uniform_fast(h[:, None], h[j])
    else:
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    ti, tj = typ[:, None].long(), typ[j].long()
    rc = torch.where(valid & mask[:, None], params.rc[ti, tj],
                     torch.zeros((), device=x.device))
    f_pair, vir_half = pair_force(dr, vij, theta, params.a[ti, tj],
                                  params.gamma[ti, tj], params.sigma[ti, tj],
                                  rc, 1.0 / math.sqrt(dt),
                                  params.s_exp)
    if params.excl is not None:
        w_sp = special_weight(tag[:, None], tag_j, params)
        f_pair = f_pair * w_sp[..., None]
        vir_half = vir_half * w_sp
    return torch.sum(f_pair, dim=1), torch.sum(vir_half)


def dense_forces(x, v, typ, tag, mask, box: Box, step: int,
                 params: DPDParams, dt: float, rng_mode: str = "tea",
                 rng_rounds: int = 8):
    """O(N^2) reference force evaluation. Returns (f, virial, n_neighbors).
    With exclusions the special-bonds weight scales each pair's force and
    virial; n_neighbors counts every pair inside its cutoff."""
    n = x.shape[0]
    dr = box.min_image(x[:, None, :] - x[None, :, :])
    vij = v[:, None, :] - v[None, :, :]
    theta = _theta_dense(tag, step, params, rng_mode, rng_rounds)
    ti, tj = typ[:, None].long(), typ[None, :].long()
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    valid = (mask[:, None] & mask[None, :]) & ~eye
    rc = torch.where(valid, params.rc[ti, tj],
                     torch.zeros((), device=x.device))
    dt_inv_sqrt = 1.0 / math.sqrt(dt)
    f_pair, vir_half = pair_force(dr, vij, theta, params.a[ti, tj],
                                  params.gamma[ti, tj], params.sigma[ti, tj],
                                  rc, dt_inv_sqrt, params.s_exp)
    if params.excl is not None:
        w_sp = special_weight(tag[:, None], tag[None, :], params)
        f_pair = f_pair * w_sp[..., None]
        vir_half = vir_half * w_sp
    f = torch.sum(f_pair, dim=1)
    virial = torch.sum(vir_half)
    r2 = torch.sum(dr * dr, dim=-1)
    n_neigh = torch.sum(valid & (r2 < rc * rc) & (r2 > 0.0), dim=1)
    return f, virial, n_neigh
