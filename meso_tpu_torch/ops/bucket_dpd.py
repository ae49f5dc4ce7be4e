"""Classic DPD forces over the bucket-resident layout through the 27-offset
sweep (port of ``meso_tpu/ops/bucket_dpd.py``; force_path "bucket").

The JAX package's XLA twin of its Pallas pair kernels: 27 static cell
offsets as rolls and broadcast pair blocks, no gathers, no scatters, one
writer per row. It is plain torch here too; the fast tier's per-particle
hash goes through the hash kernel (``kernels.pair_dpd_v3.particle_hash_v3``)
on the card.
"""

from __future__ import annotations

import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops.dpd import DPDParams
from meso_tpu_torch.ops.sweep import classic_pair_fn, make_channels, sweep


def require_strict(cfg: CellConfig, what: str) -> None:
    """The sweep walks a +-1 x-window: strict buckets only."""
    if cfg.spill:
        raise ValueError(f"{what} requires strict buckets; the right-spill "
                         "layout is for force_path 'pallas'")


def fast_hash(tag, step: int, params, rng_mode: str, rng_rounds: int):
    """The per-particle hash the fast tier combines per pair (one launch of
    the hash kernel on the card); None for TEA, which hashes the tag pair
    itself."""
    if rng_mode != "fast":
        return None
    from meso_tpu_torch.kernels.pair_dpd_v3 import particle_hash_v3
    return particle_hash_v3(tag, step, params.seed, rng_rounds)


def model_channels(x, v, typ, tag, mask, step: int, params, cfg: CellConfig,
                   extra: dict, rng_mode: str, rng_rounds: int) -> dict:
    """The sweep's planes of bucket rows: make_channels with the fast
    tier's hash, plus 'typ' with more than one type."""
    ch = make_channels(x, v, tag, mask,
                       fast_hash(tag, step, params, rng_mode, rng_rounds),
                       extra, cfg.ncell, cfg.capacity)
    if params.n_types > 1:
        ch["typ"] = typ.reshape(ch["tag"].shape)
    return ch


def exclusion_channels(tag, params: DPDParams, shape) -> dict:
    """EX0 .. EX{E-1}: each row's excluded tags, as planes."""
    from meso_tpu_torch.kernels._brick import exclusion_rows
    if params.excl is None:
        return {}
    ex = exclusion_rows(tag, params)
    return {f"EX{e}": ex[:, e].reshape(shape)
            for e in range(params.excl.shape[1])}


def bucket_forces_xla(x, v, typ, tag, mask, box: Box, step: int,
                      params: DPDParams, dt: float, cfg: CellConfig,
                      rng_mode: str = "fast", rng_rounds: int = 8):
    """Forces for bucket-resident rows. Returns (f (nr, 3), virial).
    Multi-type tables, s_exp != 1, exclusions and both RNG tiers; strict
    buckets only, as in the JAX package."""
    require_strict(cfg, "bucket_forces_xla")
    nr = x.shape[0]
    ch = model_channels(x, v, typ, tag, mask, step, params, cfg, {},
                        rng_mode, rng_rounds)
    ch.update(exclusion_channels(tag, params, ch["tag"].shape))
    n_excl = 0 if params.excl is None else params.excl.shape[1]
    pair_fn = classic_pair_fn(params, dt, rng_mode=rng_mode, step=step,
                              rng_rounds=rng_rounds,
                              multitype=params.n_types > 1, n_excl=n_excl)
    acc = sweep(ch, cfg.ncell, cfg.capacity, (False, False, False),
                box.lengths, pair_fn, 4)
    f = torch.stack([acc[0].reshape(nr), acc[1].reshape(nr),
                     acc[2].reshape(nr)], dim=-1)
    return f, torch.sum(acc[3])
