"""The fused-lane selectors (port of ``meso_tpu/kernels/pair_dpd_fused.py``,
K5: ``bucket_forces_pallas_fused``, ``bucket_forces_pallas_edpd_fused`` and
``bucket_forces_pallas_tdpd_fused``, reached with ``pair_kernel="v2"``).

Each entry point computes the full-stencil classic, eDPD or tDPD pair terms
of bucket rows with no Newton folding and the minimum image on every axis,
over the +-1 (strict) or +-2 (spill) x-window; multi-type tables, s_exp and
special-bonds exclusions (classic) and any number of species (tDPD) are
covered. On a CUDA tensor it builds the padded brick and launches the
hand-written Hopper kernel of ``csrc/pair_brick.cu`` (``kernels/_brick.py``,
whose ``LAUNCHES`` counts it) or raises; on a CPU tensor, and only there,
it runs the plain torch version ``_brick.brick_forces_plain``, which walks
the same brick. tDPD refuses s_exp != 1 (ROADMAP Queue 3, R8), rcc > rc
and, with more than one type, rcc above the smallest rc_ij (R9).

``interpret`` and ``z_chunks`` are TPU lowering knobs, accepted and
ignored; so are the TPU kernel's dynamic trip count and its carrying of
tags as float32 values (with their 2^24 cap). The halo entry points
(``halo_forces_pallas_fused``, ``halo_forces_pallas_model_fused``, K4) wait
for the distributed path (ROADMAP Queue 1 item 14); ``_brick.build_brick``
is written so that path can hand the same kernel its halo planes.
"""

from __future__ import annotations

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.kernels import _brick
from meso_tpu_torch.kernels.common import (check_classic, check_tdpd,
                                           half_window)
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops.dpd import DPDParams


def bucket_forces_pallas_fused(x, v, typ, tag, mask, box: Box, step: int,
                               params: DPDParams, dt: float, cfg: CellConfig,
                               rng_mode: str = "fast", rng_rounds: int = 8,
                               interpret=None, s_exp: float = 1.0,
                               z_chunks: int = 0):
    """Classic-DPD forces on bucket rows. Returns (f (nr, 3), virial).
    ``s_exp`` is the System's mirror of ``params.s_exp`` and must equal
    it."""
    check_classic(params, cfg, rng_mode, s_exp, False)
    return _brick.forces("dpd", "pair_fused_dpd", x, v, None, typ, tag, mask,
                         box, step, params, dt, cfg, rng_mode, rng_rounds)


def bucket_forces_pallas_edpd_fused(x, v, t, typ, tag, mask, box: Box,
                                    step: int, params, dt: float,
                                    cfg: CellConfig, rng_rounds: int = 8,
                                    interpret=None, rng_mode: str = "fast",
                                    z_chunks: int = 0):
    """eDPD forces and heat on bucket rows. Returns (f (nr, 3), dTdt (nr,),
    virial)."""
    half_window(cfg, rng_mode)
    return _brick.forces("edpd", "pair_fused_edpd", x, v, t, typ, tag, mask,
                         box, step, params, dt, cfg, rng_mode, rng_rounds)


def bucket_forces_pallas_tdpd_fused(x, v, c, typ, tag, mask, box: Box,
                                    step: int, params, dt: float,
                                    cfg: CellConfig, rng_rounds: int = 8,
                                    interpret=None, rng_mode: str = "fast",
                                    z_chunks: int = 0):
    """tDPD forces and per-species fluxes on bucket rows. Returns
    (f (nr, 3), dCdt (nr, S), virial)."""
    check_tdpd(params, cfg, rng_mode)
    return _brick.forces("tdpd", "pair_fused_tdpd", x, v, c, typ, tag, mask,
                         box, step, params, dt, cfg, rng_mode, rng_rounds)
