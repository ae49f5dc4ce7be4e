"""The banded eDPD and tDPD selectors (port of
``meso_tpu/kernels/pair_multiphysics.py``, K7: ``bucket_forces_pallas_edpd``
and ``bucket_forces_pallas_tdpd``, reached with
``force_path="pallas_banded"``).

The same full-stencil eDPD and tDPD terms as the fused selector
(``kernels/pair_dpd_fused.py``), on the same hand-written Hopper kernel
(``csrc/pair_brick.cu``, counted in ``_brick.LAUNCHES``): multi-type
tables, any number of species, both RNG tiers, the minimum image on every
axis. On a CPU tensor, and only there, each runs the plain torch version
``_brick.brick_forces_plain``. Strict buckets only, as K6
(``kernels.common.check_strict``, ROADMAP Queue 3, R7); tDPD refuses
s_exp != 1 (R8), rcc > rc and, with more than one type, rcc above the
smallest rc_ij (R9). ``interpret`` is accepted and ignored.
"""

from __future__ import annotations

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.kernels import _brick
from meso_tpu_torch.kernels.common import (check_strict, check_tdpd,
                                           half_window)
from meso_tpu_torch.neighbor.cells import CellConfig


def bucket_forces_pallas_edpd(x, v, t, typ, tag, mask, box: Box, step: int,
                              params, dt: float, cfg: CellConfig,
                              rng_rounds: int = 8, interpret: bool = False,
                              rng_mode: str = "fast"):
    """eDPD forces and heat on strict bucket rows. Returns (f (nr, 3),
    dTdt (nr,), virial)."""
    check_strict(cfg)
    half_window(cfg, rng_mode)
    return _brick.forces("edpd", "pair_banded_edpd", x, v, t, typ, tag, mask,
                         box, step, params, dt, cfg, rng_mode, rng_rounds)


def bucket_forces_pallas_tdpd(x, v, c, typ, tag, mask, box: Box, step: int,
                              params, dt: float, cfg: CellConfig,
                              rng_rounds: int = 8, interpret: bool = False,
                              rng_mode: str = "fast"):
    """tDPD forces and per-species fluxes on strict bucket rows. Returns
    (f (nr, 3), dCdt (nr, S), virial)."""
    check_strict(cfg)
    check_tdpd(params, cfg, rng_mode)
    return _brick.forces("tdpd", "pair_banded_tdpd", x, v, c, typ, tag, mask,
                         box, step, params, dt, cfg, rng_mode, rng_rounds)
