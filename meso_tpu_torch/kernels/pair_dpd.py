"""The banded classic selector (port of ``meso_tpu/kernels/pair_dpd.py``,
K6: ``bucket_forces_pallas``, reached with ``force_path="pallas_banded"``).

The same full-stencil classic forces as the fused selector
(``kernels/pair_dpd_fused.py``): multi-type tables, ``params.s_exp`` and
special-bonds exclusions, both RNG tiers, the minimum image on every axis.
On one card K6 reads the bucket rows in place: the per-particle hash (fast
tier, one launch), then one launch of K1's general tile kernel under the
minimum image (``pair_dpd_v3.general_forces``: ``csrc/cell_tiles.cuh``'s
raw-difference walk over bucket rows with K1's plan and table, the classic
visitor of ``csrc/pair_visitor.cuh`` over the row arrays), counted in
``_build.LAUNCHES["pair_banded_dpd"]``. It builds no brick: the brick
kernel over the padded brick (``kernels/_brick.py``, ``csrc/pair_brick.cu``)
computed the same function from the same floats, in the same walk and
summation order. On a CPU tensor, and only there, K6 runs the plain torch
version ``_brick.brick_forces_plain``.

K6 on one card takes K1's capacity limit: K1's plan refuses a strict
capacity above 396 slots a cell with ``ValueError``, before the library is
touched, where the brick's plan, which K6 ran on before, took up to 495
(ROADMAP Queue 4, item 9). The plain version and K6-halo keep theirs.

Strict buckets only. The TPU kernel walks a +-1 x-window and has no spill
handling, so under a spill layout it silently drops the pairs whose
slot-cells are two columns apart (ROADMAP Queue 3, R7); this entry point
raises ``ValueError`` for a spill ``CellConfig`` instead
(``kernels.common.check_strict``).

The 1-D halo entry point ``halo_forces_pallas_1d`` (K6-halo, the banded
kernel on the distributed path) keeps the brick: the brick kernel over a
slab extended by one halo column a side (``_brick.halo_brick``), counted as
``pair_halo_banded_dpd``; strict buckets only there too (R7).

``interpret``, ``rows_per_step`` and ``vma`` are TPU lowering knobs,
accepted and ignored.
"""

from __future__ import annotations

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.kernels import _brick
from meso_tpu_torch.kernels import pair_dpd_v3 as v3
from meso_tpu_torch.kernels.common import (check_classic,
                                           check_classic_params,
                                           check_strict)
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops.dpd import DPDParams


def bucket_forces_pallas(x, v, typ, tag, mask, box: Box, step: int,
                         params: DPDParams, dt: float, cfg: CellConfig,
                         rng_mode: str = "fast", rng_rounds: int = 8,
                         interpret: bool = False, rows_per_step: int = 0):
    """Classic-DPD forces on strict bucket rows. Returns (f (nr, 3),
    virial)."""
    check_strict(cfg)
    xr, _ = check_classic(params, cfg, rng_mode, params.s_exp, False)
    if x.device.type == "cpu":
        f, _, virial = _brick.brick_forces_plain(
            "dpd", x, v, None, typ, tag, mask, box, step, params, dt, cfg,
            rng_mode, rng_rounds)
        return f, virial
    return v3.general_forces(x, v, typ, tag, mask, box, step, params, dt,
                             cfg, xr, rng_mode, rng_rounds, True,
                             "pair_banded_dpd")


def halo_forces_pallas_1d(channels: dict, box: Box, step: int,
                          params: DPDParams, dt: float, cfg: CellConfig,
                          rng_mode: str = "fast", rng_rounds: int = 8,
                          interpret=None, rows_per_step: int = 0,
                          n_types: int = 1, vma: tuple = ("x",)):
    """Classic-DPD forces over a 1-D x-decomposed slab (K6-halo):
    ``channels`` are (ny, nz, K, nx + 2) planes x, y, z, vx, vy, vz, tag,
    valid, the per-particle hash "h" (fast tier) and typ (more than one
    type), the local grid extended by one halo column a side; y and z are
    periodic and padded here. No exclusions, as on the TPU. Returns
    (f (nr, 3), virial)."""
    check_strict(cfg)
    check_classic_params(params, params.s_exp)
    if params.excl is not None:
        raise ValueError("the banded halo kernel takes no special-bonds "
                         "exclusions; use halo_forces_pallas_fused")
    if n_types != params.n_types:
        raise ValueError(f"n_types={n_types}, but the parameters have "
                         f"{params.n_types} types")
    nxe = channels["x"].shape[-1]
    if cfg.ncell[0] != nxe - 2:
        raise ValueError(f"planes of {nxe} columns hold {nxe - 2} target "
                         f"columns; cfg.ncell={cfg.ncell}")
    f, _, virial = _brick.halo_forces(
        "dpd", "pair_halo_banded_dpd", channels, box, step, params, dt, cfg,
        ("x",), rng_mode, rng_rounds)
    return f, virial
