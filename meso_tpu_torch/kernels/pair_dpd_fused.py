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

The halo entry points ``halo_forces_pallas_fused`` and
``halo_forces_pallas_model_fused`` (K4, the distributed path's kernel) run
the same CUDA kernel over a brick of halo-extended channel planes
(``_brick.halo_brick``), counted as ``pair_halo_dpd``, ``pair_halo_edpd``
and ``pair_halo_tdpd``; their plain version walks the same brick. Where the
TPU kernel hashes the tag values of its brick in the fast RNG tier, these
read a per-particle hash plane "h" among the channels: the distributed
step hashes its local rows once a step and ships "h" with the halo, as the
TPU's K6-halo caller does.

``interpret``, ``z_chunks`` and ``vma`` (the TPU call's varying mesh
axes) are TPU lowering knobs, accepted and ignored; so are the TPU kernel's dynamic trip count and its carrying of tags as
float32 values (with their 2^24 cap): tags, types and exclusion tags stay
integer channels here.
"""

from __future__ import annotations

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.kernels import _brick
from meso_tpu_torch.kernels.common import (check_classic,
                                           check_classic_params, check_tdpd,
                                           check_tdpd_params, half_window)
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


def _check_counts(params, n_types: int, n_excl: int = 0) -> None:
    """The static counts the JAX signatures pass must be the parameters'
    own."""
    if n_types != params.n_types:
        raise ValueError(f"n_types={n_types}, but the parameters have "
                         f"{params.n_types} types")
    have = 0 if getattr(params, "excl", None) is None \
        else params.excl.shape[1]
    if n_excl != have:
        raise ValueError(f"n_excl={n_excl}, but the parameters carry {have} "
                         "exclusions per tag")


def halo_forces_pallas_fused(channels: dict, box: Box, step: int,
                             params: DPDParams, dt: float, cfg: CellConfig,
                             ext: tuple = ("x",), rng_mode: str = "fast",
                             rng_rounds: int = 8, interpret=None,
                             s_exp: float = 1.0, n_types: int = 1,
                             n_excl: int = 0, vma: tuple = ("x",)):
    """Classic-DPD forces over a halo-extended brick (K4). ``channels``:
    (ny_e, nz_e, K, nx_e) planes x, y, z, vx, vy, vz, tag, valid (+ the
    per-particle hash "h" in the fast tier, + typ with more than one type,
    + EX0 .. with exclusions); each axis in
    ``ext`` carries halo layers (x: two columns a side under spill, else
    one; y, z: one), the others are periodic and padded here. Halo
    coordinates may be raw or shifted by a box length: the kernel takes the
    minimum image against the global ``box``. Target cells are
    ``cfg.ncell``. Returns (f (nr, 3), virial)."""
    check_classic_params(params, s_exp)
    _check_counts(params, n_types, n_excl)
    f, _, virial = _brick.halo_forces(
        "dpd", "pair_halo_dpd", channels, box, step, params, dt, cfg, ext,
        rng_mode, rng_rounds, n_excl=n_excl)
    return f, virial


def halo_forces_pallas_model_fused(channels: dict, box: Box, step: int,
                                   params, dt: float, cfg: CellConfig,
                                   model: str = "edpd", ns: int = 0,
                                   ext: tuple = ("x",),
                                   rng_mode: str = "fast",
                                   rng_rounds: int = 8, interpret=None,
                                   n_types: int = 1, vma: tuple = ("x",)):
    """eDPD or tDPD over a halo-extended brick (K4): the planes of
    ``halo_forces_pallas_fused`` (no exclusions) and "T" (eDPD) or
    "C0" .. "C{ns-1}" (tDPD). tDPD refuses s_exp != 1 (R8: the TPU kernel
    takes s_exp = 1 whatever the parameters say) and rcc above the
    smallest rc_ij (R9). Returns (f, dT/dt (already over cv) or dC/dt,
    virial)."""
    if model == "edpd":
        fields = ("T",)
    elif model == "tdpd":
        check_tdpd_params(params)
        if ns != params.n_species:
            raise ValueError(f"ns={ns}, but the parameters have "
                             f"{params.n_species} species")
        fields = tuple(f"C{sp}" for sp in range(ns))
    else:
        raise ValueError(f"unknown model {model!r}")
    _check_counts(params, n_types)
    return _brick.halo_forces(
        model, f"pair_halo_{model}", channels, box, step, params, dt, cfg,
        ext, rng_mode, rng_rounds, fields=fields)
