"""Force-path validation against the dense O(N^2) oracles (port of
``meso_tpu/utils/debug.py``): recompute the configured force path and the
dense reference on one state and report the deviation. Run it when a
checked invariant fires or the physics looks off; O(N^2), so validation
scale only.

Covers every model path: classic DPD, eDPD (force + dT/dt), tDPD (force +
dC/dt), and bonded systems (the pair path with special-bonds exclusions,
plus the bonded terms' invariants: every partner resolved, zero net
momentum, finite).
"""

from __future__ import annotations

import torch

from meso_tpu_torch.core.state import State
from meso_tpu_torch.core.system import System, SystemParams, compute_forces
from meso_tpu_torch.ops.dpd import dense_forces


def _dev(name, got, ref, mask):
    m = mask if got.ndim == 1 else mask[..., None]
    zero = torch.zeros((), dtype=got.dtype, device=got.device)
    diff = torch.abs(torch.where(m, got - ref, zero))
    scale = torch.max(torch.abs(torch.where(m, ref, zero)))
    return {f"{name}_max_abs": float(torch.max(diff)),
            f"{name}_max_rel": float(torch.max(diff)
                                     / torch.clamp(scale, min=1e-12)),
            f"{name}_scale": float(scale)}


def _on_valid_rows(fn, state: State, *fields):
    """``fn`` on the state's valid rows only (bucket layouts carry many
    padding rows, which cost the O(N^2) oracle and add nothing), its
    per-row outputs scattered back to every row (0 on padding) and its
    other outputs as they are."""
    idx = torch.nonzero(state.mask).squeeze(1)
    sub = [None if a is None else a[idx] for a in
           (state.x, state.v) + fields + (state.typ, state.tag, state.mask)]
    out = fn(*sub)
    full = []
    for o in out:
        if o.ndim and o.shape[0] == idx.numel():
            o = torch.zeros((state.n,) + o.shape[1:], dtype=o.dtype,
                            device=o.device).index_copy_(0, idx, o)
        full.append(o)
    return full


def validate_forces(system: System, params: SystemParams,
                    state: State) -> dict:
    """Deviation of the configured force path from the dense O(N^2) oracle
    at this state. Keys: f_max_abs / f_max_rel / f_scale, plus dTdt_*
    (eDPD), dCdt_* (tDPD), bonded_* (bonded styles), and the aliases
    max_abs / max_rel / scale of the force's."""
    out: dict = {}
    nlist_idx = None
    if system.force_path == "nlist":
        from meso_tpu_torch.core.system import rebuild
        state, nlist_idx, _, _ = rebuild(system, state)
    mask = state.mask
    rng = dict(rng_rounds=system.rng_rounds, rng_mode=system.rng_mode)
    if system.model == "edpd":
        from meso_tpu_torch.ops.edpd import dense_forces_edpd
        f_path, aux = compute_forces(system, params, state, state.x,
                                     state.v, state.step,
                                     nlist_idx=nlist_idx, t=state.T)
        f_ref, dtdt_ref, _ = _on_valid_rows(
            lambda *a: dense_forces_edpd(*a, state.box, state.step,
                                         params.pair, system.dt, **rng),
            state, state.T)
        out.update(_dev("f", f_path, f_ref, mask))
        out.update(_dev("dTdt", aux["dTdt"], dtdt_ref, mask))
    elif system.model == "tdpd":
        from meso_tpu_torch.ops.tdpd import dense_forces_tdpd
        f_path, aux = compute_forces(system, params, state, state.x,
                                     state.v, state.step,
                                     nlist_idx=nlist_idx, c=state.C)
        f_ref, dcdt_ref, _ = _on_valid_rows(
            lambda *a: dense_forces_tdpd(*a, state.box, state.step,
                                         params.pair, system.dt, **rng),
            state, state.C)
        out.update(_dev("f", f_path, f_ref, mask))
        out.update(_dev("dCdt", aux["dCdt"], dcdt_ref, mask))
    else:
        f_path, _ = compute_forces(system, params, state, state.x, state.v,
                                   state.step, nlist_idx=nlist_idx)
        f_ref, _, _ = _on_valid_rows(
            lambda *a: dense_forces(*a, state.box, state.step, params.pair,
                                    system.dt, **rng), state)
        out.update(_dev("f", f_path, f_ref, mask))

    if system.bond_style is not None and params.bonded is not None:
        # the bonded terms are deterministic tag-space sums; their failure
        # modes are a corrupt tag map and missing partners: check that
        # every term resolved, that the bonded forces carry no net
        # momentum (Newton's third law) and that they are finite
        from meso_tpu_torch.ops.bonded import bonded_forces_ext
        fb, missing = bonded_forces_ext(
            state.x, state.tag, mask, state.box, params.bonded,
            system.bond_style, system.n_tags, system.n_mols,
            image=state.image)
        fb = torch.where(mask[:, None], fb, torch.zeros((), device=fb.device))
        scale = torch.clamp(torch.max(torch.abs(fb)), min=1e-12)
        out["bonded_missing"] = int(missing)
        out["bonded_momentum_rel"] = float(
            torch.max(torch.abs(torch.sum(fb, dim=0))) / scale)
        out["bonded_finite"] = bool(torch.isfinite(fb).all())

    out["max_abs"] = out["f_max_abs"]
    out["max_rel"] = out["f_max_rel"]
    out["scale"] = out["f_scale"]
    return out
