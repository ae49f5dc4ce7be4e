"""Carry states and parameters across from the JAX package, and back.

Each ``*_from`` function takes a mapping of arrays, or an object whose
attributes are arrays (a ``meso_tpu`` State, Box, DPDParams, EDPDParams,
TDPDParams, BondedParams, SystemParams, CellConfig, CellList or
NeighborList), reads every field
through ``numpy.asarray`` and builds the port's counterpart on ``device``.
``cell_list_from`` and ``neighbor_list_from`` carry the neighbour
structures (a ``CellList``, a ``NeighborList``) across. ``system_from``
carries a JAX ``System`` across, its fixes mapped by class
name onto the port's fixes of the same fields. ``*_to_numpy`` goes the
other way. The module takes numpy and never imports JAX; the tests feed it
JAX output.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import PER_PARTICLE, State
from meso_tpu_torch.core.system import System, SystemParams
from meso_tpu_torch.models.transport import FixRegionT
from meso_tpu_torch.neighbor.cells import CellConfig, CellList
from meso_tpu_torch.neighbor.nlist import NeighborList
from meso_tpu_torch.ops import fixes as fixmod
from meso_tpu_torch.ops.bonded import BondedParams
from meso_tpu_torch.ops.dpd import DPDParams
from meso_tpu_torch.ops.edpd import EDPDParams
from meso_tpu_torch.ops.tdpd import TDPDParams

_DTYPES = {"x": np.float32, "v": np.float32, "f": np.float32,
           "typ": np.int32, "tag": np.int32, "image": np.int32,
           "mask": np.bool_, "mol": np.int32, "T": np.float32,
           "dTdt": np.float32, "C": np.float32, "dCdt": np.float32}


def _get(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _get_opt(src, name):
    if isinstance(src, Mapping):
        return src.get(name)
    return getattr(src, name, None)


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), dtype=dtype)).to(device)


def box_from(src, device=None) -> Box:
    return Box(lo=_tensor(_get(src, "lo"), np.float32, device),
               hi=_tensor(_get(src, "hi"), np.float32, device))


def state_from(src, device=None) -> State:
    """State from per-particle arrays + ``box`` (or ``lo``/``hi``) + step."""
    kw = {}
    for name in PER_PARTICLE:
        a = _get_opt(src, name)
        kw[name] = None if a is None else _tensor(a, _DTYPES[name], device)
    box_src = _get_opt(src, "box")
    return State(box=box_from(src if box_src is None else box_src, device),
                 step=int(np.asarray(_get(src, "step"))), **kw)


def state_to_numpy(state: State) -> dict:
    out = {name: getattr(state, name).cpu().numpy()
           for name in PER_PARTICLE if getattr(state, name) is not None}
    out["lo"] = state.box.lo.cpu().numpy()
    out["hi"] = state.box.hi.cpu().numpy()
    out["step"] = np.int32(state.step)
    return out


def states_from_distributed(src, device=None) -> list[State]:
    """The per-rank States of a JAX distributed state (the output of
    ``meso_tpu.parallel.domain.distribute_state``: every array, the box's
    and the step's included, carries a leading device axis)."""
    box = _get_opt(src, "box")
    box = src if box is None else box
    lo, hi = np.asarray(_get(box, "lo")), np.asarray(_get(box, "hi"))
    step = np.asarray(_get(src, "step"))
    arrays = {name: np.asarray(a) for name in PER_PARTICLE
              if (a := _get_opt(src, name)) is not None}
    return [state_from({**{k: a[r] for k, a in arrays.items()},
                        "lo": lo[r], "hi": hi[r], "step": step[r]}, device)
            for r in range(lo.shape[0])]


def states_to_numpy(states: list[State]) -> dict:
    """Per-rank States as arrays with a leading device axis, as the JAX
    package's distributed state holds them."""
    per = [state_to_numpy(s) for s in states]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def _opt_tensor(src, name, dtype, device):
    a = _get_opt(src, name)
    return None if a is None else _tensor(a, dtype, device)


def dpd_params_from(src, device=None) -> DPDParams:
    return DPDParams(
        a=_tensor(_get(src, "a"), np.float32, device),
        gamma=_tensor(_get(src, "gamma"), np.float32, device),
        sigma=_tensor(_get(src, "sigma"), np.float32, device),
        rc=_tensor(_get(src, "rc"), np.float32, device),
        kt=float(np.asarray(_get(src, "kt"))),
        seed=_seed(src),
        s_exp=float(np.asarray(_get(src, "s_exp"))),
        excl=_opt_tensor(src, "excl", np.int32, device),
        excl_w=_opt_tensor(src, "excl_w", np.float32, device))


def dpd_params_to_numpy(params: DPDParams) -> dict:
    out = {"a": params.a.cpu().numpy(), "gamma": params.gamma.cpu().numpy(),
           "sigma": params.sigma.cpu().numpy(), "rc": params.rc.cpu().numpy(),
           "kt": np.float32(params.kt), "seed": np.uint32(params.seed),
           "s_exp": np.float32(params.s_exp)}
    if params.excl is not None:
        out.update(excl=params.excl.cpu().numpy(),
                   excl_w=params.excl_w.cpu().numpy())
    return out


_BONDED_INT = ("bond_tags", "bond_type", "angle_tags", "angle_type",
               "tri_tags", "tri_mol", "hinge_tags")


def bonded_params_from(src, device=None) -> BondedParams:
    return BondedParams(**{
        f.name: _opt_tensor(src, f.name, np.int32 if f.name in _BONDED_INT
                            else np.float32, device)
        for f in dataclasses.fields(BondedParams)})


def _scalar(src, name) -> float:
    return float(np.asarray(_get(src, name), dtype=np.float32))


def _seed(src) -> int:
    return int(np.asarray(_get(src, "seed")).astype(np.uint32))


def edpd_params_from(src, device=None) -> EDPDParams:
    return EDPDParams(
        **{name: _tensor(_get(src, name), np.float32, device)
           for name in ("a", "gamma", "rc", "kappa")},
        cv=_scalar(src, "cv"), mass=_scalar(src, "mass"), seed=_seed(src))


def edpd_params_to_numpy(params: EDPDParams) -> dict:
    out = {name: getattr(params, name).cpu().numpy()
           for name in ("a", "gamma", "rc", "kappa")}
    out.update(cv=np.float32(params.cv), mass=np.float32(params.mass),
               seed=np.uint32(params.seed))
    return out


_TDPD_TENSORS = ("a", "gamma", "sigma", "rc", "kappa_c", "eps_c")


def tdpd_params_from(src, device=None) -> TDPDParams:
    return TDPDParams(
        **{name: _tensor(_get(src, name), np.float32, device)
           for name in _TDPD_TENSORS},
        rcc=_scalar(src, "rcc"), s1=_scalar(src, "s1"), seed=_seed(src),
        s_exp=_scalar(src, "s_exp"))


def tdpd_params_to_numpy(params: TDPDParams) -> dict:
    out = {name: getattr(params, name).cpu().numpy()
           for name in _TDPD_TENSORS}
    out.update(rcc=np.float32(params.rcc), s1=np.float32(params.s1),
               seed=np.uint32(params.seed), s_exp=np.float32(params.s_exp))
    return out


def pair_params_from(src, device=None):
    """The pair parameters of any model, told apart by their fields:
    ``kappa`` and ``cv`` mean eDPD, ``kappa_c`` tDPD, else classic DPD."""
    if _get_opt(src, "kappa_c") is not None:
        return tdpd_params_from(src, device)
    if _get_opt(src, "kappa") is not None and _get_opt(src, "cv") is not None:
        return edpd_params_from(src, device)
    return dpd_params_from(src, device)


def system_params_from(src, device=None) -> SystemParams:
    bonded = _get_opt(src, "bonded")
    return SystemParams(pair=pair_params_from(_get(src, "pair"), device),
                        mass=_tensor(_get(src, "mass"), np.float32, device),
                        inv_mass=_tensor(_get(src, "inv_mass"), np.float32,
                                         device),
                        bonded=None if bonded is None
                        else bonded_params_from(bonded, device))


_FIXES = {cls.__name__: cls for cls in (
    fixmod.FixBodyForce, fixmod.FixBounceBack, fixmod.FixWallMove,
    fixmod.FixMomentumZero, fixmod.FixSetForce, fixmod.FixSourceC,
    FixRegionT)}


def _plain(value):
    """A fix field as Python numbers: tuples stay tuples, numpy scalars
    become floats or ints."""
    if isinstance(value, (tuple, list)):
        return tuple(_plain(v) for v in value)
    if isinstance(value, np.generic):
        return value.item()
    return value


def fixes_from(fixes) -> tuple:
    """The port's fix of the same class name and fields for each fix."""
    out = []
    for fx in fixes:
        name = type(fx).__name__
        if name not in _FIXES:
            raise NotImplementedError(f"fix {name} is not ported")
        out.append(_FIXES[name](**{
            f.name: _plain(getattr(fx, f.name))
            for f in dataclasses.fields(_FIXES[name])}))
    return tuple(out)


_SYSTEM_FIELDS = ("dt", "lam", "rng_mode", "rng_rounds", "model",
                  "force_path", "s_exp", "z_chunks", "pair_kernel",
                  "wrap_mode", "dd_overlap", "bond_style", "n_tags", "n_mols",
                  "nlist_m", "rc_max")


def system_from(src) -> System:
    """A JAX ``System``: its scalar fields, frozen types, fixes and cell
    configuration."""
    cells = _get_opt(src, "cells")
    return System(**{name: _plain(_get(src, name)) for name in _SYSTEM_FIELDS},
                  frozen_types=tuple(int(t) for t in
                                     _get(src, "frozen_types")),
                  fixes=fixes_from(_get(src, "fixes")),
                  cells=None if cells is None else cell_config_from(cells))


def cell_config_from(src) -> CellConfig:
    return CellConfig(
        ncell=tuple(int(n) for n in _get(src, "ncell")),
        capacity=int(_get(src, "capacity")),
        skin=float(_get(src, "skin")),
        rebuild_every=int(_get(src, "rebuild_every")),
        spill=bool(_get(src, "spill")),
        rebuild=str(_get(src, "rebuild")),
        wrap_at_rebuild=bool(_get(src, "wrap_at_rebuild")))


def cell_list_from(src, device=None) -> CellList:
    return CellList(
        cid=_tensor(_get(src, "cid"), np.int32, device),
        bucket_idx=_tensor(_get(src, "bucket_idx"), np.int32, device),
        bucket_mask=_tensor(_get(src, "bucket_mask"), np.bool_, device),
        overflow=_tensor(_get(src, "overflow"), np.int64, device),
        x_ref=_tensor(_get(src, "x_ref"), np.float32, device))


def neighbor_list_from(src, device=None) -> NeighborList:
    return NeighborList(
        idx=_tensor(_get(src, "idx"), np.int32, device),
        n_neigh=_tensor(_get(src, "n_neigh"), np.int32, device),
        overflow=_tensor(_get(src, "overflow"), np.int64, device))
