"""Carry states and parameters across from the JAX package, and back.

Each ``*_from`` function takes a mapping of arrays, or an object whose
attributes are arrays (a ``meso_tpu`` State, Box, DPDParams, EDPDParams,
TDPDParams, SystemParams or CellConfig), reads every field through ``numpy.asarray`` and builds the
port's counterpart on ``device``. ``*_to_numpy`` goes the other way. The
module takes numpy and never imports JAX; the tests feed it JAX output.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import PER_PARTICLE, State
from meso_tpu_torch.core.system import SystemParams
from meso_tpu_torch.neighbor.cells import CellConfig
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


def dpd_params_from(src, device=None) -> DPDParams:
    if _get(src, "excl") is not None:
        raise NotImplementedError(
            "special-bonds exclusions are not ported yet (ROADMAP Queue 1 "
            "item 10)")
    return DPDParams(
        a=_tensor(_get(src, "a"), np.float32, device),
        gamma=_tensor(_get(src, "gamma"), np.float32, device),
        sigma=_tensor(_get(src, "sigma"), np.float32, device),
        rc=_tensor(_get(src, "rc"), np.float32, device),
        kt=float(np.asarray(_get(src, "kt"))),
        seed=_seed(src),
        s_exp=float(np.asarray(_get(src, "s_exp"))))


def dpd_params_to_numpy(params: DPDParams) -> dict:
    return {"a": params.a.cpu().numpy(), "gamma": params.gamma.cpu().numpy(),
            "sigma": params.sigma.cpu().numpy(), "rc": params.rc.cpu().numpy(),
            "kt": np.float32(params.kt), "seed": np.uint32(params.seed),
            "s_exp": np.float32(params.s_exp)}


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
    if _get(src, "bonded") is not None:
        raise NotImplementedError(
            "bonded parameters are not ported yet (ROADMAP Queue 1 item 10)")
    return SystemParams(pair=pair_params_from(_get(src, "pair"), device),
                        mass=_tensor(_get(src, "mass"), np.float32, device),
                        inv_mass=_tensor(_get(src, "inv_mass"), np.float32,
                                         device))


def cell_config_from(src) -> CellConfig:
    return CellConfig(
        ncell=tuple(int(n) for n in _get(src, "ncell")),
        capacity=int(_get(src, "capacity")),
        skin=float(_get(src, "skin")),
        rebuild_every=int(_get(src, "rebuild_every")),
        spill=bool(_get(src, "spill")),
        rebuild=str(_get(src, "rebuild")),
        wrap_at_rebuild=bool(_get(src, "wrap_at_rebuild")))
