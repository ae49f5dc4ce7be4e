"""Checkpoint and restart: binary snapshots of the whole State (port of
``meso_tpu/io/restart.py``, the ``write_restart``/``read_restart``
analog).

The pair RNG is a pure function of (tags, step, seed), so a snapshot needs
no RNG state and a resumed run is bitwise the run without a stop.

Format: one ``.npz`` with every field that is not None, the step, the box
and a JSON header (version, fields present), member for member the JAX
package's: the same keys in the same order, the same dtypes (the step as a
0-d int32, as JAX holds it) and the same header bytes, so that either
package reads the other's files. Host side only, never in the step loop.
The JAX package's Orbax backend is a JAX library and has no counterpart
here.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import PER_PARTICLE, State

_VERSION = 1


def save_restart(path: str, state: State) -> None:
    arrays = {}
    present = []
    for name in PER_PARTICLE:
        val = getattr(state, name)
        if val is not None:
            arrays[name] = val.cpu().numpy()
            present.append(name)
    arrays["step"] = np.asarray(np.int32(state.step))
    arrays["box_lo"] = state.box.lo.cpu().numpy()
    arrays["box_hi"] = state.box.hi.cpu().numpy()
    header = {"version": _VERSION, "fields": present}
    arrays["_header"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_restart(path: str, device="cuda") -> State:
    """The State of a restart file, on ``device`` (the card unless the
    caller names another)."""
    device = torch.device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device)

    with np.load(path) as z:
        header = json.loads(bytes(z["_header"].tobytes()).decode())
        if header["version"] != _VERSION:
            raise ValueError(f"restart version {header['version']} "
                             "unsupported")
        kw = {name: tensor(z[name]) for name in header["fields"]}
        for name in PER_PARTICLE:
            kw.setdefault(name, None)
        box = Box(lo=tensor(z["box_lo"]), hi=tensor(z["box_hi"]))
        return State(box=box, step=int(z["step"]), **kw)
