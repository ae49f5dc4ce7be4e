"""Trajectory output, the ``dump atom/xyz/custom`` analogs (port of
``meso_tpu/io/dump.py``).

Text formats that common MD tools read (VMD, OVITO): the classic ``.xyz``
and the LAMMPS ``.lammpstrj`` custom dump, plus a compact binary frame.
Rows are written in tag order, so frames compare across the rebuilds'
reorderings. The ``.lammpstrj`` and binary writers are the native codec
(``meso_tpu_torch/native``), byte for byte the JAX package's; a failed
build of it raises. Host side only.
"""

from __future__ import annotations

import numpy as np

from meso_tpu_torch.core.state import State

_ELEMENTS = ["A", "B", "C", "D", "E", "F", "G", "H"]


def _host(state: State):
    """(tag, typ, x, v, mask) as numpy arrays on the host."""
    return (state.tag.cpu().numpy(), state.typ.cpu().numpy(),
            state.x.cpu().numpy(), state.v.cpu().numpy(),
            state.mask.cpu().numpy())


def write_xyz(path: str, state: State, append: bool = True) -> None:
    tag, typ, x, _, mask = _host(state)
    tag = tag[mask]
    order = np.argsort(tag)
    typ, x = typ[mask][order], x[mask][order]
    with open(path, "a" if append else "w") as fh:
        fh.write(f"{len(tag)}\nstep {int(state.step)}\n")
        for t, p in zip(typ, x):
            el = _ELEMENTS[int(t) % len(_ELEMENTS)]
            fh.write(f"{el} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def _frame_args(path, state, append):
    from meso_tpu_torch import native
    tag, typ, x, v, mask = _host(state)
    lo = tuple(float(v) for v in state.box.lo.cpu().numpy())
    hi = tuple(float(v) for v in state.box.hi.cpu().numpy())
    return native.load(), (
        path, bool(append), int(state.step), lo, hi,
        np.ascontiguousarray(tag, np.int32),
        np.ascontiguousarray(typ, np.int32),
        np.ascontiguousarray(x, np.float32),
        np.ascontiguousarray(v, np.float32),
        np.ascontiguousarray(mask, np.uint8))


def write_lammpstrj(path: str, state: State, append: bool = True) -> int:
    """One tag-sorted LAMMPS custom frame (id type x y z vx vy vz); returns
    the number of atoms written."""
    mod, args = _frame_args(path, state, append)
    return mod.write_lammpstrj(*args)


def write_frame_bin(path: str, state: State, append: bool = True) -> int:
    """One compact binary frame (header, then tag, type, x, v in tag
    order); returns the number of atoms written."""
    mod, args = _frame_args(path, state, append)
    return mod.write_frame_bin(*args)


def read_frames_bin(path: str) -> list[dict]:
    """Every binary frame of a file, as dicts of numpy arrays."""
    from meso_tpu_torch import native
    out = []
    for rec in native.load().read_frames_bin(path):
        n = rec["n"]
        out.append({
            "step": rec["step"],
            "box_lo": np.asarray(rec["box_lo"]),
            "box_hi": np.asarray(rec["box_hi"]),
            "tag": np.frombuffer(rec["tag"], np.int32),
            "typ": np.frombuffer(rec["typ"], np.int32),
            "x": np.frombuffer(rec["x"], np.float32).reshape(n, 3),
            "v": np.frombuffer(rec["v"], np.float32).reshape(n, 3),
        })
    return out
