"""Thermo logging, the ``thermo_style custom`` analog (port of
``meso_tpu/io/thermo.py``).

Observables are reduced on the state's device; only the scalars of a row
cross to the host. Rows print as LAMMPS-style columns and/or append to a
JSONL file, with the wall-clock seconds since the previous row.
"""

from __future__ import annotations

import json
import sys
import time

from meso_tpu_torch.core.state import State
from meso_tpu_torch.core.system import System, SystemParams, _per_type
from meso_tpu_torch.obs.thermo import (kinetic_temperature, pressure,
                                       total_momentum)


def thermo_row(system: System, params: SystemParams, state: State,
               virial=None) -> dict:
    """Device-side reductions -> host dict: step, temp, px and, with a
    virial, press."""
    mass = _per_type(params.mass, state.typ)
    row = {
        "step": int(state.step),
        "temp": float(kinetic_temperature(state.v, mass, state.mask)),
        "px": float(total_momentum(state.v, mass, state.mask)[0]),
    }
    if virial is not None:
        row["press"] = float(pressure(state.v, mass, state.mask, virial,
                                      state.box.volume))
    return row


class ThermoLogger:
    """Accumulates thermo rows; prints LAMMPS-style columns and/or JSONL."""

    def __init__(self, every: int = 100, stream=sys.stdout,
                 jsonl_path: str | None = None):
        self.every = every
        self.stream = stream
        self.jsonl_path = jsonl_path
        self.rows: list[dict] = []
        self._t_last = time.perf_counter()
        self._header_done = False

    def log(self, system: System, params: SystemParams, state: State,
            virial=None, extra: dict | None = None) -> dict:
        row = thermo_row(system, params, state, virial)
        now = time.perf_counter()
        row["wall_s"] = round(now - self._t_last, 4)
        self._t_last = now
        if extra:
            row.update(extra)
        self.rows.append(row)
        if self.stream is not None:
            if not self._header_done:
                self.stream.write("  ".join(f"{k:>12}" for k in row) + "\n")
                self._header_done = True
            self.stream.write("  ".join(
                f"{v:12.6g}" if isinstance(v, float) else f"{v:>12}"
                for v in row.values()) + "\n")
            self.stream.flush()
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        return row
