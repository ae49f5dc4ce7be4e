"""I/O (port of ``meso_tpu.io``): declarative decks, thermo logging,
trajectory dumps, restart files and the ``read_data`` analog. The JAX
package's Orbax restart backend is a JAX library and is not ported."""

from meso_tpu_torch.io.deck import build_from_deck, load_deck
from meso_tpu_torch.io.dump import (read_frames_bin, write_frame_bin,
                                    write_lammpstrj, write_xyz)
from meso_tpu_torch.io.restart import load_restart, save_restart
from meso_tpu_torch.io.thermo import ThermoLogger

__all__ = ["load_deck", "build_from_deck", "save_restart", "load_restart",
           "ThermoLogger", "write_xyz", "write_lammpstrj",
           "write_frame_bin", "read_frames_bin"]
