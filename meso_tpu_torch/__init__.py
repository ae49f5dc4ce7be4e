"""meso_tpu_torch — the PyTorch and CUDA port of meso_tpu, for NVIDIA Hopper.

A second package beside ``meso_tpu`` (the JAX reference, which stays as it
is), with the same module layout and names. Plain tensor code is PyTorch;
each Pallas TPU kernel of the ported path is a CUDA kernel written by hand
for sm_90a (``csrc/``), with a plain torch version beside it that the CPU
runs. This package never imports JAX.

Ported so far: the classic-DPD main path — box, state, counter RNG, dense
oracle, cell config, bucket layout and sort rebuild, the classic pair
kernel (K1), the integrator, thermo observables, the step and the chunked
run loop, and ``models.classic.classic_fluid`` — the eDPD/tDPD transport
path (K2, K3), the wall and bonded paths, the fused and banded kernel
selectors (K5-K7), the 1-D domain decomposition over
torch.distributed (``parallel``, with the halo kernels K4 and K6-halo),
the neighbour-list and sweep force paths ("nlist", "bucket") with their
loops, the TPU probes T1-T4 (``probes``), and what starts and steers a
run: the deck loader, ``read_data``, restarts, dumps (with the native
codec in ``native``), thermo logging (``io``), the utils (timer, checked
invariants, force validation, autotuning), the observables ``msd``,
``rdf`` and ``stress``, and the CLI, ``python -m meso_tpu_torch
deck.toml``. See ROADMAP.md for the rest.
"""

__version__ = "0.1.0"

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import State
from meso_tpu_torch.core.system import System
from meso_tpu_torch.ops.dpd import DPDParams

__all__ = ["Box", "State", "System", "DPDParams", "__version__"]
