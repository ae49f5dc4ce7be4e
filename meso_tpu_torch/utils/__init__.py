"""Utilities (port of ``meso_tpu.utils``): phase timers, checked
invariants, force-path validation and autotuning."""

from meso_tpu_torch.utils.checks import check_diag
from meso_tpu_torch.utils.timer import PhaseTimer

__all__ = ["PhaseTimer", "check_diag"]
