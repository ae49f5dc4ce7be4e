"""Checked invariants (port of ``meso_tpu/utils/checks.py``): the runners'
real hazards are fixed-capacity overflows, which each runner counts in
its diag dict; ``check_diag`` raises with actionable guidance when any
fired. The diag values may be tensors (on any device) or Python numbers.
"""

from __future__ import annotations

import torch

_HINTS = {
    "cell_overflow": "increase CellConfig.capacity (cells fuller than K)",
    "nlist_overflow": "increase System.nlist_m (neighbor rows fuller than M)",
    "bucket_overflow": "increase CellConfig.capacity (bucket slots exhausted)",
    "overflow": "increase migration cap_mig or bucket capacity",
    "skin_violation": "reduce rebuild cadence or increase skin "
                      "(particles moved > skin/2 between rebuilds)",
}


def _max(value) -> torch.Tensor:
    return torch.max(torch.as_tensor(value))


def check_diag(diag: dict, context: str = "") -> None:
    """Raise RuntimeError if any checked invariant fired."""
    problems = []
    for key, hint in _HINTS.items():
        if key in diag:
            val = int(_max(diag[key]))
            if val > 0:
                problems.append(f"{key}={val}: {hint}")
    if "worst_skin_ratio" in diag:
        r = float(_max(diag["worst_skin_ratio"]))
        if r > 1.0:
            problems.append(
                f"worst_skin_ratio={r:.2f}: particles moved {r:.2f}x the "
                "half-skin between rebuilds — shorten the cadence or widen "
                "the skin")
    if problems:
        where = f" [{context}]" if context else ""
        raise RuntimeError("checked invariants fired" + where + ":\n  "
                           + "\n  ".join(problems))
