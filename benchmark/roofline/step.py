"""The float32 operations one step of the DPD engine needs: the pair term
(``roofline.pair``) and the velocity-Verlet update, the numerator of
``step_mfu``: per particle 18 (the predictor, the drift and the
corrector, 6 each).
"""

from __future__ import annotations

from roofline.pair import OPS_PER_PAIR

OPS_PER_PARTICLE = 18


def fp32_ops(n_valid: int, ordered_pairs: int) -> float:
    return OPS_PER_PAIR[0] * ordered_pairs / 2 + OPS_PER_PARTICLE * n_valid
