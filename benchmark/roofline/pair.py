"""What the DPD pair term needs, whatever kernel or layout computes it.

Bytes, for each valid particle: x, v (float32 x 3 each) and the tag
(int32) read once; f (float32 x 3) written once. Rows, capacity and
padding are not counted, so the count is the same on every layout.

Operations, for each unordered pair inside the cutoff (one evaluation
serves both particles): 33 float32 operations (the Groot-Warren force
after the cutoff test) and 11 integer ones (the symmetric mixer of two
particle words), plus one TEA evaluation of 78 integer instructions per
particle and step (the fast tier's particle word), counted as in the
port's smoke script.
"""

from __future__ import annotations

from roofline.rates import Ops, bytes_bound

X_BYTES = V_BYTES = F_BYTES = 12
TAG_BYTES = 4
BYTES_PER_PARTICLE = X_BYTES + V_BYTES + TAG_BYTES + F_BYTES
OPS_PER_PAIR = Ops(33, 11)
OPS_PER_PARTICLE = Ops(0, 78)


def bound(n_valid: int, ordered_pairs: int) -> tuple:
    """(least seconds of one evaluation, what bounds it, bytes)."""
    nbytes = n_valid * BYTES_PER_PARTICLE
    ops = OPS_PER_PAIR * (ordered_pairs / 2) + OPS_PER_PARTICLE * n_valid
    seconds, by = bytes_bound(nbytes, ops)
    return seconds, by, nbytes
