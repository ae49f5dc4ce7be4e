"""What the bonded term of a bead-spring system needs, whatever kernel or
layout computes it.

Bytes: each bonded bead's x (float32 x 3) and tag (int32) read once, its
f (float32 x 3) read and written once (the bonded force is added to the
pair force); each bond's two tags (int32) read once. Rows, capacity and
padding are not counted. Operations: a spring's few dozen float32
operations a bond never bound it (about 1e-7 s at 1,029,000 beads).
"""

from __future__ import annotations

from roofline.rates import Ops, bytes_bound

X_BYTES = F_BYTES = 12
TAG_BYTES = 4
BYTES_PER_BEAD = X_BYTES + TAG_BYTES + 2 * F_BYTES
BYTES_PER_BOND = 2 * TAG_BYTES


def bound(n_beads: int, n_bonds: int) -> tuple:
    """(least seconds of one evaluation, what bounds it, bytes)."""
    nbytes = n_beads * BYTES_PER_BEAD + n_bonds * BYTES_PER_BOND
    seconds, by = bytes_bound(nbytes, Ops())
    return seconds, by, nbytes
