"""Neighbor-list sizing (port of ``meso_tpu/neighbor/nlist.py``).

Only ``neighbor_capacity`` is ported, because ``System.for_fluid`` sizes
``nlist_m`` with it. The neighbor-list force path itself is ROADMAP Queue 1
item 13."""

from __future__ import annotations

import numpy as np


def neighbor_capacity(density: float, rc: float, skin: float) -> int:
    """Static M from mean full-list occupancy with Poisson headroom."""
    mean = density * 4.0 / 3.0 * np.pi * (rc + skin) ** 3
    m = int(np.ceil(mean + 6.0 * np.sqrt(mean) + 4.0))
    return ((m + 7) // 8) * 8
