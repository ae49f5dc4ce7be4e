"""The bonded term's least time (roofline.bonds: the bytes the bonded
beads and their bonds need) over the device time a step under the bonds
layer's spans. Every valid particle of the cells that report it is a bead
of a linear chain whose length the configuration's builder arguments give
(``chain_len``): n_valid beads, n_valid (chain_len - 1) / chain_len bonds."""

import json
from pathlib import Path

from benchlib.readers import layer_ms_per_step
from roofline import bonds

LAYER = "bonds"
CONFIG = Path(__file__).resolve().parent.parent / "configs" / \
    "diblock_melt_l70.json"


def chain_len() -> int:
    deck = json.loads(CONFIG.read_text())["deck"]
    return int(deck["model"]["args"]["chain_len"])


def read(ctx):
    ms = layer_ms_per_step(ctx, LAYER)
    if not ms:
        return None
    n = chain_len()
    beads = ctx["n_valid"]
    seconds, _, _ = bonds.bound(beads, beads // n * (n - 1))
    return 100.0 * 1e3 * seconds / ms
