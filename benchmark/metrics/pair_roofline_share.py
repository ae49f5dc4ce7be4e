"""The pair term's least time (roofline.pair: the bytes the physics needs
per valid particle, or its operations, whichever bounds it) over the
device time a step under the pair layer's spans."""

from benchlib.readers import layer_ms_per_step
from roofline import pair

LAYER = "pair"


def read(ctx):
    ms = layer_ms_per_step(ctx, LAYER)
    if not ms:
        return None
    seconds, _, _ = pair.bound(ctx["n_valid"], ctx["ordered_pairs"])
    return 100.0 * 1e3 * seconds / ms
