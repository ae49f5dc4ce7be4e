"""Device ms a step under the bonds layer's spans
(benchmark/layers/bonds.json)."""

from benchlib.readers import layer_ms_per_step

LAYER = "bonds"


def read(ctx):
    return layer_ms_per_step(ctx, LAYER)
