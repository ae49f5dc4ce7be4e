"""Device ms a step under the pair layer's spans
(benchmark/layers/pair.json)."""

from benchlib.readers import layer_ms_per_step

LAYER = "pair"


def read(ctx):
    return layer_ms_per_step(ctx, LAYER)
