"""Device ms a step under the rebuild layer's spans
(benchmark/layers/rebuild.json)."""

from benchlib.readers import layer_ms_per_step

LAYER = "rebuild"


def read(ctx):
    return layer_ms_per_step(ctx, LAYER)
