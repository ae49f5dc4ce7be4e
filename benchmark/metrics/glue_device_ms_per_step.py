"""Device ms a step launched under none of the layers' spans: the
integrator, the thermo reductions and the rest of the step."""

LAYER = None


def read(ctx):
    return 1e3 * ctx["layer_s"].get("glue", 0.0) / ctx["steps"]
