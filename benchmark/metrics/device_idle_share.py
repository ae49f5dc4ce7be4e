"""Share of the traced window in which no operation ran on the device."""

LAYER = None


def read(ctx):
    return 100.0 * (ctx["window_s"] - ctx["busy_s"]) / ctx["window_s"]
