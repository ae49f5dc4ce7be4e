"""Kernel events in the traced window, per step."""

LAYER = None


def read(ctx):
    return ctx["kernels"] / ctx["steps"]
