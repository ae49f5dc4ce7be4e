"""The float32 operations a step needs (roofline.step) over what the
card's float32 peak does in the traced window's wall time a step."""

from roofline import rates, step

LAYER = None


def read(ctx):
    ops = step.fp32_ops(ctx["n_valid"], ctx["ordered_pairs"])
    per_step_s = ctx["window_s"] / ctx["steps"]
    return 100.0 * ops / (per_step_s * rates.FP32_OPS_PER_S)
