"""Share of the traced window's wall time in run_loop's output phase
(thermo rows and the checks after each interval), from its PhaseTimer."""

LAYER = None


def read(ctx):
    return 100.0 * ctx["phases"].get("output", 0.0) / ctx["wall_s"]
