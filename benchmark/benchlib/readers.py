"""Helpers shared by the per-layer metric readers (benchmark/metrics/)."""

from __future__ import annotations


def layer_ms_per_step(ctx: dict, layer: str):
    """Device ms a step under ``layer``'s spans; None where none opened."""
    if not ctx["opened"].get(layer):
        return None
    return 1e3 * ctx["layer_s"].get(layer, 0.0) / ctx["steps"]
