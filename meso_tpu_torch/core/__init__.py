"""Core state, box, RNG, integration and the step (port of meso_tpu.core)."""
