"""The benchmark harness of meso_tpu_torch (see benchmark/run.py)."""
