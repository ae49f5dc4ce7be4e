"""Force operators (port of meso_tpu.ops): classic DPD so far."""
