"""Cell configuration and the bucket-resident layout (port of meso_tpu.neighbor)."""
