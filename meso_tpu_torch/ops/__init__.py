"""Force operators (port of meso_tpu.ops): classic DPD, eDPD and tDPD
pair math with their dense oracles, and the tDPD source fix."""
