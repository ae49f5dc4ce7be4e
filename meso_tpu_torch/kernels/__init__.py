"""Hand-written Hopper kernels with their plain torch versions (port of
meso_tpu.kernels). Sources live in meso_tpu_torch/csrc/."""
