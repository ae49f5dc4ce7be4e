"""System builders for the validation configs (port of meso_tpu.models)."""

from meso_tpu_torch.models.classic import classic_fluid
from meso_tpu_torch.models.transport import (FixRegionT, edpd_slab,
                                             tdpd_diffusion)

__all__ = ["classic_fluid", "edpd_slab", "tdpd_diffusion", "FixRegionT"]
