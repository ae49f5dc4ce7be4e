"""System builders for the validation configs (port of meso_tpu.models)."""

from meso_tpu_torch.models.classic import classic_fluid

__all__ = ["classic_fluid"]
