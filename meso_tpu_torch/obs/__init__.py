"""Observables (port of meso_tpu.obs): the scalar thermo reductions so far."""

from meso_tpu_torch.obs.thermo import (kinetic_energy, kinetic_temperature,
                                       pressure, total_momentum)

__all__ = ["kinetic_temperature", "total_momentum", "pressure",
           "kinetic_energy"]
