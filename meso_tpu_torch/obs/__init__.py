"""Observables (port of meso_tpu.obs): the scalar thermo reductions, the
binned profiles and the Mueller-Plathe viscosity."""

from meso_tpu_torch.obs.profiles import (bin_index, field_profile, profile,
                                         temperature_profile,
                                         velocity_profile)
from meso_tpu_torch.obs.thermo import (kinetic_energy, kinetic_temperature,
                                       potential_energy_dense, pressure,
                                       total_momentum)

__all__ = ["kinetic_temperature", "total_momentum", "pressure",
           "kinetic_energy", "potential_energy_dense", "bin_index",
           "profile", "field_profile", "velocity_profile",
           "temperature_profile"]
