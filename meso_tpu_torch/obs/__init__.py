"""Observables (port of meso_tpu.obs): the scalar thermo reductions, the
binned profiles, the radial distribution, the mean-squared displacement,
the per-particle virial and pressure profile (``obs.stress``) and the
Mueller-Plathe viscosity."""

from meso_tpu_torch.obs.msd import diffusion_coefficient, msd, unwrapped
from meso_tpu_torch.obs.profiles import (bin_index, field_profile, profile,
                                         temperature_profile,
                                         velocity_profile)
from meso_tpu_torch.obs.rdf import rdf
from meso_tpu_torch.obs.thermo import (kinetic_energy, kinetic_temperature,
                                       potential_energy_dense, pressure,
                                       total_momentum)
from meso_tpu_torch.obs.viscosity import muller_plathe_swap, run_viscosity_mp

__all__ = ["kinetic_temperature", "total_momentum", "pressure",
           "kinetic_energy", "potential_energy_dense", "bin_index",
           "profile", "field_profile", "velocity_profile",
           "temperature_profile", "rdf", "msd", "unwrapped",
           "diffusion_coefficient", "muller_plathe_swap",
           "run_viscosity_mp"]
