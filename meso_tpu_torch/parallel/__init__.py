"""Domain decomposition of the port (``meso_tpu.parallel``): ranks are
processes joined by torch.distributed (``parallel/launch.py``), each
running its share of the box on its own device.

* 1-D slabs along x (``domain``): ``run_distributed`` on a ``comm.Ring``;
* 2-D and 3-D bricks (``domain2d``, ``domain3d``, their shared machinery
  in ``bricks``): ``run_distributed_2d`` / ``_3d`` on a ``comm.Mesh`` of
  shape (nx, ny[, nz]);
* replicas (``ensemble``): ``run_ensemble`` on a "dp" ring, and the
  composed DP x SP ``run_distributed_ensemble`` on a ("dp", "x") mesh;
* ``dryrun.dryrun_multichip``: the 3-D bricks, the K4 slabs and the
  membrane suspension on N ranks.
"""

from meso_tpu_torch.parallel.comm import Mesh, Ring, make_ring
from meso_tpu_torch.parallel.domain import (DomainConfig, build_domain,
                                            collect_state, distribute_state,
                                            run_distributed)
from meso_tpu_torch.parallel.domain2d import (Domain2D, build_domain2d,
                                              collect_state_2d,
                                              distribute_state_2d,
                                              make_mesh_2d,
                                              run_distributed_2d)
from meso_tpu_torch.parallel.domain3d import (Domain3D, build_domain3d,
                                              collect_state_3d,
                                              distribute_state_3d,
                                              make_mesh_3d,
                                              run_distributed_3d)
from meso_tpu_torch.parallel.ensemble import (collect_ensemble_spatial,
                                              distribute_ensemble_spatial,
                                              make_ensemble_spatial_mesh,
                                              replicate_state,
                                              run_distributed_ensemble,
                                              run_ensemble)

__all__ = ["DomainConfig", "build_domain", "distribute_state",
           "collect_state", "make_ring", "run_distributed", "Ring", "Mesh",
           "Domain2D", "build_domain2d", "distribute_state_2d",
           "collect_state_2d", "make_mesh_2d", "run_distributed_2d",
           "Domain3D", "build_domain3d", "distribute_state_3d",
           "collect_state_3d", "make_mesh_3d", "run_distributed_3d",
           "replicate_state", "run_ensemble", "make_ensemble_spatial_mesh",
           "distribute_ensemble_spatial", "run_distributed_ensemble",
           "collect_ensemble_spatial"]
