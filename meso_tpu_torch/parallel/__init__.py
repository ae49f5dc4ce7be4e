"""Domain decomposition of the port (``meso_tpu.parallel``'s 1-D slabs):
ranks are processes joined by torch.distributed (``comm.Ring``), each
running ``run_distributed`` on its slab. The 2-D and 3-D bricks and the
replica ensemble are not ported yet (ROADMAP Queue 1 item 4).
"""

from meso_tpu_torch.parallel.comm import Ring, make_ring
from meso_tpu_torch.parallel.domain import (DomainConfig, build_domain,
                                            collect_state, distribute_state,
                                            run_distributed)

__all__ = ["DomainConfig", "build_domain", "distribute_state",
           "collect_state", "make_ring", "run_distributed", "Ring"]
