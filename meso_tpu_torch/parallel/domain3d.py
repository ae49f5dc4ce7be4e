"""3-D spatial domain decomposition over an ("x", "y", "z") mesh of ranks
(port of ``meso_tpu/parallel/domain3d.py``).

The 2-D bricks (``parallel/domain2d.py``) with the third axis decomposed
too: migration ships along x, then y, then z; the halo exchange extends
the planes along x, then y, then z, so that edge and corner ghosts ride
the later exchanges; classic DPD on force_path "pallas" makes one K4 call
a step with ``ext=("x", "y", "z")``, every other model and path runs the
sweep with all three axes halo-padded. The machinery is
``parallel/bricks.py``; each rank calls ``run_distributed_3d`` on its
brick with a ``comm.Mesh`` of shape (nx_dev, ny_dev, nz_dev).
"""

from __future__ import annotations

from dataclasses import dataclass

from meso_tpu_torch.core.state import State
from meso_tpu_torch.core.system import System
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.parallel import bricks
from meso_tpu_torch.parallel.comm import Mesh
from meso_tpu_torch.parallel.domain import collect_state

AX, AY, AZ = "x", "y", "z"


@dataclass(frozen=True)
class Domain3D:
    """Static 3-D decomposition config."""

    nx_dev: int
    ny_dev: int
    nz_dev: int
    cells: CellConfig           # LOCAL grid (ncx_l, ncy_l, ncz_l), capacity K
    lx: float
    ly: float
    lz: float
    cap_mig: int
    rebuild_every: int = 5

    axes = (AX, AY, AZ)

    @property
    def slab_wx(self) -> float:
        return self.lx / self.nx_dev

    @property
    def slab_wy(self) -> float:
        return self.ly / self.ny_dev

    @property
    def slab_wz(self) -> float:
        return self.lz / self.nz_dev

    @property
    def devs(self) -> tuple:
        return (self.nx_dev, self.ny_dev, self.nz_dev)

    @property
    def spans(self) -> tuple:
        return (self.lx, self.ly, self.lz)

    @property
    def slab_widths(self) -> tuple:
        return (self.slab_wx, self.slab_wy, self.slab_wz)


def build_domain3d(system: System, nx_dev: int, ny_dev: int, nz_dev: int,
                   lx: float, ly: float, lz: float,
                   cap_mig: int | None = None,
                   rebuild_every: int | None = None) -> Domain3D:
    local = bricks.check_bricks(system, (nx_dev, ny_dev, nz_dev))
    if cap_mig is None:
        ncx_l, ncy_l, ncz_l = local.ncell
        face = max(ncy_l * ncz_l, ncx_l * ncz_l, ncx_l * ncy_l)
        cap_mig = max(64, (face * local.capacity) // 4)
    return Domain3D(nx_dev=nx_dev, ny_dev=ny_dev, nz_dev=nz_dev, cells=local,
                    lx=float(lx), ly=float(ly), lz=float(lz), cap_mig=cap_mig,
                    rebuild_every=rebuild_every or system.cells.rebuild_every)


def make_mesh_3d(nx_dev: int, ny_dev: int, nz_dev: int) -> Mesh:
    """The ("x", "y", "z") mesh over the process group this rank has
    joined."""
    return Mesh((nx_dev, ny_dev, nz_dev), (AX, AY, AZ))


def _rebuild_brick3d(state: State, cfg: CellConfig, ox: float, oy: float,
                     oz: float, side_x: float, side_y: float,
                     side_z: float):
    """rebuild_buckets with all three axes relative to the brick origin.
    Returns (state, overflow)."""
    return bricks.rebuild_brick(state, cfg, {AX: ox, AY: oy, AZ: oz},
                                {AX: side_x, AY: side_y, AZ: side_z})


# nchunks x (migrate x/y/z, rebuild, rebuild_every steps) on this rank's
# brick, with the mesh of shape (nx_dev, ny_dev, nz_dev)
run_distributed_3d = bricks.run_bricks
# per-brick states in the mesh's rank order
# (rank = (ix * ny_dev + iy) * nz_dev + iz)
distribute_state_3d = bricks.distribute_bricks
collect_state_3d = collect_state


def fit_brick_capacity_3d(system: System, state: State, nx_dev: int,
                          ny_dev: int, nz_dev: int) -> System:
    """``bricks.fit_brick_capacity`` for a 3-D mesh over ``state``'s box."""
    lx, ly, lz = (float(v) for v in state.box.lengths)
    return bricks.fit_brick_capacity(
        system, state,
        lambda s: build_domain3d(s, nx_dev, ny_dev, nz_dev, lx, ly, lz))


__all__ = ["Domain3D", "build_domain3d", "make_mesh_3d",
           "run_distributed_3d", "distribute_state_3d", "collect_state_3d",
           "fit_brick_capacity_3d"]
