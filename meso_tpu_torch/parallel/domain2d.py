"""2-D spatial domain decomposition over an ("x", "y") mesh of ranks (port
of ``meso_tpu/parallel/domain2d.py``).

Each rank owns a brick: its slab along x and along y, z whole. Migration
ships along x, then y; the halo exchange extends the channel planes along
x (``xr`` columns a side), then along y of the x-extended planes, so that
corner ghosts ride the second exchange; classic DPD on force_path
"pallas" makes one K4 call a step with ``ext=("x", "y")``, every other
model and path runs the sweep with x and y halo-padded. The machinery,
shared with the 3-D bricks, is ``parallel/bricks.py``; the ranks are
processes (``parallel/launch.py``) that each call ``run_distributed_2d``
on their brick with a ``comm.Mesh`` of shape (nx_dev, ny_dev).
"""

from __future__ import annotations

from dataclasses import dataclass

from meso_tpu_torch.core.state import State
from meso_tpu_torch.core.system import System
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.parallel import bricks
from meso_tpu_torch.parallel.comm import Mesh
from meso_tpu_torch.parallel.domain import (_migrate_axis,  # noqa: F401
                                            collect_state)

AX, AY = "x", "y"


@dataclass(frozen=True)
class Domain2D:
    """Static 2-D decomposition config."""

    nx_dev: int
    ny_dev: int
    cells: CellConfig           # LOCAL grid (ncx_l, ncy_l, nz), capacity K
    lx: float                   # global box lengths
    ly: float
    cap_mig: int
    rebuild_every: int = 5

    axes = (AX, AY)

    @property
    def slab_wx(self) -> float:
        return self.lx / self.nx_dev

    @property
    def slab_wy(self) -> float:
        return self.ly / self.ny_dev

    @property
    def devs(self) -> tuple:
        return (self.nx_dev, self.ny_dev)

    @property
    def spans(self) -> tuple:
        return (self.lx, self.ly)

    @property
    def slab_widths(self) -> tuple:
        return (self.slab_wx, self.slab_wy)


def build_domain2d(system: System, nx_dev: int, ny_dev: int, lx: float,
                   ly: float, cap_mig: int | None = None,
                   rebuild_every: int | None = None) -> Domain2D:
    local = bricks.check_bricks(system, (nx_dev, ny_dev))
    if cap_mig is None:
        ncx_l, ncy_l, ncz = local.ncell
        cap_mig = max(64, (ncy_l * ncz * local.capacity) // 4)
    return Domain2D(nx_dev=nx_dev, ny_dev=ny_dev, cells=local, lx=float(lx),
                    ly=float(ly), cap_mig=cap_mig,
                    rebuild_every=rebuild_every or system.cells.rebuild_every)


def make_mesh_2d(nx_dev: int, ny_dev: int) -> Mesh:
    """The ("x", "y") mesh over the process group this rank has joined."""
    return Mesh((nx_dev, ny_dev), (AX, AY))


def _rebuild_brick(state: State, cfg: CellConfig, ox: float, oy: float,
                   side_x: float, side_y: float):
    """rebuild_buckets with x and y relative to the brick origin (strict
    slots, or the right spill within the brick). Returns (state,
    overflow)."""
    return bricks.rebuild_brick(state, cfg, {AX: ox, AY: oy},
                                {AX: side_x, AY: side_y})


# JAX's names for the pieces of the 2-D step, generic in parallel/bricks.py
_exchange_halos_channels = bricks.exchange_halos
_halo_forces_2d = bricks.brick_forces
_bonded_distributed_2d = bricks.bonded_bricks
_step_local_2d = bricks.step_bricks
# nchunks x (migrate x, migrate y, rebuild, rebuild_every steps) on this
# rank's brick, with the mesh of shape (nx_dev, ny_dev)
run_distributed_2d = bricks.run_bricks
# per-brick states in the mesh's rank order (rank = ix * ny_dev + iy)
distribute_state_2d = bricks.distribute_bricks
collect_state_2d = collect_state


def fit_brick_capacity_2d(system: System, state: State, nx_dev: int,
                          ny_dev: int) -> System:
    """``bricks.fit_brick_capacity`` for a 2-D mesh over ``state``'s box."""
    lx, ly = (float(v) for v in state.box.lengths[:2])
    return bricks.fit_brick_capacity(
        system, state, lambda s: build_domain2d(s, nx_dev, ny_dev, lx, ly))


__all__ = ["Domain2D", "build_domain2d", "make_mesh_2d",
           "run_distributed_2d", "distribute_state_2d", "collect_state_2d",
           "fit_brick_capacity_2d"]
