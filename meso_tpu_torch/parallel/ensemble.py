"""Ensemble (replica) parallelism, the LAMMPS multi-universe analog (port
of ``meso_tpu/parallel/ensemble.py``).

Where the JAX package stacks replicas on a leading axis sharded over a
("dp",) mesh, here each replica is a rank (a process of
``parallel/launch.py``) that advances its own state with the single-card
chunk (``rebuild_buckets``, then ``rebuild_every`` calls of ``make_step``:
K1 on the card), and the observables sum over the "dp" ring. With
``reseed`` each replica's tags move into a range of their own, so the
counter-based RNG draws each replica its own noise. The composed DP x SP
form runs each replica's 1-D slab decomposition on the "x" axis of a
("dp", "x") mesh; replicas never communicate there but to sum the
counters.
"""

from __future__ import annotations

import time

import torch

from meso_tpu_torch.core.state import State
from meso_tpu_torch.core.system import System, SystemParams, run_bucket_fixed
from meso_tpu_torch.parallel.comm import Mesh, Ring
from meso_tpu_torch.parallel.domain import (DomainConfig, collect_state,
                                            distribute_state,
                                            run_distributed)


def replicate_state(state: State, n_replicas: int,
                    reseed: bool = True) -> list[State]:
    """``n_replicas`` copies of ``state``, one per rank. With ``reseed``,
    replica r's valid rows take tag + r * max(tag) and its masked rows tag
    0, as the JAX package re-signs them (the counter-based RNG then
    decorrelates every trajectory)."""
    if not reseed:
        return [state] * n_replicas
    n_tags = int(torch.max(state.tag))
    zero = torch.zeros((), dtype=state.tag.dtype, device=state.device)
    return [state.replace(tag=torch.where(state.mask, state.tag + r * n_tags,
                                          zero))
            for r in range(n_replicas)]


def run_ensemble(system: System, params: SystemParams, state: State,
                 nsteps: int, ring: Ring):
    """Advance this rank's replica ``nsteps`` steps (max(nsteps //
    rebuild_every, 1) chunks of the single-card bucket loop,
    ``run_bucket_fixed``). ``state`` is bucket-resident (from ``setup``).
    Returns (state, the kinetic energy averaged over the replicas of the
    "dp" ``ring``, this replica's diag: the largest "bucket_overflow" and
    "worst_skin_ratio")."""
    every = system.cells.rebuild_every
    state, diag = run_bucket_fixed(system, params, state,
                                   max(nsteps // every, 1), every)
    zero = torch.zeros((), dtype=state.v.dtype, device=state.device)
    ke = 0.5 * torch.sum(torch.where(state.mask,
                                     torch.sum(state.v ** 2, dim=-1), zero))
    return state, ring.all_sum(ke) / ring.size, diag


def ensemble_rank(ring: Ring, device: str, system: System,
                  params: SystemParams, states: list[State],
                  nsteps: int) -> dict:
    """The rank side of ``run_ensemble``: replica ``ring.rank`` of
    ``states`` (from ``replicate_state``) on ``device``, the launch
    counters set to 0, the run timed on the host clock around synchronised
    work. Returns the final state on the CPU, the mean kinetic energy, the
    diag, the seconds and the launch counts."""
    from meso_tpu_torch.parallel import launch
    cuda = torch.device(device).type == "cuda"
    state = launch.on_device(states[ring.rank], device)
    params = launch.params_on(params, device)
    launch.reset_launches()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, ke, diag = run_ensemble(system, params, state, nsteps, ring)
    if cuda:
        torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "ke_mean": float(ke),
            "diag": {k: float(v) for k, v in diag.items()},
            "state": launch.on_device(state, "cpu"),
            "launches": launch.counted_launches()}


# ---------------------------------------------------------------------------
# composed DP x SP: replicas on the "dp" axis of a ("dp", "x") mesh, each
# decomposed into slabs along its "x" axis
# ---------------------------------------------------------------------------

def make_ensemble_spatial_mesh(n_replicas: int, n_dev: int) -> Mesh:
    """The ("dp", "x") mesh over the process group this rank has joined."""
    return Mesh((n_replicas, n_dev), ("dp", "x"))


def distribute_ensemble_spatial(state: State, n_replicas: int,
                                dcfg: DomainConfig, reseed: bool = True,
                                device="cuda") -> list[list[State]]:
    """Replicate (tags reseeded into disjoint ranges), then slab-distribute
    each replica: ``[replica][slab]`` states on ``device``."""
    return [distribute_state(rep, dcfg, device=device)
            for rep in replicate_state(state, n_replicas, reseed)]


def run_distributed_ensemble(system: System, params: SystemParams,
                             state: State, nchunks: int, mesh: Mesh,
                             dcfg: DomainConfig):
    """Advance this rank's slab of its replica with the 1-D machinery
    (``run_distributed`` on the mesh's "x" ring, reused verbatim). Returns
    (state, diag): the overflow and bonded_missing counts summed over the
    whole mesh, the worst skin ratio over it."""
    state, diag = run_distributed(system, params, state, nchunks,
                                  mesh.ring("x"), dcfg)
    dp = mesh.ring("dp")
    counts = dp.all_sum(torch.stack([diag["overflow"],
                                     diag["bonded_missing"]]))
    return state, {"overflow": counts[0], "bonded_missing": counts[1],
                   "worst_skin_ratio": dp.all_max(diag["worst_skin_ratio"])}


def ensemble_spatial_rank(ring: Ring, device: str, system: System,
                          params: SystemParams, states: list[list[State]],
                          dcfg: DomainConfig, nchunks: int) -> dict:
    """The rank side of ``run_distributed_ensemble``: the ("dp", "x") mesh
    of ``states``' shape over the ranks of ``ring``, then slab
    ``coords["x"]`` of replica ``coords["dp"]`` on ``device``. Returns
    the final slab on the CPU, the diag, the seconds and the launch
    counts."""
    from meso_tpu_torch.parallel import launch
    mesh = make_ensemble_spatial_mesh(len(states), len(states[0]))
    cuda = torch.device(device).type == "cuda"
    state = launch.on_device(states[mesh.coords["dp"]][mesh.coords["x"]],
                             device)
    params = launch.params_on(params, device)
    launch.reset_launches()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, diag = run_distributed_ensemble(system, params, state, nchunks,
                                           mesh, dcfg)
    if cuda:
        torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0,
            "diag": {k: float(v) for k, v in diag.items()},
            "state": launch.on_device(state, "cpu"),
            "launches": launch.counted_launches()}


def collect_ensemble_spatial(states: list[list[State]]) -> list[State]:
    """Merge each replica's slabs into one global state per replica."""
    return [collect_state(per) for per in states]
