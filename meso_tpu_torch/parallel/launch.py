"""Start the ranks of a distributed run as processes on one host, and the
rank side of a slab run; shared by the tests and ``chip_smoke.py``.

``deck_rank`` and ``run_deck_distributed`` run a deck's CLI loop on the
slabs (``python -m meso_tpu_torch deck.toml --dd N``).

``spawn`` starts ``world_size`` processes with the spawn start method (a
process that already runs threads, such as a test process with JAX loaded,
must not fork), joins them into a gloo process group through a
``file://`` rendezvous in ``workdir`` (no TCP port, so concurrent runs do
not collide) and calls ``target(ring, device, *args)`` in each, with
``args`` read from a file that the parent wrote; with ``mesh`` (a shape
and its axis names) the target takes the ranks' ``comm.Mesh`` of that
shape in place of the ring. Every rank runs on the
device the caller names (``"cuda"``: the ranks share the card; ``"cpu"``:
each rank takes one thread). Each rank's return value comes back through
a file. A rank that raises makes ``spawn`` raise
(``torch.multiprocessing``'s ``ProcessRaisedException``); ranks that have
not finished within ``timeout_s`` are terminated and ``spawn`` raises
``TimeoutError``; a collective that waits longer than ``op_timeout_s``
raises in its rank. Nothing here falls back to another device.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
import torch.multiprocessing as mp

from meso_tpu_torch.kernels import _build
from meso_tpu_torch.parallel.comm import Mesh, make_ring


def _child(rank: int, target, world_size: int, workdir: str, device: str,
           op_timeout_s: float, mesh) -> None:
    import torch.distributed as dist
    work = Path(workdir)
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    elif dev.index is not None:
        torch.cuda.set_device(dev)
    args = torch.load(work / "args.pt", weights_only=False)
    ring = make_ring(world_size, rank, f"file://{work / 'rendezvous'}",
                     timeout_s=op_timeout_s)
    try:
        out = target(ring if mesh is None else Mesh(*mesh), device,
                     *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, work / f"rank{rank}.pt")


def spawn(target, world_size: int, workdir, args: tuple = (),
          device: str = "cuda", timeout_s: float = 120.0,
          op_timeout_s: float = 30.0, mesh: tuple | None = None) -> list:
    """Run ``target(ring, device, *args)`` on ``world_size`` ranks, or with
    ``mesh = (shape, names)`` ``target(mesh, device, *args)`` on the
    ``comm.Mesh`` of that shape; returns their return values in rank
    order. ``target`` must be importable by name (a module-level
    function)."""
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    for stale in [work / "rendezvous"] + [work / f"rank{r}.pt"
                                          for r in range(world_size)]:
        stale.unlink(missing_ok=True)
    torch.save(tuple(args), work / "args.pt")
    ctx = mp.start_processes(
        _child, args=(target, world_size, str(work), device, op_timeout_s,
                      mesh),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks did not finish "
                                   f"within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(world_size)]


def on_device(state, device):
    """The state with every tensor on ``device``."""
    from meso_tpu_torch.core.state import PER_PARTICLE
    box = state.box.replace(lo=state.box.lo.to(device),
                            hi=state.box.hi.to(device))
    return state.replace(box=box, **{
        f: getattr(state, f).to(device) for f in PER_PARTICLE
        if getattr(state, f) is not None})


def params_on(params, device):
    """SystemParams with every tensor, the pair and bonded ones included,
    on ``device``."""
    import dataclasses

    def move(obj):
        if obj is None:
            return None
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})

    return params.replace(pair=move(params.pair), bonded=move(params.bonded),
                          mass=params.mass.to(device),
                          inv_mass=params.inv_mass.to(device))


def slab_run(ring, device: str, system, params, states, dcfg,
             nchunks: int = 1, warmup: int = 0, then=None,
             then_args: tuple = ()) -> dict:
    """The rank side of a slab or brick run: this rank's part of
    ``states`` (one CPU state per rank, from ``distribute_state`` or a
    brick distribute function) and the parameters onto ``device``, the
    launch counters set to 0, ``warmup`` chunks of ``run_distributed`` (a
    ``DomainConfig``; ``ring`` a ring) or ``bricks.run_bricks`` (a
    ``Domain2D`` or ``Domain3D``; ``ring`` the mesh), then ``nchunks``
    chunks timed on the host clock around synchronised work, then, where
    given, ``then(ring, system, params, state, dcfg, *then_args)`` (a
    module-level function returning the state and a dict that joins the
    result). Returns the final state on the CPU, the diag of the warm-up
    (None without one) and of the timed chunks (as Python numbers), their
    seconds, and the launch counts of the whole run."""
    run_distributed = domain_runner(dcfg)
    cuda = torch.device(device).type == "cuda"
    state = on_device(states[ring.rank], device)
    params = params_on(params, device)
    _build.reset_launch_counts()
    out = {"warmup_diag": None}
    if warmup:
        state, diag = run_distributed(system, params, state, warmup, ring,
                                      dcfg)
        out["warmup_diag"] = {k: float(v) for k, v in diag.items()}
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, diag = run_distributed(system, params, state, nchunks, ring, dcfg)
    if cuda:
        torch.cuda.synchronize()
    out.update(seconds=time.perf_counter() - t0,
               diag={k: float(v) for k, v in diag.items()})
    if then is not None:
        state, more = then(ring, system, params, state, dcfg, *then_args)
        out.update(more)
    return {**out, "state": on_device(state, "cpu"),
            "launches": _build.LAUNCHES.copy()}


def domain_runner(dcfg):
    """The run function of a decomposition's config: ``run_distributed``
    for 1-D slabs, ``bricks.run_bricks`` for 2-D and 3-D bricks."""
    from meso_tpu_torch.parallel.domain import DomainConfig, run_distributed
    if isinstance(dcfg, DomainConfig):
        return run_distributed
    from meso_tpu_torch.parallel.bricks import run_bricks
    return run_bricks


def slab_runs(ring, device: str, jobs) -> list:
    """Several runs on one start of the processes, each job in turn: a dict
    of ``slab_run``'s keyword arguments, run on the ring, or, where it
    names a ``mesh`` (shape, axis names), on that mesh of the ranks; or a
    (function, args) pair, called as ``function(ring, device, *args)``.
    Every rank runs the same jobs in the same order (a mesh's groups are
    made by all of them)."""
    out = []
    for job in jobs:
        if isinstance(job, tuple):
            fn, args = job
            out.append(fn(ring, device, *args))
            continue
        job = dict(job)
        mesh = job.pop("mesh", None)
        out.append(slab_run(ring if mesh is None else Mesh(*mesh),
                            device, **job))
    return out


def mesh_shifts(ring, device: str, shape: tuple, names: tuple) -> dict:
    """A probe of ``comm.Mesh``: on the mesh of ``shape``, each rank's id
    shifted by +1 and -1 along every axis (``ppermute``), and summed and
    maxed over each axis and over all of them. Returns {axis: (received
    from the rank before, from the rank after, sum, max)} and the
    coords."""
    mesh = Mesh(shape, names)
    me = torch.tensor([mesh.rank], dtype=torch.int64, device=device)
    out = {"coords": dict(mesh.coords)}
    for name in names:
        ring_a = mesh.ring(name)
        got = ring_a.exchange({1: [me], -1: [me]}).wait()
        out[name] = (int(got[1][0]), int(got[-1][0]),
                     int(mesh.all_sum(me, (name,))),
                     int(mesh.all_max(me, (name,))))
    out["all"] = (int(mesh.all_sum(me)), int(mesh.all_max(me)))
    return out


def call(ring, device: str, calls) -> list:
    """For each (fn, per_rank_args) of ``calls``, ``fn(*per_rank_args[rank],
    ring)`` on each rank, its states moved to ``device``: probes of one
    piece of the decomposition (the tests' migration checks)."""
    from meso_tpu_torch.core.state import State
    out = []
    for fn, per_rank_args in calls:
        args = [on_device(a, device) if isinstance(a, State) else a
                for a in per_rank_args[ring.rank]]
        out.append(fn(*args, ring))
    return out


def deck_rank(ring, device: str, system, params, states, dcfg,
              plan: dict) -> dict:
    """The rank side of a deck run under the 1-D decomposition
    (``python -m meso_tpu_torch deck.toml --dd N``): every rank runs the
    CLI's loop (``__main__.run_loop``) over ``run_distributed`` on its
    slab, and after each interval every rank gathers the whole state
    (``collect_state``), so that the loop takes the same decisions on
    every rank; rank 0 alone prints the thermo rows and writes the log,
    dumps, restarts and the profile. Returns the exit code and the timer's
    phases (seconds and calls)."""
    import torch.distributed as dist

    from meso_tpu_torch.__main__ import run_loop
    from meso_tpu_torch.io.thermo import ThermoLogger
    from meso_tpu_torch.parallel.domain import collect_state, run_distributed
    from meso_tpu_torch.utils.timer import PhaseTimer

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    slab = on_device(states[ring.rank], device)
    params = params_on(params, device)
    every = dcfg.rebuild_every

    def runner(sy, pa, st, n):
        nonlocal slab
        slab, diag = run_distributed(sy, pa, slab, max(n // every, 1), ring,
                                     dcfg)
        parts = [None] * ring.size
        dist.all_gather_object(parts, on_device(slab, "cpu"))
        return on_device(collect_state(parts), device), {
            "bucket_overflow": diag["overflow"],
            "bonded_missing": diag["bonded_missing"],
            "worst_skin_ratio": diag["worst_skin_ratio"]}

    lead = ring.rank == 0
    if not lead:
        plan = {**plan, "dump_every": 0, "restart_every": 0, "profile": None}
    logger = ThermoLogger(every=plan["thermo_every"],
                          stream=sys.stdout if lead else None,
                          jsonl_path=plan["log"] if lead else None)
    timer = PhaseTimer(sync=(lambda: torch.cuda.synchronize(dev))
                       if cuda else None)
    code, _ = run_loop(system, params, on_device(collect_state(states),
                                                 device),
                       plan, logger, timer, runner=runner)
    timer.end()
    return {"code": code, "acc": dict(timer.acc),
            "counts": dict(timer.counts)}


def run_deck_distributed(system, params, state, n_ranks: int, plan: dict,
                         device) -> dict:
    """A deck's run on ``n_ranks`` gloo ranks on ``device`` (on the card
    the ranks share it): the spill layout switches to strict slots (the
    decomposition re-buckets each slab), the capacity is raised where the
    slabs need it (``fit_slab_capacity``), and the start is split into
    slabs. Returns rank 0's result (``deck_rank``)."""
    import tempfile

    from meso_tpu_torch.parallel.domain import (build_domain,
                                                distribute_state,
                                                fit_slab_capacity)
    if system.cells.spill:
        system = system.replace(cells=system.cells.replace(spill=False))
    lx = float(state.box.lengths[0])
    system = fit_slab_capacity(system, state, n_ranks, lx)
    dcfg = build_domain(system, n_ranks, lx_global=lx)
    states = distribute_state(state, dcfg, device="cpu")
    with tempfile.TemporaryDirectory(prefix="meso_dd_") as work:
        outs = spawn(deck_rank, n_ranks, work,
                     args=(system, params_on(params, "cpu"), states, dcfg,
                           plan),
                     device=str(torch.device(device)), timeout_s=1e6,
                     op_timeout_s=600.0)
    return outs[0]
