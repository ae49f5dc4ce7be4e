"""The multi-rank dry run (the port's counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip``).

    python -m meso_tpu_torch.parallel.dryrun [N_RANKS] [--device cpu]

``dryrun_multichip`` starts ``n_devices`` ranks (``launch.spawn``: gloo
processes on one host, on the card unless the caller names the CPU) and
runs three legs on them, as the JAX dry run does:

1. the 3-D bricks (``domain3d``) over the most cubic mesh of the ranks
   (``_factor3``), on the sweep (force_path "bucket");
2. the 1-D slabs over every rank through K4 on spill buckets (force_path
   "pallas");
3. the FENE and membrane suspension (BASELINE config 5) on the first two
   ranks' slabs, bonded ghost rows and the membrane scalars summed over
   the ring.

Each leg's start is built and split here, on the CPU; each checks overflow
0, N conserved with unique tags and a finite state, leg 3 also
bonded_missing 0. Any failed check raises.
"""

from __future__ import annotations

import tempfile

import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import create_random
from meso_tpu_torch.core.system import System, SystemParams, setup
from meso_tpu_torch.ops.dpd import DPDParams


def _factor3(n: int):
    """Most-cubic (nx, ny, nz) with nx*ny*nz == n (nx >= ny >= nz)."""
    best, score = (n, 1, 1), n
    for c in range(1, int(round(n ** (1 / 3))) + 1):
        if n % c:
            continue
        m = n // c
        for b in range(c, int(m ** 0.5) + 1):
            if m % b:
                continue
            a = m // b
            if a - c < score:
                best, score = (a, b, c), a - c
    return best


def _fluid(lengths, rc: float, skin: float, seed: int, init_seed: int,
           spill: bool, force_path: str):
    """A classic fluid at density 3 on the CPU, forces set by the dense
    path: (system, params, state)."""
    box = Box.orthorhombic(*lengths)
    n = int(round(3.0 * lengths[0] * lengths[1] * lengths[2]))
    state = create_random(torch.Generator().manual_seed(init_seed), n, box,
                          kt=1.0)
    params = SystemParams.build(DPDParams.build(a=25.0, gamma=4.5, rc=rc,
                                                kt=1.0, seed=seed))
    system = System.for_fluid(list(lengths), rc=rc, density=3.0, dt=0.01,
                              skin=skin, rng_mode="fast", rebuild_every=3,
                              spill=spill).replace(force_path=force_path)
    return system, params, setup(system.replace(force_path="dense"), params,
                                 state)


def legs(n_devices: int) -> dict:
    """Each leg's (system, params, the per-rank starts, the domain config,
    N): built here on the CPU, distributed by the legs' own functions."""
    from meso_tpu_torch.models.polymer import membrane_suspension
    from meso_tpu_torch.parallel.domain import build_domain, distribute_state
    from meso_tpu_torch.parallel.domain3d import (build_domain3d,
                                                  distribute_state_3d)
    out = {}
    devs = _factor3(n_devices)
    rc, skin = 0.5, 0.1
    lengths = tuple(3 * d * (rc + skin) for d in devs)
    system, params, state = _fluid(lengths, rc, skin, 99, 0, False, "bucket")
    dcfg = build_domain3d(system, *devs, *lengths, rebuild_every=3)
    out["bricks_3d"] = (system, params,
                        distribute_state_3d(state, dcfg, device="cpu"), dcfg,
                        int(state.n_valid()))
    side = 1.2
    lengths = (5 * n_devices * side, 4 * side, 4 * side)
    system, params, state = _fluid(lengths, 1.0, 0.2, 7, 1, True, "pallas")
    if not system.cells.spill:
        raise AssertionError("leg 2 must run the spill layout")
    dcfg = build_domain(system, n_devices, lx_global=lengths[0],
                        rebuild_every=3)
    out["slabs_k4"] = (system, params,
                       distribute_state(state, dcfg, device="cpu"), dcfg,
                       int(state.n_valid()))
    lx = 6 * 1.3125   # 6 cell columns: 2 ranks x 3
    system, params, state, _ = membrane_suspension(
        l=lx, radius=2.5, subdiv=2, force_path="bucket", skin=0.3,
        init_seed=8, device="cpu")
    dcfg = build_domain(system, 2, lx_global=lx, rebuild_every=3)
    out["membrane"] = (system, params,
                       distribute_state(state, dcfg, device="cpu"), dcfg,
                       int(state.n_valid()))
    return out


def dryrun_rank(ring, device: str, legs: dict, nchunks: int) -> dict:
    """The rank side: the 3-D mesh of leg 1 and the two-rank group of leg 3
    made by every rank in the same order, then each leg's ``nchunks``
    chunks on this rank's part (leg 3 on ranks 0 and 1 only). Returns each
    leg's final state on the CPU, its diag and the launch counts."""
    import torch.distributed as dist

    from meso_tpu_torch.kernels import _build
    from meso_tpu_torch.parallel import launch
    from meso_tpu_torch.parallel.comm import Ring
    from meso_tpu_torch.parallel.domain import run_distributed
    from meso_tpu_torch.parallel.domain3d import (make_mesh_3d,
                                                  run_distributed_3d)
    dcfg3 = legs["bricks_3d"][3]
    mesh = make_mesh_3d(*dcfg3.devs)
    group = dist.new_group([0, 1])   # made by every rank
    pair = Ring(group) if ring.rank < 2 else None
    runs = {"bricks_3d": (run_distributed_3d, mesh),
            "slabs_k4": (run_distributed, ring),
            "membrane": (run_distributed, pair)}
    out = {}
    for name, (system, params, states, dcfg, _) in legs.items():
        run, where = runs[name]
        if name == "membrane" and ring.rank >= 2:
            continue
        _build.reset_launch_counts()
        state, diag = run(system, launch.params_on(params, device),
                          launch.on_device(states[where.rank], device),
                          nchunks, where, dcfg)
        out[name] = {"state": launch.on_device(state, "cpu"),
                     "diag": {k: float(v) for k, v in diag.items()},
                     "launches": _build.LAUNCHES.copy()}
    return out


def dryrun_multichip(n_devices: int = 8, device="cuda",
                     nchunks: int = 2) -> dict:
    """Run the three legs on ``n_devices`` ranks on ``device`` (the card
    unless the caller names the CPU; the ranks share one card) and check
    them. Returns each leg's ranks, N and diags; raises on any failed
    check."""
    from meso_tpu_torch.parallel import launch
    from meso_tpu_torch.parallel.domain import collect_state
    if n_devices < 2:
        raise ValueError("the dry run needs at least 2 ranks")
    device = str(torch.device(device))
    if torch.device(device).type == "cuda":
        from meso_tpu_torch.kernels import _build
        _build.build()   # once here: the ranks load it
    built = legs(n_devices)
    with tempfile.TemporaryDirectory(prefix="meso_dryrun_") as work:
        ranks = launch.spawn(dryrun_rank, n_devices, work,
                             args=(built, nchunks), device=device,
                             timeout_s=1200.0, op_timeout_s=300.0)
    report, failed = {}, []
    for name, (system, _, states, _, n) in built.items():
        per = [r[name] for r in ranks if name in r]
        final = collect_state([p["state"] for p in per])
        m = final.mask
        tags = final.tag[m]
        diags = [p["diag"] for p in per]
        checks = {
            "overflow == 0": all(d["overflow"] == 0 for d in diags),
            "N conserved, tags unique": int(m.sum()) == n
            and int(torch.unique(tags).numel()) == n,
            "state finite": bool(torch.isfinite(final.x[m]).all()
                                 and torch.isfinite(final.v[m]).all())}
        if system.bond_style is not None:
            checks["bonded_missing == 0"] = all(
                d["bonded_missing"] == 0 for d in diags)
        launches = {k: sum(p["launches"][k] for p in per)
                    for k in per[0]["launches"]}
        report[name] = {"ranks": len(per), "n_particles": n, "diags": diags,
                        "launches": {k: v for k, v in launches.items() if v}}
        failed += [f"{name}: {k}" for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dryrun_multichip failed: {failed}")
    return report


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="the multi-rank dry run")
    ap.add_argument("n_ranks", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    cli = ap.parse_args()
    print(dryrun_multichip(cli.n_ranks, device=cli.device))
    print("dryrun_multichip OK")
