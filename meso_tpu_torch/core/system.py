"""System definition and the timestep (port of ``meso_tpu/core/system.py``).

A step is one function of (params, state), in the hook order of the JAX
package: initial_integrate -> post_integrate fixes -> forces -> post_force
fixes -> final_integrate -> end_of_step fixes. Where JAX runs steps under
``jit`` and ``lax.scan``, the port runs them in a Python loop; every tensor
stays on the device and nothing synchronises inside the loop.

Force paths: "pallas" (``pair_kernel`` "v3": the Hopper kernels K1, K2,
K3; "v2": the fused-lane selector K5), "pallas_banded" (the banded
selectors K6 and K7, strict buckets only), "bucket" (the 27-offset sweep,
``ops/sweep.py``, strict buckets only), "nlist" (classic DPD over padded
neighbour lists rebuilt by ``rebuild``) and "dense" (the O(N^2) oracles),
for the models "dpd", "edpd" and "tdpd" ("nlist" for "dpd" only, as in the
JAX package); the bond styles "fene", "harmonic" and "wlc_pow" with the
membrane terms (``ops/bonded.py``); frozen types and the fixes of
``ops/fixes.py``. Loops: ``run_chunk`` (no rebuilds), ``run`` (a rebuild of
cells and lists every ``rebuild_every`` steps), ``run_adaptive`` (a rebuild
when some particle moved more than skin/2), and on bucket rows
``run_bucket_fixed``, ``run_bucket_chunked`` and ``run_bucket``. Only
``run_adaptive`` and ``run_bucket`` read the card on the host inside the
loop: one scalar a step, to decide on a rebuild.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from meso_tpu_torch.core.integrate import final_integrate, initial_integrate
from meso_tpu_torch.core.state import State
from meso_tpu_torch.neighbor.cells import (CellConfig, build_cells,
                                           max_displacement_sq)
from meso_tpu_torch.neighbor.nlist import build_nlist
from meso_tpu_torch.ops.dpd import DPDParams, dense_forces, f32, nlist_forces

_BUCKET_PATHS = ("bucket", "pallas", "pallas_banded")
_FORCE_PATHS = ("dense", "nlist") + _BUCKET_PATHS
_MODELS = ("dpd", "edpd", "tdpd")


@dataclass(frozen=True)
class SystemParams:
    """Pair coefficient tables + per-type masses (+ bonded topology)."""

    pair: DPDParams
    mass: torch.Tensor       # (T,) per-type mass
    inv_mass: torch.Tensor   # (T,) 1/mass
    bonded: Any = None       # ops.bonded.BondedParams or None

    @staticmethod
    def build(pair: DPDParams, mass=1.0) -> "SystemParams":
        n_types = pair.a.shape[0]
        m = torch.as_tensor(mass, dtype=torch.float32, device=pair.a.device)
        if m.ndim == 0:
            m = torch.full((n_types,), float(m), dtype=torch.float32,
                           device=pair.a.device)
        return SystemParams(pair=pair, mass=m, inv_mass=1.0 / m)

    def replace(self, **kw) -> "SystemParams":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class System:
    """Static simulation configuration, with the JAX package's fields.

    ``pair_kernel`` picks the kernel of force_path "pallas": "v3" and
    "v3_dynroll" (a TPU lowering choice) the Hopper kernels K1-K3, any
    other value the fused selector K5, as the JAX package routes it.
    ``z_chunks`` is a TPU lowering knob and is ignored. ``dd_overlap``
    selects the border/inner split of the 1-D domain-decomposed step
    (``parallel/domain.py``): the interior force launch is queued on the
    card before the host waits on the halo exchange."""

    dt: float = 0.01
    lam: float = 0.5
    rng_mode: str = "tea"
    rng_rounds: int = 8
    model: str = "dpd"
    force_path: str = "dense"
    s_exp: float = 1.0
    z_chunks: int = 0
    pair_kernel: str = "v3"
    wrap_mode: str = "step"
    dd_overlap: bool = True
    bond_style: str | None = None
    n_tags: int = 0
    n_mols: int = 0
    frozen_types: Tuple[int, ...] = ()
    fixes: Tuple[Any, ...] = ()
    cells: CellConfig | None = None
    nlist_m: int = 0
    rc_max: float = 1.0

    def replace(self, **kw) -> "System":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def for_fluid(box_lengths, rc: float, density: float, dt: float = 0.01,
                  skin: float = 0.3, rebuild_every: int = 10,
                  spill: bool = False, rebuild: str = "gather",
                  capacity: int | None = None, **kw) -> "System":
        """Convenience constructor sizing cells and list capacity from
        density."""
        from meso_tpu_torch.neighbor.nlist import neighbor_capacity
        cfg = CellConfig.for_box(
            box_lengths, rc, density, skin=skin,
            rebuild_every=rebuild_every, spill=spill, rebuild=rebuild,
            capacity=capacity,
            wrap_at_rebuild=kw.get("wrap_mode", "step") == "rebuild")
        m = neighbor_capacity(density, rc, skin)
        return System(dt=dt, force_path="nlist", cells=cfg, nlist_m=m,
                      rc_max=rc, **kw)


def _move_mask(system: System, typ, mask):
    mm = mask
    for t in system.frozen_types:
        mm = mm & (typ != t)
    return mm


def _per_type(table: torch.Tensor, typ: torch.Tensor) -> torch.Tensor:
    """Per-particle value from a (T,) per-type table; a single-type table
    stays (1,) and broadcasts."""
    if table.shape[0] == 1:
        return table[:1]
    return table[typ.long()]


def _kernel_fn(system: System):
    """The bucket entry point of this model and selector: pallas with
    pair_kernel "v3*" (K1-K3), pallas with any other pair_kernel (the
    fused selector K5, as the JAX package routes it), pallas_banded (K6,
    K7) or the sweep of force_path "bucket"."""
    from meso_tpu_torch.kernels import (pair_dpd, pair_dpd_fused,
                                        pair_dpd_v3, pair_multiphysics)
    if system.force_path == "bucket":
        from meso_tpu_torch.ops import bucket_dpd, edpd, tdpd
        return {"dpd": bucket_dpd.bucket_forces_xla,
                "edpd": edpd.bucket_forces_edpd,
                "tdpd": tdpd.bucket_forces_tdpd}[system.model]
    if system.force_path == "pallas_banded":
        return {"dpd": pair_dpd.bucket_forces_pallas,
                "edpd": pair_multiphysics.bucket_forces_pallas_edpd,
                "tdpd": pair_multiphysics.bucket_forces_pallas_tdpd
                }[system.model]
    if system.pair_kernel.startswith("v3"):
        return {"dpd": pair_dpd_v3.bucket_forces_pallas_v3,
                "edpd": pair_dpd_v3.bucket_forces_pallas_v3_edpd,
                "tdpd": pair_dpd_v3.bucket_forces_pallas_v3_tdpd
                }[system.model]
    return {"dpd": pair_dpd_fused.bucket_forces_pallas_fused,
            "edpd": pair_dpd_fused.bucket_forces_pallas_edpd_fused,
            "tdpd": pair_dpd_fused.bucket_forces_pallas_tdpd_fused
            }[system.model]


def compute_forces(system: System, params: SystemParams, state: State,
                   x, v, step: int, nlist_idx=None, t=None, c=None,
                   need_virial: bool = True):
    """Dispatch to the configured model and force path. Returns (f, aux);
    aux carries 'virial' and, per model, 'dTdt' / 'dCdt'. need_virial only
    reaches the classic v3 kernel; the others always sum it."""
    if system.model not in _MODELS:
        raise ValueError(f"unknown model {system.model!r}")
    if system.force_path not in _FORCE_PATHS:
        raise ValueError(f"unknown force_path {system.force_path!r}")
    if system.force_path == "nlist" and system.model != "dpd":
        raise ValueError(f"{system.model} does not support 'nlist'")
    args = (x, v, state.typ, state.tag, state.mask, state.box, step,
            params.pair, system.dt)
    kw = dict(rng_mode=system.rng_mode, rng_rounds=system.rng_rounds)
    dense = system.force_path == "dense"
    if system.force_path == "pallas":
        kw["z_chunks"] = system.z_chunks
    if system.model == "dpd":
        if dense:
            f, virial, _ = dense_forces(*args, **kw)
            return f, {"virial": virial}
        if system.force_path == "nlist":
            f, virial = nlist_forces(*args, nlist_idx, **kw)
            return f, {"virial": virial}
        if system.force_path == "pallas":
            kw["s_exp"] = system.s_exp
            if system.pair_kernel.startswith("v3"):
                kw["need_virial"] = need_virial
        f, virial = _kernel_fn(system)(*args, system.cells, **kw)
        return f, {"virial": virial}
    from meso_tpu_torch.ops import edpd, tdpd
    if system.model == "edpd":
        field, name = t, "dTdt"
        fn = edpd.dense_forces_edpd if dense else _kernel_fn(system)
    else:
        field, name = c, "dCdt"
        fn = tdpd.dense_forces_tdpd if dense else _kernel_fn(system)
    if not dense:
        args = args + (system.cells,)
    # the per-particle field (T or C) follows v, as in the JAX signatures
    f, flux, virial = fn(x, v, field, *args[2:], **kw)
    return f, {"virial": virial, name: flux}


def _post_forces(system: System, params: SystemParams, state: State,
                 x, v_tilde, f, skip_bonded: bool = False, image=None):
    """Bonded terms, then the post_force fix hooks. ``image`` must be the
    flags that go with ``x`` (the post-drift image1 in the step): the
    membrane volume unwraps x with them. ``skip_bonded``: the distributed
    step computes the bonded terms itself over halo-extended rows
    (``parallel/domain.py``) and needs only the fix hooks. ``f`` is the
    pair force, given up to the result: on the card the pair bonds are
    added into it in place."""
    if system.bond_style is not None and not skip_bonded:
        from meso_tpu_torch.ops.bonded import bonded_forces
        f = bonded_forces(x, state.tag, state.mask, state.box, params.bonded,
                          system.bond_style, system.n_tags, system.n_mols,
                          image=state.image if image is None else image,
                          add_to=f)
    for fx in system.fixes:
        if hasattr(fx, "post_force"):
            f = fx.post_force(system, params, state, x, v_tilde, f)
    return f


def make_step(system: System, with_aux: bool = False):
    """Build the one-step function for this system.

    with_aux=True: step_fn returns (state, aux) with the pair 'virial'.
    eDPD and tDPD steps advance T or C by dt * dT/dt or dt * dC/dt on the
    mobile rows after final_integrate, then run the end_of_step fixes, in
    the JAX package's order."""
    wrap_each_step = system.wrap_mode != "rebuild"
    if not wrap_each_step:
        if system.force_path not in _BUCKET_PATHS:
            raise ValueError("wrap_mode='rebuild' requires a "
                             "bucket-resident force path")
        if any(hasattr(fx, "post_integrate") for fx in system.fixes):
            raise ValueError("wrap_mode='rebuild' is incompatible with "
                             "post_integrate fixes (walls need in-box "
                             "positions every step)")
    if system.model not in _MODELS:
        raise ValueError(f"unknown model {system.model!r}")

    # the per-row inverse mass, kept while the rows' types are unchanged
    # (the steps between two rebuilds): one gather a chunk, not a step.
    # Inference tensors keep no version counter: those are gathered anew.
    held = {}

    def inverse_mass(params: SystemParams, typ):
        if typ.is_inference() or params.inv_mass.is_inference():
            return _per_type(params.inv_mass, typ)
        versions = (typ._version, params.inv_mass._version)
        if (held.get("typ") is not typ
                or held.get("table") is not params.inv_mass
                or held.get("versions") != versions):
            held.update(typ=typ, table=params.inv_mass, versions=versions,
                        inv_m=_per_type(params.inv_mass, typ))
        return held["inv_m"]

    def step_fn(params: SystemParams, state: State, nlist_idx=None):
        inv_m = inverse_mass(params, state.typ)
        move = _move_mask(system, state.typ, state.mask)
        new_step = state.step + 1

        x1, image1, v_tilde = initial_integrate(
            state.x, state.v, state.f, state.image, state.box,
            system.dt, system.lam, inv_m, move, wrap=wrap_each_step)

        for fx in system.fixes:
            if hasattr(fx, "post_integrate"):
                x1, image1, v_tilde = fx.post_integrate(
                    system, params, state, x1, image1, v_tilde)

        # forces at (x', v~); the RNG counter is the new step. The virial
        # is computed only when the caller reads it (the JAX package also
        # keeps it on under wrap_mode="rebuild", for a TPU lowering reason
        # that does not apply here; forces are the same either way).
        f_new, aux = compute_forces(system, params, state, x1, v_tilde,
                                    new_step, nlist_idx, t=state.T,
                                    c=state.C, need_virial=with_aux)
        f_new = _post_forces(system, params, state, x1, v_tilde, f_new,
                             image=image1)

        v1 = final_integrate(state.v, state.f, f_new, system.dt, inv_m, move)
        new_state = state.replace(x=x1, v=v1, f=f_new, image=image1,
                                  step=new_step)
        if system.model == "edpd":
            zero = torch.zeros((), dtype=torch.float32, device=state.device)
            t1 = state.T + system.dt * torch.where(move, aux["dTdt"], zero)
            new_state = new_state.replace(T=t1, dTdt=aux["dTdt"])
        elif system.model == "tdpd":
            zero = torch.zeros((), dtype=torch.float32, device=state.device)
            c1 = state.C + system.dt * torch.where(move[:, None],
                                                   aux["dCdt"], zero)
            new_state = new_state.replace(C=c1, dCdt=aux["dCdt"])
        for fx in system.fixes:
            if hasattr(fx, "end_of_step"):
                new_state = fx.end_of_step(system, params, new_state)
        if with_aux:
            return new_state, {"virial": aux["virial"]}
        return new_state

    return step_fn


def rebuild(system: System, state: State):
    """Neighbour rebuild: re-sort the particles by cell, rebuild buckets and
    lists. Returns (sorted state, list idx (N, M), positions at the
    rebuild, diag) with diag's capacity counters "cell_overflow",
    "nlist_overflow" and "max_neigh", all device scalars."""
    state, cells = build_cells(state, system.cells)
    nlist = build_nlist(state.x, state.mask, state.box, cells, system.cells,
                        system.rc_max, system.nlist_m)
    diag = {"cell_overflow": cells.overflow,
            "nlist_overflow": nlist.overflow,
            "max_neigh": torch.max(nlist.n_neigh)}
    return state, nlist.idx, cells.x_ref, diag


def setup(system: System, params: SystemParams, state: State) -> State:
    """Initial force evaluation (the Verlet::setup analog). Bucket paths
    return the state in bucket rows, "nlist" sorted by cell."""
    if system.force_path in _BUCKET_PATHS:
        from meso_tpu_torch.neighbor.bucket_layout import to_bucket_state
        state = to_bucket_state(state, system.cells)
    nlist_idx = None
    if system.force_path == "nlist":
        state, nlist_idx, _, _ = rebuild(system, state)
    f0, _ = compute_forces(system, params, state, state.x, state.v,
                           state.step, nlist_idx, t=state.T, c=state.C)
    f0 = _post_forces(system, params, state, state.x, state.v, f0)
    return state.replace(f=f0)


# slots fit_capacity may add to the capacity sized from the density
_FIT_EXTRA_SLOTS = 8


def fit_capacity(system: System, state: State,
                 extra: int = _FIT_EXTRA_SLOTS) -> System:
    """The system with the least bucket capacity, from its own up to
    ``extra`` more (``_FIT_EXTRA_SLOTS`` by default), that places this
    N-row start with no overflow.

    ``CellConfig.for_box`` sizes K from the density alone. A uniform random
    start has Poisson occupancy, and at a million particles some seeds put
    a few rows more into one run of cells than K=16 and the spill room
    hold; the relaxed fluid's occupancy spreads far less. The builders
    call this before ``setup``, so such a start runs at a K of 17 or 18
    instead of failing. Where none of those capacities fits, the system comes back
    unchanged and ``setup`` raises naming K. Paths without buckets are
    returned unchanged."""
    if system.force_path not in _BUCKET_PATHS:
        return system
    from meso_tpu_torch.neighbor.bucket_layout import rebuild_buckets
    cfg = system.cells
    for k in range(cfg.capacity, cfg.capacity + extra + 1):
        _, overflow = rebuild_buckets(state, cfg.replace(capacity=k))
        if int(overflow) == 0:
            return system.replace(cells=cfg.replace(capacity=k))
    return system


def run_chunk(system: System, params: SystemParams, state: State,
              nsteps: int) -> State:
    """Advance ``nsteps`` steps with no rebuild (the dense path's loop)."""
    step_fn = make_step(system)
    for _ in range(nsteps):
        state = step_fn(params, state)
    return state


def run(system: System, params: SystemParams, state: State, nchunks: int):
    """The production loop: nchunks x (rebuild + rebuild_every steps) on the
    neighbour lists, with no host synchronisation. Returns (state, diag):
    per chunk (tensors of nchunks entries) the rebuild's counters and
    "skin_violation" (1 where some particle moved more than skin/2 since
    the rebuild) and "max_disp_sq". The dense path runs nchunks x
    rebuild_every steps and returns an empty diag."""
    if system.force_path == "dense":
        every = system.cells.rebuild_every if system.cells else 1
        return run_chunk(system, params, state, nchunks * every), {}
    step_fn = make_step(system)
    half_skin_sq = f32((system.cells.skin * 0.5) ** 2)
    diags = []
    for _ in range(nchunks):
        state, nlist_idx, x_ref, diag = rebuild(system, state)
        for _ in range(system.cells.rebuild_every):
            state = step_fn(params, state, nlist_idx)
        disp2 = max_displacement_sq(state.x, x_ref, state.mask, state.box)
        diag["skin_violation"] = (disp2 > half_skin_sq).to(torch.int32)
        diag["max_disp_sq"] = disp2
        diags.append(diag)
    return state, {name: torch.stack([d[name] for d in diags])
                   for name in diags[0]}


def run_adaptive(system: System, params: SystemParams, state: State,
                 nsteps: int):
    """The displacement-triggered loop on the neighbour lists
    (``Neighbor::decide``): before each step, re-sort and rebuild when some
    particle has moved more than skin/2 since the last rebuild, so an
    overshoot lasts at most one step of motion. The decision reads one
    device scalar on the host before every step. Returns (state, diag):
    "n_rebuilds" (a Python int), "worst_disp_at_rebuild" and the largest
    "cell_overflow" and "nlist_overflow" seen."""
    step_fn = make_step(system)
    half_skin_sq = f32((system.cells.skin * 0.5) ** 2)
    state, nlist_idx, x_ref, d0 = rebuild(system, state)
    cof, nof = d0["cell_overflow"], d0["nlist_overflow"]
    n_rebuilds = 0
    worst2 = torch.zeros((), dtype=torch.float32, device=state.device)
    for _ in range(nsteps):
        disp2 = max_displacement_sq(state.x, x_ref, state.mask, state.box)
        if float(disp2) > half_skin_sq:
            state, nlist_idx, x_ref, d = rebuild(system, state)
            cof = torch.maximum(cof, d["cell_overflow"])
            nof = torch.maximum(nof, d["nlist_overflow"])
            n_rebuilds += 1
            worst2 = torch.maximum(worst2, disp2)
        state = step_fn(params, state, nlist_idx)
    return state, {"n_rebuilds": n_rebuilds,
                   "worst_disp_at_rebuild": torch.sqrt(worst2),
                   "cell_overflow": cof, "nlist_overflow": nof}


def run_bucket_fixed(system: System, params: SystemParams, state: State,
                     nchunks: int, steps_per_chunk: int):
    """The fixed-cadence bucket loop: nchunks x (bucket rebuild +
    steps_per_chunk steps) through ``_bucket_chunk``, with no host
    synchronisation. Returns (state, diag) with the largest
    "bucket_overflow" and "worst_skin_ratio" (the largest displacement
    since a rebuild over skin/2) of the chunks."""
    half_skin = f32(system.cells.skin * 0.5)
    of_max = torch.zeros((), dtype=torch.int64, device=state.device)
    worst = torch.zeros((), dtype=torch.float32, device=state.device)
    for _ in range(nchunks):
        state, of, disp, _ = _bucket_chunk(system, params, state,
                                           steps_per_chunk,
                                           thermo_trace=False)
        of_max = torch.maximum(of_max, of.to(torch.int64))
        worst = torch.maximum(worst, disp / half_skin)
    return state, {"bucket_overflow": of_max, "worst_skin_ratio": worst}


def run_bucket(system: System, params: SystemParams, state: State,
               nsteps: int):
    """The displacement-triggered bucket loop (``Neighbor::decide``): before
    each step, rebuild when some particle has moved more than skin/2 since
    the last rebuild. As in JAX the test reads the positions the previous
    step's forces were taken at, so a skin overshoot lasts at most one step
    of motion. ``state`` must be bucket-resident (from ``setup``); the loop
    starts with a rebuild.

    The decision reads one device scalar, the largest displacement, on the
    host before every step: one synchronisation per step, which this loop
    accepts (JAX takes it inside ``lax.cond`` on the device).
    ``run_bucket_chunked`` is the timed loop. Returns (state, diag) with
    ``n_rebuilds`` (a Python int), ``worst_disp_at_rebuild`` and
    ``bucket_overflow``."""
    from meso_tpu_torch.neighbor.bucket_layout import rebuild_buckets

    step_fn = make_step(system)
    half_skin_sq = f32((system.cells.skin * 0.5) ** 2)
    state, overflow = rebuild_buckets(state, system.cells)
    x_ref = state.x
    n_rebuilds = 0
    worst2 = torch.zeros((), dtype=torch.float32, device=state.device)
    for _ in range(nsteps):
        disp2 = max_displacement_sq(state.x, x_ref, state.mask, state.box)
        if float(disp2) > half_skin_sq:
            state, of = rebuild_buckets(state, system.cells)
            x_ref = state.x
            overflow = torch.maximum(overflow, of)
            n_rebuilds += 1
            worst2 = torch.maximum(worst2, disp2)
        state = step_fn(params, state)
    return state, {"n_rebuilds": n_rebuilds,
                   "worst_disp_at_rebuild": torch.sqrt(worst2),
                   "bucket_overflow": overflow}


def _bucket_chunk(system: System, params: SystemParams, state: State,
                  steps_per_chunk: int, thermo_trace: bool = True):
    """One (rebuild + steps) chunk. Returns (state, overflow, max
    displacement, (kT trace, virial trace)); thermo_trace=False skips the
    per-step reductions and returns (None, None) for the traces."""
    from meso_tpu_torch.neighbor.bucket_layout import rebuild_buckets
    from meso_tpu_torch.obs.thermo import kinetic_temperature

    step_fn = make_step(system, with_aux=thermo_trace)
    state, of = rebuild_buckets(state, system.cells)
    x_ref = state.x
    kts, virs = [], []
    if thermo_trace:
        mass = _per_type(params.mass, state.typ)
        for _ in range(steps_per_chunk):
            state, aux = step_fn(params, state)
            kts.append(kinetic_temperature(state.v, mass, state.mask))
            virs.append(aux["virial"])
        trace = (torch.stack(kts), torch.stack(virs))
    else:
        for _ in range(steps_per_chunk):
            state = step_fn(params, state)
        trace = (None, None)
    disp = torch.sqrt(max_displacement_sq(state.x, x_ref, state.mask,
                                          state.box))
    return state, of, disp, trace


def run_bucket_chunked(system: System, params: SystemParams, state: State,
                       nchunks: int, steps_per_chunk: int,
                       max_trace_steps: int = 100_000,
                       thermo_trace: bool = True):
    """Host loop over (rebuild + steps) chunks — the production loop.

    Per-step kT/virial traces are bounded: only the last
    ``max_trace_steps`` steps are kept, and the overflow and displacement
    scalars of dropped chunks fold into high-water marks."""
    half_skin = float(system.cells.skin * 0.5)
    max_trace_chunks = max(1, max_trace_steps // max(steps_per_chunk, 1))
    ofs, disps, kts, virs = [], [], [], []
    of_hwm = disp_hwm = None
    for _ in range(nchunks):
        state, of, disp, (kt, vir) = _bucket_chunk(
            system, params, state, steps_per_chunk,
            thermo_trace=thermo_trace)
        ofs.append(of)      # device scalars; no host sync inside the loop
        disps.append(disp)
        kts.append(kt)
        virs.append(vir)
        if len(kts) > max_trace_chunks:
            kts.pop(0)
            virs.pop(0)
            of_old, disp_old = ofs.pop(0), disps.pop(0)
            of_hwm = of_old if of_hwm is None else torch.maximum(of_hwm,
                                                                 of_old)
            disp_hwm = (disp_old if disp_hwm is None
                        else torch.maximum(disp_hwm, disp_old))
    if of_hwm is not None:
        ofs.append(of_hwm)
        disps.append(disp_hwm)
    if thermo_trace:
        kt_trace = torch.cat(kts)
        vir_trace = torch.cat(virs)
        # P = (sum m v^2 + virial) / (3V) with sum m v^2 = dof*kT ~ 3(N-1) kT
        n = torch.sum(state.mask.to(torch.float32))
        vol = torch.prod(state.box.lengths)
        p_trace = (3.0 * (n - 1.0) * kt_trace + vir_trace) / (3.0 * vol)
    else:
        kt_trace = vir_trace = p_trace = torch.zeros(
            (0,), dtype=torch.float32, device=state.device)
    return state, {"bucket_overflow": torch.max(torch.stack(ofs)),
                   "worst_skin_ratio": torch.max(torch.stack(disps))
                   / half_skin,
                   "kt_trace": kt_trace, "virial_trace": vir_trace,
                   "pressure_trace": p_trace}
