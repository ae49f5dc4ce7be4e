"""Declarative TOML decks, the input-script analog (port of
``meso_tpu/io/deck.py``).

The deck's tables mirror the LAMMPS input concepts one to one:

    [box]            lengths = [32.0, 32.0, 32.0]
    [atoms]          density = 3.0   kt = 1.0   types = 1   create = "random"
    [pair.dpd]       a = 25.0  gamma = 4.5  rc = 1.0  kt = 1.0  seed = 928459
    [[pair.coeff]]   i = 1  j = 1  a = 25.0  gamma = 4.5  rc = 1.0
    [integrate]      dt = 0.01  lambda_ = 0.5
    [neighbor]       skin = 0.3  rebuild_every = 10
    [engine]         force_path = "pallas"  spill = true  rebuild = "sort"
    [run]            steps = 1000  thermo_every = 100

or name one of the eight model builders:

    [model]       builder = "poiseuille"
    [model.args]  g = 0.1  h = 6.0

A builder deck may also give keys of [box], [pair.dpd], [integrate],
[neighbor], [rng] and [engine]: each goes to the builder as the argument
of the same meaning where the builder takes one (``[box] l`` as ``l``,
``[integrate] lambda_`` as ``lam``, ``[rng] mode`` as ``rng_mode``), else,
for lambda, the rebuild cadence and the engine's layout, onto the built
system before its capacity is fitted and its start set up again; any
other key, any other section, and an argument given twice raise, naming
it.

``pair.coeff`` rows use 1-based type indices, as LAMMPS does. Every engine
knob of the JAX package is accepted; the TPU-only ones (``z_chunks``,
``pair_kernel = "v3_dynroll"``) are kept on the System and ignored by it.
The random start draws from a ``torch.Generator`` seeded with
``init_seed`` on the run's device, so its draws differ from the JAX
package's ``jax.random`` start.
"""

from __future__ import annotations

import importlib
import re
import tomllib
from dataclasses import dataclass

import numpy as np
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import create_random
from meso_tpu_torch.core.system import (System, SystemParams, fit_capacity,
                                        setup)
from meso_tpu_torch.ops.dpd import DPDParams


@dataclass(frozen=True)
class RunConfig:
    steps: int = 1000
    thermo_every: int = 100
    dump_every: int = 0
    dump_path: str = "dump.lammpstrj"
    restart_every: int = 0
    restart_path: str = "restart.npz"


def _substitute(obj, variables: dict):
    """Recursive ``${name}`` substitution (the LAMMPS ``variable``/``$x``
    analog). A string that is exactly one ``${name}`` keeps the variable's
    native type (float/int/list); embedded references stringify."""
    if isinstance(obj, dict):
        return {k: _substitute(v, variables) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_substitute(v, variables) for v in obj]
    if isinstance(obj, str):
        m = re.fullmatch(r"\$\{(\w+)\}", obj)
        if m:
            name = m.group(1)
            if name not in variables:
                raise KeyError(f"deck variable ${{{name}}} undefined")
            return variables[name]
        return re.sub(r"\$\{(\w+)\}",
                      lambda mm: str(variables[mm.group(1)]), obj)
    return obj


def load_deck(path: str, overrides: dict | None = None) -> dict:
    """Load a TOML deck. The optional ``[variables]`` table defines values
    referenced elsewhere as ``"${name}"``; ``overrides`` (e.g. from the CLI
    ``--var name=value``) replace them before substitution."""
    with open(path, "rb") as fh:
        deck = tomllib.load(fh)
    variables = dict(deck.pop("variables", {}))
    if overrides:
        for k, v in overrides.items():
            variables[k] = v
    # variables may reference earlier variables (one pass, like LAMMPS)
    resolved = {}
    for k, v in variables.items():
        resolved[k] = _substitute(v, resolved)
    return _substitute(deck, resolved)


_BUILDERS = {
    "classic_fluid": "meso_tpu_torch.models.classic:classic_fluid",
    "poiseuille": "meso_tpu_torch.models.walls:poiseuille",
    "couette": "meso_tpu_torch.models.walls:couette",
    "edpd_slab": "meso_tpu_torch.models.transport:edpd_slab",
    "tdpd_diffusion": "meso_tpu_torch.models.transport:tdpd_diffusion",
    "polymer_melt": "meso_tpu_torch.models.polymer:polymer_melt",
    "block_copolymer_melt":
        "meso_tpu_torch.models.polymer:block_copolymer_melt",
    "membrane_suspension":
        "meso_tpu_torch.models.polymer:membrane_suspension",
}


def _run_cfg(deck: dict) -> RunConfig:
    rn = deck.get("run", {})
    return RunConfig(
        steps=int(rn.get("steps", 1000)),
        thermo_every=int(rn.get("thermo_every", 100)),
        dump_every=int(rn.get("dump_every", 0)),
        dump_path=str(rn.get("dump_path", "dump.lammpstrj")),
        restart_every=int(rn.get("restart_every", 0)),
        restart_path=str(rn.get("restart_path", "restart.npz")))


def _bonded_from_data(deck: dict, data: dict, device):
    """BondedParams of a read_data file's bonds and angles, with the
    coefficients from the deck's [bonds]/[angles] tables; raises where a
    bond or angle names a tag no atom has."""
    from meso_tpu_torch.ops.bonded import BondedParams

    def tensor(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)

    coeffs = np.asarray(deck.get("bonds", {}).get(
        "coeffs", [[30.0, 1.5, 0.0, 0.0]]), np.float32)
    if coeffs.shape[1] < 4:
        coeffs = np.pad(coeffs, ((0, 0), (0, 4 - coeffs.shape[1])))
    bonded = BondedParams(bond_tags=tensor(data["bonds"], np.int32),
                          bond_type=tensor(data["bond_type"], np.int32),
                          bond_coeffs=tensor(coeffs, np.float32))
    if data["angles"] is not None:
        acoeffs = np.asarray(deck.get("angles", {}).get(
            "coeffs", [[5.0, 3.14159265]]), np.float32)
        bonded = bonded.replace(
            angle_tags=tensor(data["angles"], np.int32),
            angle_type=tensor(data["angle_type"], np.int32),
            angle_coeffs=tensor(acoeffs, np.float32))
    # tags need not be contiguous 1..N: the inverse-tag tables are sized
    # from the largest tag, and a term naming an unknown tag raises (an
    # out-of-range partner would be dropped without a word)
    n_tags = int(np.max(data["tag"]))
    max_bond_tag = int(np.max(data["bonds"]))
    if data["angles"] is not None:
        max_bond_tag = max(max_bond_tag, int(np.max(data["angles"])))
    if max_bond_tag > n_tags or int(np.min(data["bonds"])) < 1:
        raise ValueError(
            f"read_data: bond/angle tag out of range (max referenced "
            f"{max_bond_tag}, max atom tag {n_tags})")
    return bonded, n_tags


# A builder deck's keys of the explicit schema, and the builder argument
# each gives where the builder takes it
_BUILDER_ARGS = {
    ("box", "l"): "l", ("pair.dpd", "a"): "a", ("pair.dpd", "gamma"): "gamma",
    ("pair.dpd", "rc"): "rc", ("pair.dpd", "kt"): "kt",
    ("pair.dpd", "seed"): "seed", ("integrate", "dt"): "dt",
    ("integrate", "lambda_"): "lam", ("integrate", "lambda"): "lam",
    ("neighbor", "skin"): "skin", ("neighbor", "rebuild_every"):
        "rebuild_every", ("rng", "mode"): "rng_mode",
    ("engine", "force_path"): "force_path",
    ("engine", "pair_kernel"): "pair_kernel", ("engine", "spill"): "spill",
    ("engine", "rebuild"): "rebuild", ("engine", "wrap_mode"): "wrap_mode",
    ("engine", "z_chunks"): "z_chunks"}
# those of them that a builder which does not take them can still have:
# settings of the built system (applied by _configure_builder; every
# builder takes the box, the pair table, dt, skin and the force path)
_SYSTEM_KEYS = {("integrate", "lambda_"), ("integrate", "lambda"),
                ("neighbor", "rebuild_every"), ("engine", "pair_kernel"),
                ("engine", "spill"), ("engine", "rebuild"),
                ("engine", "wrap_mode"), ("engine", "z_chunks")}


def _builder_inputs(deck: dict, builder) -> tuple[dict, dict]:
    """(builder arguments, system settings) of a builder deck: its
    [model.args], then each key of [box], [pair.dpd], [integrate],
    [neighbor], [rng] and [engine] as the builder's argument where the
    builder takes it (``_BUILDER_ARGS``), else as a setting of the built
    system where it is one (``_SYSTEM_KEYS``). Raises naming every key and
    section it cannot apply, and every argument given twice."""
    import inspect
    takes = set(inspect.signature(builder).parameters)
    args = dict(deck["model"].get("args", {}))
    given = {}
    bad = [f"[{sec}]" for sec in deck
           if sec not in ("model", "run", "box", "pair", "integrate",
                          "neighbor", "rng", "engine")]
    for sec in ("box", "integrate", "neighbor", "rng", "engine"):
        given.update({(sec, k): v for k, v in deck.get(sec, {}).items()})
    for k, v in deck.get("pair", {}).items():
        if k == "dpd":
            given.update({("pair.dpd", kk): vv for kk, vv in v.items()})
        else:
            bad.append(f"[pair.{k}]")
    settings = {}
    for (sec, k), v in given.items():
        arg = _BUILDER_ARGS.get((sec, k))
        if arg in takes:
            if arg in args:
                bad.append(f"[{sec}] {k} (also [model.args] {arg})")
            args[arg] = v
        elif (sec, k) in _SYSTEM_KEYS:
            settings[(sec, k)] = v
        else:
            bad.append(f"[{sec}] {k}")
    if bad:
        raise ValueError(f"a builder deck ([model] builder = "
                         f"{deck['model']['builder']!r}) cannot apply "
                         f"{', '.join(bad)}")
    return args, settings


def _configure_builder(system: System, state, settings: dict) -> System:
    """The built system with a builder deck's settings that its builder
    does not take (``_builder_inputs``) applied. The cells keep the
    capacity the builder fitted to its start unless the spill layout
    changes: then K comes from the start's density again (and is fitted
    after)."""
    from meso_tpu_torch.neighbor.cells import CellConfig

    def get(sec, key, default):
        return settings.get((sec, key), default)

    cells = system.cells
    wrap_mode = str(get("engine", "wrap_mode", system.wrap_mode))
    spill = bool(get("engine", "spill", cells.spill))
    lengths = state.box.lengths.tolist()
    density = float(state.n_valid()) / float(np.prod(lengths))
    cfg = CellConfig.for_box(
        lengths, system.rc_max, density, skin=cells.skin,
        rebuild_every=int(get("neighbor", "rebuild_every",
                              cells.rebuild_every)),
        capacity=cells.capacity if spill == cells.spill else None,
        spill=spill, rebuild=str(get("engine", "rebuild", cells.rebuild)),
        wrap_at_rebuild=wrap_mode == "rebuild")
    lam = get("integrate", "lambda_", get("integrate", "lambda", system.lam))
    return system.replace(
        cells=cfg, wrap_mode=wrap_mode,
        pair_kernel=str(get("engine", "pair_kernel", system.pair_kernel)),
        z_chunks=int(get("engine", "z_chunks", system.z_chunks)),
        lam=float(lam))


def build_from_deck(deck: dict, device="cuda"):
    """deck dict -> (system, params, state, run_cfg), on ``device``: the
    card unless the caller asks for another (the CPU tests pass
    ``device="cpu"``); with no card, torch raises.

    A builder deck calls the port's builder with its [model.args], the
    keys of the explicit schema the builder takes as arguments
    (``_builder_inputs``) and ``device``; the settings the builder does not
    take are then applied to the built system, whose capacity is fitted
    and whose start is set up again on it. The explicit schema builds the
    box, the pair tables, the system and a random or read_data start;
    bucketed paths get the least capacity that places the start
    (``core.system.fit_capacity``)."""
    device = torch.device(device)
    if "model" in deck:
        name = deck["model"]["builder"]
        modpath, fn = _BUILDERS[name].split(":")
        builder = getattr(importlib.import_module(modpath), fn)
        args, settings = _builder_inputs(deck, builder)
        out = builder(**args, device=device)
        system, params, state = out[:3]
        if settings:
            system = _configure_builder(system, state, settings)
            system = fit_capacity(system, state)
            state = setup(system, params, state)
        return system, params, state, _run_cfg(deck)
    boxcfg = deck.get("box", {})
    lengths = boxcfg.get("lengths") or [boxcfg.get("l", 10.0)] * 3
    box = Box.orthorhombic(*[float(v) for v in lengths], device=device)
    vol = float(np.prod(lengths))

    atoms = deck.get("atoms", {})
    n_types = int(atoms.get("types", 1))
    kt_init = float(atoms.get("kt", 1.0))
    if "n" in atoms:
        n = int(atoms["n"])
    else:
        n = int(round(float(atoms.get("density", 3.0)) * vol))
    density = n / vol

    pd = deck.get("pair", {}).get("dpd", {})
    kt = float(pd.get("kt", 1.0))
    a = np.full((n_types, n_types), float(pd.get("a", 25.0)), np.float32)
    gamma = np.full((n_types, n_types), float(pd.get("gamma", 4.5)),
                    np.float32)
    rc = np.full((n_types, n_types), float(pd.get("rc", 1.0)), np.float32)
    for row in deck.get("pair", {}).get("coeff", []):
        i, j = int(row["i"]) - 1, int(row["j"]) - 1
        for tbl, key in ((a, "a"), (gamma, "gamma"), (rc, "rc")):
            if key in row:
                tbl[i, j] = tbl[j, i] = float(row[key])
    pair = DPDParams.build(a=a, gamma=gamma, rc=rc, kt=kt,
                           seed=int(pd.get("seed", 12345)), n_types=n_types,
                           device=device)
    params = SystemParams.build(pair, mass=atoms.get("mass", 1.0))

    integ = deck.get("integrate", {})
    neigh = deck.get("neighbor", {})
    engine = deck.get("engine", {})
    force_path = str(engine.get("force_path", "nlist"))
    # right-spill packing: on by default for force_path "pallas"
    spill = bool(engine.get("spill", force_path == "pallas"))

    def make_system(lengths, density):
        system = System.for_fluid(
            lengths, rc=float(np.max(rc)), density=density,
            dt=float(integ.get("dt", 0.01)),
            skin=float(neigh.get("skin", 0.3)),
            rebuild_every=int(neigh.get("rebuild_every", 10)),
            rng_mode=str(deck.get("rng", {}).get("mode", "tea")),
            spill=spill, rebuild=str(engine.get("rebuild", "gather")),
            wrap_mode=str(engine.get("wrap_mode", "step")))
        return system.replace(
            lam=float(integ.get("lambda_", integ.get("lambda", 0.5))),
            force_path=force_path,
            pair_kernel=str(engine.get("pair_kernel", "v3")),
            z_chunks=int(engine.get("z_chunks", 0)))

    system = make_system(lengths, density)
    create = atoms.get("create", "random")
    if create == "random":
        gen = torch.Generator(device=device)
        gen.manual_seed(int(atoms.get("init_seed", 0)))
        state = create_random(gen, n, box, kt=kt_init)
    elif create == "read_data":
        # an external configuration (LAMMPS-style data file or .npz): the
        # file's box and atom count override the deck's [box] and density
        from meso_tpu_torch.io.data import read_data, state_from_data
        data = read_data(str(atoms["file"]))
        box, state = state_from_data(
            data, kt_init=kt_init, init_seed=int(atoms.get("init_seed", 0)),
            device=device)
        n = data["n"]
        lengths = [float(v) for v in (data["box_hi"] - data["box_lo"])]
        system = make_system(lengths, n / float(np.prod(lengths)))
        if data["masses"] is not None:
            params = SystemParams.build(pair, mass=data["masses"])
        if data["bonds"] is not None:
            bonded, n_tags = _bonded_from_data(deck, data, device)
            params = params.replace(bonded=bonded)
            system = system.replace(
                bond_style=str(deck.get("bonds", {}).get("style",
                                                         "harmonic")),
                n_tags=n_tags)
    else:
        raise ValueError(f"unknown atoms.create {create!r}")
    system = fit_capacity(system, state)
    state = setup(system, params, state)
    return system, params, state, _run_cfg(deck)
