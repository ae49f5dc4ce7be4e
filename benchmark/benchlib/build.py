"""Set-up of a cell: the configuration built through the program's deck
path with the traffic's engine, the start equilibrated and laid out.

Seeds: ``--seed`` is any non-negative whole number. The start's seed is
its low 32 bits; the pair noise's seed is a second 32-bit word mixed
from it, so the two streams never coincide.
"""

from __future__ import annotations

import copy
import time

M32 = 0xFFFFFFFF


def seeds_of(seed: int) -> dict:
    s = int(seed)
    if s < 0:
        raise ValueError("--seed must be a non-negative whole number")
    return {"init": s & M32,
            "pair": ((s * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) >> 32)
            & M32}


def _put(d: dict, dotted: str, value):
    *path, last = dotted.split(".")
    for k in path:
        d = d.setdefault(k, {})
    d[last] = value


def deck_of(config: dict, traffic: dict, seed: int) -> dict:
    """The deck the program loads: the configuration's, its seeds set,
    and the traffic's engine and rebuild cadence."""
    deck = copy.deepcopy(config["deck"])
    for dotted, which in config["seeded"].items():
        _put(deck, dotted, seeds_of(seed)[which])
    deck["engine"] = dict(traffic["engine"])
    deck.setdefault("neighbor", {})["rebuild_every"] = \
        traffic["rebuild_every"]
    return deck


def layout_capacity(system, config: dict, density: float) -> int:
    """The bucket capacity the cell runs at: the one the program sizes
    from the density for this layout. Every seed then runs the same
    rows."""
    from meso_tpu_torch.neighbor.cells import CellConfig
    cells = system.cells
    cfg = CellConfig.for_box(config["physics"]["lengths"], system.rc_max,
                             density, skin=cells.skin, spill=cells.spill)
    return cfg.capacity


def chunks(system, params, state, steps: int):
    """``steps`` steps of the program's chunked bucket loop, checked."""
    import torch
    from meso_tpu_torch.core.system import run_bucket_chunked
    every = system.cells.rebuild_every
    state, diag = run_bucket_chunked(system, params, state, steps // every,
                                     every, thermo_trace=False)
    if int(diag["bucket_overflow"]) or not bool(torch.isfinite(state.v)
                                               .all()):
        raise RuntimeError(
            f"set-up: bucket overflow {int(diag['bucket_overflow'])} or a "
            f"non-finite velocity at step {state.step}")
    return state


def relayout(system, state, k: int):
    """The system and state moved to bucket capacity ``k`` by the
    program's rebuild (which takes any row count), checked."""
    from meso_tpu_torch.neighbor.bucket_layout import rebuild_buckets
    if k == system.cells.capacity:
        return system, state
    system = system.replace(cells=system.cells.replace(capacity=k))
    state, overflow = rebuild_buckets(state, system.cells)
    if int(overflow):
        raise RuntimeError(f"set-up: {int(overflow)} rows do not fit K={k}")
    return system, state


def build(config: dict, traffic: dict, seed: int, device, phases=None):
    """(system, params, state, steps per second of the last ``rate_steps``
    steps), with the seconds of each part of the set-up added to
    ``phases`` where given: the built configuration, equilibrated for its
    ``equilibrate_steps`` with ``equilibrate_extra_slots`` more slots a
    cell than the start needed (the hot random start's occupancy swings
    for a few hundred steps; a row that does not fit would be lost),
    moved to the layout's capacity, and run for the traffic's
    ``rate_steps`` on that layout (which also builds and loads every
    kernel and table the window uses)."""
    import torch
    from meso_tpu_torch.io.deck import build_from_deck

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases = {} if phases is None else phases
    t = [time.perf_counter()]

    def lap(name):
        sync()
        t.append(time.perf_counter())
        phases[name] = t[-1] - t[-2]

    system, params, state, _ = build_from_deck(
        deck_of(config, traffic, seed), device=device)
    lap("build")
    system, state = relayout(system, state, system.cells.capacity
                             + int(config["equilibrate_extra_slots"]))
    state = chunks(system, params, state, config["equilibrate_steps"])
    lap("equilibrate")
    density = float(state.n_valid()) / float(
        torch.prod(state.box.lengths))
    system, state = relayout(system, state,
                             layout_capacity(system, config, density))
    lap("relayout")
    state = chunks(system, params, state, traffic["rate_steps"])
    lap("rate")
    rate = traffic["rate_steps"] / phases["rate"]
    return system, params, state, rate
