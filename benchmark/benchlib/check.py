"""Whether a window's output is correct. The configuration names its
plain reference module (``benchmark/reference/<name>.py``), which holds
the physics (``Physics``, ``Layout``) and works out the check's numbers
itself (``numbers``, the names in ``NUMBERS``); the configuration's
``limits`` hold each number's limit. A later configuration with other
numbers brings its own reference module and limits, and nothing here
changes.
"""

from __future__ import annotations

import importlib

import numpy as np

from benchlib.build import seeds_of


def physics_of(config: dict, seed: int):
    """(the configuration's reference module, its Physics for ``seed``)."""
    ref = importlib.import_module(f"reference.{config['reference']}")
    ph = dict(config["physics"])
    ph["lengths"] = tuple(ph["lengths"])
    return ref, ref.Physics(seed=seeds_of(seed)["pair"], **ph)


def layout_of(ref, system):
    """The reference's Layout of the bucket rows the program runs."""
    c = system.cells
    return ref.Layout(ncell=tuple(c.ncell), capacity=c.capacity,
                      spill=c.spill, wrap_at_rebuild=c.wrap_at_rebuild,
                      rebuild_every=c.rebuild_every)


def numbers_of(ref, phys, lay, res: dict, final: dict, control=None):
    """(the reference's numbers of a window result, in-range ordered
    pairs); every number infinite where the window stopped early or left
    no snapshot."""
    if res["code"] != 0 or res["snapshot"] is None:
        return {k: float("inf") for k in ref.NUMBERS}, 0
    return ref.numbers(final, res["snapshot"], res["rows"], phys, lay,
                       control)


def judge(numbers: dict, limits: dict) -> tuple:
    """(every number within its limit, {name: {value, limit}}); a limit
    whose number is missing fails."""
    out = {k: {"value": numbers.get(k, float("inf")), "limit": v}
           for k, v in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in out.values())
    return ok, out
