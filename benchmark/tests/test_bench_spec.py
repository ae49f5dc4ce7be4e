"""BENCHMARK.json against the benchmark's contract, every cell resolved to
its files by name, and a cell added from a temporary directory by adding
files only."""

from __future__ import annotations

import json
import re
import shutil

import pytest
from conftest import BENCH, ROOT

from benchlib import check, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)


def test_names_units_and_entries():
    names = set()
    for entry in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] \
            + SPEC["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in names
        names.add(entry["name"])
        for k in ("why", "layer", "source"):
            if k in entry:
                assert 1 <= len(entry[k]) <= 200
                assert "\n" not in entry[k] and "\t" not in entry[k]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_every_cell_one_chip_and_configs_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in SPEC["workloads"]
                                    if w["name"] == cell)
    assert {"engine", "rebuild_every", "thermo_every", "rate_steps",
            "trace_intervals"} <= set(c.traffic)
    assert (BENCH / "reference" / f"{c.config['reference']}.py").exists()
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        reader = c.readers[m["name"]]
        assert callable(reader.read)
        if reader.LAYER:
            layer = spec.load_json(BENCH / "layers" / f"{reader.LAYER}.json")
            assert layer["spans"] and layer["layer"] == m["layer"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for m in c.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_physics_matches_its_deck(name):
    """The reference's physics block states the same numbers the program
    is given in the deck."""
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    ph, deck = cfg["physics"], cfg["deck"]
    pd = deck["pair"]["dpd"]
    given = {"a": pd["a"], "gamma": pd["gamma"], "rc": pd["rc"],
             "kt": pd["kt"], "dt": deck["integrate"]["dt"],
             "lam": deck["integrate"]["lambda_"]}
    assert ph["lengths"] == [deck["box"]["l"]] * 3
    assert {k: ph[k] for k in given} == given
    assert entry["source"] == cfg["source"]
    assert entry["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_limits_are_the_references_numbers(name):
    """A configuration gives a limit to each number its reference module
    works out, and to no other."""
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    ref, _ = check.physics_of(cfg, 7)
    assert set(cfg["limits"]) == set(ref.NUMBERS)


def test_a_cell_added_by_files_alone(tmp_path):
    """A later cell, configuration, reference, traffic mix and per-layer
    metric come as new files and entries: the harness finds them by name,
    and the new reference's own numbers are judged by the new
    configuration's limits, with no file edited."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    traffic = json.loads((BENCH / "traffic" / "spill.json").read_text())
    traffic["thermo_every"] = 300
    (bench_dir / "traffic" / "spill_slow_thermo.json").write_text(
        json.dumps(traffic))
    (bench_dir / "metrics" / "rebuild_share_of_busy.py").write_text(
        'LAYER = "rebuild"\n\n\ndef read(ctx):\n'
        '    return 100.0 * ctx["layer_s"]["rebuild"] / ctx["busy_s"]\n')
    (bench_dir / "reference" / "toy_heat.py").write_text(
        'from dataclasses import dataclass\n\n'
        'NUMBERS = ("heat_gap",)\n\n\n'
        '@dataclass(frozen=True)\nclass Physics:\n'
        '    lengths: tuple\n    seed: int\n\n\n'
        'def numbers(final, snap, rows, phys, lay, control=None):\n'
        '    return {"heat_gap": abs(final["heat"] - 1.0)}, 0\n')
    cfg = json.loads((BENCH / "configs" / "classic_fluid_l70.json")
                     .read_text())
    cfg.update(name="toy_heat_l70", reference="toy_heat",
               physics={"lengths": [70.0] * 3}, limits={"heat_gap": 0.01})
    (bench_dir / "configs" / "toy_heat_l70.json").write_text(
        json.dumps(cfg))
    spec_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec_json["configs"].append(
        {"name": "toy_heat_l70", "source": "https://example.org/toy",
         "file": "benchmark/configs/toy_heat_l70.json", "reduced": [],
         "why": "a throwaway configuration"})
    spec_json["workloads"] += [
        {"name": "classic_fluid_l70.spill_slow_thermo",
         "config": "classic_fluid_l70", "traffic": "spill_slow_thermo",
         "chips": 1, "why": "a throwaway cell"},
        {"name": "toy_heat_l70.spill", "config": "toy_heat_l70",
         "traffic": "spill", "chips": 1, "why": "a throwaway cell"}]
    spec_json["per_layer"].append(
        {"name": "rebuild_share_of_busy", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "rebuild",
         "moves": "particle_steps_per_s",
         "workloads": ["classic_fluid_l70.spill_slow_thermo"]})
    bench_json = tmp_path / "BENCHMARK.json"
    bench_json.write_text(json.dumps(spec_json))
    cell = spec.load_cell("classic_fluid_l70.spill_slow_thermo",
                          bench_json=bench_json, bench_dir=bench_dir)
    assert cell.traffic["thermo_every"] == 300
    assert {m["name"] for m in cell.end_to_end} == {"particle_steps_per_s",
                                                    "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["rebuild_share_of_busy"]
    ctx = {"layer_s": {"rebuild": 1.0}, "busy_s": 4.0}
    assert cell.readers["rebuild_share_of_busy"].read(ctx) == 25.0
    assert "rebuild" in spec.read_layers(cell)

    toy = spec.load_cell("toy_heat_l70.spill", bench_json=bench_json,
                         bench_dir=bench_dir)
    import sys
    sys.path.insert(0, str(tmp_path / "benchmark"))
    sys.modules.pop("reference", None)
    try:
        ref, phys = check.physics_of(toy.config, 7)
        res = {"code": 0, "snapshot": {}, "rows": []}
        for heat, ok in ((1.001, True), (1.1, False)):
            numbers, _ = check.numbers_of(ref, phys, None, res,
                                          {"heat": heat})
            assert check.judge(numbers, toy.config["limits"])[0] is ok
    finally:
        sys.path.remove(str(tmp_path / "benchmark"))
        for m in [m for m in sys.modules if m == "reference"
                  or m.startswith("reference.")]:
            sys.modules.pop(m)
