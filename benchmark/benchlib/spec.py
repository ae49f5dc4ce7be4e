"""Finding a cell's files by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix; each per-layer metric
names its layer. Everything one of them needs is a file of its own:

    <bench>/configs/<config>.json    (the file BENCHMARK.json gives)
    <bench>/traffic/<traffic>.json
    <bench>/metrics/<metric>.py      (a reader: read(ctx) -> value | None;
                                      <base>.<group> is read by <base>.py)
    <bench>/layers/<layer>.json      (the layer's spans, by the metric's
                                      reader's LAYER)
    <bench>/reference/<module>.py    (the configuration's "reference")

so that a later cell or metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list           # the metric entries this cell reports
    bench_dir: Path
    chips: int = 1
    readers: dict = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_reader(bench_dir: Path, metric: str):
    """The module benchmark/metrics/<base>.py of a metric named <base> or
    <base>.<group>: one quantity split by the end-to-end metric its cells
    report has one reader."""
    base = metric.split(".")[0]
    path = bench_dir / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench_json: Path | None = None,
              bench_dir: Path | None = None) -> Cell:
    """The cell ``name`` of ``bench_json`` (the repository's
    BENCHMARK.json by default), its files read from ``bench_dir``."""
    bench_dir = Path(bench_dir or BENCH_DIR)
    bench_json = Path(bench_json or bench_dir.parent / "BENCHMARK.json")
    spec = load_json(bench_json)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_json}")
    w = cells[name]
    cfgs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = cfgs[w["config"]]
    config = load_json(bench_json.parent / cfg_entry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, name, e2e_names)]
    readers = {m["name"]: load_reader(bench_dir, m["name"])
               for m in per_layer}
    return Cell(name=name, config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer, bench_dir=bench_dir,
                chips=int(w.get("chips", 1)), readers=readers)


def layer_spans(bench_dir: Path) -> dict:
    """{layer file name: [module:function, ...]} of every layer whose
    entry functions open spans. Every such layer is wrapped in every
    traced run, so that a kernel is never credited to the step glue only
    because its layer is not reported in that cell."""
    out = {}
    for path in sorted((Path(bench_dir) / "layers").glob("*.json")):
        spans = load_json(path).get("spans", [])
        if spans:
            out[path.stem] = spans
    return out


def read_layers(cell: Cell) -> set:
    """The layers whose device time a reader of this cell reads: each of
    their spans has to open in the traced window."""
    return {r.LAYER for r in cell.readers.values()
            if getattr(r, "LAYER", None)}
