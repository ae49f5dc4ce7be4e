"""Shared set-up of the benchmark's tests: the harness's directories on
sys.path, the ``card`` marker, and a small copy of the benchmark that the
CPU runs end to end (L = 8: 1,536 particles)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL_L = 8.0


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


@pytest.fixture(autouse=True)
def few_torch_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_config(config: dict) -> dict:
    """The configuration at L = 8, equilibrated briefly."""
    c = json.loads(json.dumps(config))
    c["deck"]["box"]["l"] = SMALL_L
    c["physics"]["lengths"] = [SMALL_L] * 3
    c["equilibrate_steps"] = 300
    c["equilibrate_extra_slots"] = 0
    # 1,536 particles: one thermo row's kT scatters by ~2% (sqrt(2/3N))
    c["limits"]["kT_gap"] = 0.1
    return c


def small_traffic(traffic: dict) -> dict:
    t = dict(traffic)
    t.update(thermo_every=6, rate_steps=6, trace_intervals=1)
    return t


def make_small_bench(dest: Path) -> tuple:
    """A copy of BENCHMARK.json and the benchmark's files under ``dest``,
    every configuration and traffic mix made small. Returns
    (BENCHMARK.json path, benchmark directory)."""
    bench_dir = dest / "benchmark"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for path in (bench_dir / "configs").glob("*.json"):
        path.write_text(json.dumps(small_config(json.loads(
            path.read_text()))))
    for path in (bench_dir / "traffic").glob("*.json"):
        path.write_text(json.dumps(small_traffic(json.loads(
            path.read_text()))))
    bench_json = dest / "BENCHMARK.json"
    shutil.copy(ROOT / "BENCHMARK.json", bench_json)
    return bench_json, bench_dir


@pytest.fixture
def small_bench(tmp_path):
    return make_small_bench(tmp_path)
