"""Neither the harness nor the reference imports JAX or the JAX package,
and the reference imports nothing of the program: every import statement
under benchmark/, by the top-level name compared whole (meso_tpu_torch is
not meso_tpu)."""

from __future__ import annotations

import ast

import pytest
from conftest import BENCH

import run

FORBIDDEN = {"jax", "jaxlib", "flax", "meso_tpu", "chip_smoke", "bench"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_in_the_harness(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "meso_tpu_torch" not in names
    assert names <= {"__future__", "math", "dataclasses", "numpy", "torch",
                     "reference"}


def test_whole_names_are_compared():
    assert run.forbidden_modules(["meso_tpu_torch", "meso_tpu_torch.core",
                                  "jaxtyping", "benchlib"]) == []
    assert run.forbidden_modules(["meso_tpu.core.system", "jax.numpy",
                                  "flax"]) == ["flax", "jax", "meso_tpu"]
