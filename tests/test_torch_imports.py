"""The port stands alone: importing it never imports JAX, its kernels are
never replaced by their plain versions off the CPU, and unported paths
raise instead of running something else."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.utils.cpp_extension

from meso_tpu_torch import bridge
from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import create_random
from meso_tpu_torch.core.system import System, SystemParams, make_step, setup
from meso_tpu_torch.kernels import _build
from meso_tpu_torch.kernels.pair_dpd_v3 import (LAUNCHES,
                                                bucket_forces_pallas_v3,
                                                particle_hash_v3)
from meso_tpu_torch.models.classic import classic_fluid
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops.dpd import DPDParams

REPO = Path(__file__).resolve().parents[1]
MODULES = ["meso_tpu_torch", "meso_tpu_torch.bridge",
           "meso_tpu_torch.core.system", "meso_tpu_torch.core.rng",
           "meso_tpu_torch.kernels.pair_dpd_v3",
           "meso_tpu_torch.kernels._build",
           "meso_tpu_torch.neighbor.bucket_layout",
           "meso_tpu_torch.neighbor.nlist", "meso_tpu_torch.models.classic",
           "meso_tpu_torch.obs.thermo", "meso_tpu_torch.ops.dpd"]


def test_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            "             in ('jax', 'jaxlib', 'meso_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_in_sources():
    for path in (REPO / "meso_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "meso_tpu"), \
                    f"{path}: {line}"


def _meta_case():
    """A small bucket state moved to the meta device: not the CPU, so the
    wrappers must take their kernel path."""
    system, params, state = classic_fluid(
        l=6.0, rng_mode="fast", force_path="pallas", wrap_mode="rebuild",
        rebuild="sort", skin=0.4, rebuild_every=3)
    meta = bridge.state_from(bridge.state_to_numpy(state), device="meta")
    return system, params.pair.to("meta"), meta


def test_non_cpu_input_without_nvcc_raises(monkeypatch):
    """With no kernel library and no compiler, a non-CPU tensor raises; the
    wrapper never falls back to its plain version."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("CUDA_PATH", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    _build.load_library.cache_clear()
    system, pair, st = _meta_case()
    before = dict(LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bucket_forces_pallas_v3(st.x, st.v, st.typ, st.tag, st.mask, st.box,
                                1, pair, 0.01, system.cells)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        particle_hash_v3(st.tag, 1, pair.seed)
    assert LAUNCHES == before


def test_build_paths_stay_inside_the_checkout():
    assert _build.BUILD_DIR == REPO / "build" / "meso_tpu_torch"
    assert [p.name for p in _build.sources()] == ["pair_dpd_v3.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("change,match", [
    (dict(model="edpd"), "Queue 1 item 8"),
    (dict(model="tdpd"), "Queue 1 item 8"),
    (dict(force_path="nlist", wrap_mode="step"), "Queue 1 item 13"),
    (dict(force_path="bucket"), "Queue 1 item 13"),
    (dict(force_path="pallas_banded"), "K6"),
    (dict(pair_kernel="v2"), "K5"),
    (dict(bond_style="fene"), "Queue 1 item 10"),
])
def test_unported_paths_raise(change, match):
    cfg = CellConfig.for_box([6.0] * 3, 1.0, 3.0, skin=0.4, rebuild_every=3,
                             wrap_at_rebuild=True)
    system = System(rng_mode="fast", force_path="pallas", wrap_mode="rebuild",
                    cells=cfg).replace(**change)
    params = SystemParams.build(DPDParams.build(a=25.0, gamma=4.5, rc=1.0,
                                                kt=1.0, seed=1))
    box = Box.cubic(6.0)
    state = create_random(torch.Generator().manual_seed(0), 648, box)
    with pytest.raises(NotImplementedError, match=match):
        if change.get("model"):
            make_step(system)
        setup(system, params, state)


def test_wrap_mode_rebuild_needs_bucket_path():
    with pytest.raises(ValueError, match="bucket-resident"):
        make_step(System(force_path="dense", wrap_mode="rebuild"))
