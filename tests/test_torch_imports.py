"""The port stands alone: importing it never imports JAX or the JAX
package's tools, its kernels are never replaced by their plain versions
off the CPU, and paths the JAX package refuses raise instead of running
something else."""

import inspect
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
from meso_tpu_torch.kernels import (_brick, _build, pair_dpd,
                                    pair_dpd_fused, pair_multiphysics)
from meso_tpu_torch.kernels.pair_dpd_v3 import (
    LAUNCHES, bucket_forces_pallas_v3, bucket_forces_pallas_v3_edpd,
    bucket_forces_pallas_v3_tdpd, particle_hash_v3, uniform_stream_v3)
from meso_tpu_torch.models.classic import classic_fluid
from meso_tpu_torch.models.polymer import membrane_suspension, polymer_melt
from meso_tpu_torch.models.transport import edpd_slab, tdpd_diffusion
from meso_tpu_torch.models.walls import couette, poiseuille
from meso_tpu_torch.neighbor import bucket_layout
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops.dpd import DPDParams
from meso_tpu_torch.ops.edpd import EDPDParams
from meso_tpu_torch.ops.tdpd import TDPDParams


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for each port test file (every test_torch_*.py
    imports this fixture): the suite runs its files side by side in
    several worker processes, and a torch thread pool as wide as the
    machine in each of them oversubscribes the cores many times over
    (files ran 10-80 times slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parents[1]
MODULES = ["meso_tpu_torch", "meso_tpu_torch.bridge",
           "meso_tpu_torch.core.system", "meso_tpu_torch.core.rng",
           "meso_tpu_torch.kernels.pair_dpd_v3",
           "meso_tpu_torch.kernels._build", "meso_tpu_torch.kernels._brick",
           "meso_tpu_torch.kernels.common",
           "meso_tpu_torch.kernels.pair_dpd_fused",
           "meso_tpu_torch.kernels.pair_dpd",
           "meso_tpu_torch.kernels.pair_multiphysics",
           "meso_tpu_torch.neighbor.bucket_layout",
           "meso_tpu_torch.neighbor.nlist", "meso_tpu_torch.models.classic",
           "meso_tpu_torch.models.transport", "meso_tpu_torch.obs.thermo",
           "meso_tpu_torch.obs.profiles", "meso_tpu_torch.ops.dpd",
           "meso_tpu_torch.ops.edpd", "meso_tpu_torch.ops.tdpd",
           "meso_tpu_torch.ops.fixes", "meso_tpu_torch.ops.bonded",
           "meso_tpu_torch.core.region", "meso_tpu_torch.models.walls",
           "meso_tpu_torch.models.polymer", "meso_tpu_torch.obs.viscosity",
           "meso_tpu_torch.ops.sweep", "meso_tpu_torch.parallel",
           "meso_tpu_torch.parallel.comm", "meso_tpu_torch.parallel.domain",
           "meso_tpu_torch.parallel.launch", "meso_tpu_torch.neighbor.cells",
           "meso_tpu_torch.ops.bucket_dpd", "meso_tpu_torch.probes",
           "meso_tpu_torch.probes.toy_dynroll",
           "meso_tpu_torch.probes.toy_mxu_tile",
           "meso_tpu_torch.probes.toy_tea_roll",
           "meso_tpu_torch.probes.r5a_stage", "meso_tpu_torch.io",
           "meso_tpu_torch.io.deck", "meso_tpu_torch.io.data",
           "meso_tpu_torch.io.dump", "meso_tpu_torch.io.restart",
           "meso_tpu_torch.io.thermo", "meso_tpu_torch.native",
           "meso_tpu_torch.utils", "meso_tpu_torch.utils.autotune",
           "meso_tpu_torch.utils.debug", "meso_tpu_torch.obs",
           "meso_tpu_torch.obs.msd", "meso_tpu_torch.obs.rdf",
           "meso_tpu_torch.obs.stress", "meso_tpu_torch.__main__",
           "meso_tpu_torch.parallel.bricks",
           "meso_tpu_torch.parallel.domain2d",
           "meso_tpu_torch.parallel.domain3d",
           "meso_tpu_torch.parallel.ensemble",
           "meso_tpu_torch.parallel.dryrun"]
# top-level names that the port must never bring in: JAX, the JAX package,
# and the JAX package's probes under tools/ (whether imported as a package
# or by path)
FORBIDDEN = ("jax", "jaxlib", "meso_tpu", "tools", "toy_dynroll",
             "toy_mxu_tile", "toy_tea_roll", "r5a_stage")


def test_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            f"             in {FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_in_sources():
    for path in (REPO / "meso_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in FORBIDDEN, \
                    f"{path}: {line}"


def _meta_case():
    """A small bucket state moved to the meta device: not the CPU, so the
    wrappers must take their kernel path."""
    system, params, state = classic_fluid(
        l=6.0, rng_mode="fast", force_path="pallas", wrap_mode="rebuild",
        rebuild="sort", skin=0.4, rebuild_every=3, device="cpu")
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
    rows = st.tag.to(torch.int64)
    assigned = dict(bucket_layout.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bucket_layout.spill_assign(rows, rows, st.mask, st.n, 5, 16, 25)
    assert bucket_layout.LAUNCHES == assigned
    with pytest.raises(RuntimeError, match="nvcc not found"):
        uniform_stream_v3(st.tag.to(torch.int64), 0)
    n = st.n
    edpd = EDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kappa=1.0, cv=10.0,
                            seed=1).to("meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bucket_forces_pallas_v3_edpd(
            st.x, st.v, torch.ones(n, device="meta"), st.typ, st.tag,
            st.mask, st.box, 1, edpd, 0.01, system.cells)
    tdpd = TDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, kappa_c=[1.0],
                            eps_c=[0.1], rcc=1.0, seed=1).to("meta")
    # the rcc <= rc guard reads the rc table once per params object, which
    # a meta tensor cannot give: seed that cached value
    tdpd.__dict__["rc_max"] = 1.0
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bucket_forces_pallas_v3_tdpd(
            st.x, st.v, torch.ones((n, 1), device="meta"), st.typ, st.tag,
            st.mask, st.box, 1, tdpd, 0.01, system.cells)
    assert LAUNCHES == before


def test_bonds_on_a_non_cpu_tensor_without_nvcc_raise(monkeypatch):
    """The bonded forces on a non-CPU tensor with no kernel library and no
    compiler raise; they never fall back to the plain chain, and count no
    launch."""
    from meso_tpu_torch.ops import bonded
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("CUDA_PATH", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    _build.load_library.cache_clear()
    system, params, state = polymer_melt(l=6.0, n_chains=2, chain_len=5,
                                         force_path="dense", device="cpu")
    meta = bridge.state_from(bridge.state_to_numpy(state), device="meta")
    b = params.bonded
    mb = bonded.BondedParams(bond_tags=b.bond_tags.to("meta"),
                             bond_type=b.bond_type.to("meta"),
                             bond_coeffs=b.bond_coeffs.to("meta"))
    before = dict(bonded.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bonded.bonded_forces(meta.x, meta.tag, meta.mask, meta.box, mb,
                             "fene", system.n_tags)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bonded.bonded_forces_ext(meta.x, meta.tag, meta.mask, meta.box, mb,
                                 "fene", system.n_tags)
    assert bonded.LAUNCHES == before


@pytest.mark.parametrize("builder", [classic_fluid, edpd_slab,
                                     tdpd_diffusion])
def test_entry_points_default_to_the_card(builder):
    """The builders run on the card unless asked for the CPU; with no card
    torch raises and nothing falls back to the CPU."""
    assert inspect.signature(builder).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            builder(l=6.0, force_path="pallas", skin=0.4)


@pytest.mark.parametrize("builder,kw", [
    (poiseuille, dict(lx=6.0, lz=6.0)), (couette, dict(lx=6.0, lz=6.0)),
    (polymer_melt, dict(l=6.0, n_chains=2, chain_len=5)),
    (membrane_suspension, dict(l=8.0, radius=2.0, subdiv=0))],
    ids=["poiseuille", "couette", "polymer_melt", "membrane_suspension"])
def test_wall_and_bonded_builders_default_to_the_card(builder, kw):
    assert inspect.signature(builder).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            builder(force_path="pallas", skin=0.4, **kw)


def test_build_paths_stay_inside_the_checkout():
    assert _build.BUILD_DIR == REPO / "build" / "meso_tpu_torch"
    assert [p.name for p in _build.sources()] == ["bonds.cu",
                                                  "bucket_assign.cu",
                                                  "integrate.cu",
                                                  "pair_brick.cu",
                                                  "pair_dpd_v3.cu",
                                                  "pair_transport_v3.cu",
                                                  "probes.cu"]
    assert [p.name for p in _build.headers()] == ["cell_tiles.cuh",
                                                  "dpd_common.cuh",
                                                  "pair_visitor.cuh"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.LINK_FLAGS


def test_build_hash_covers_headers(monkeypatch, tmp_path):
    """An edited header names another library: a stale build is never
    loaded."""
    for src in _build.sources() + _build.headers():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.library_path("nvcc")
    header = tmp_path / "dpd_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path("nvcc") != before


def _system_case(change):
    """A 648-particle CPU start and a system of ``change`` on it."""
    cfg = CellConfig.for_box([6.0] * 3, 1.0, 3.0, skin=0.4, rebuild_every=3,
                             wrap_at_rebuild=True)
    system = System(rng_mode="fast", force_path="pallas", wrap_mode="rebuild",
                    cells=cfg).replace(**change)
    pair = {"dpd": DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                                   seed=1),
            "edpd": EDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kappa=1.0,
                                     cv=10.0, seed=1),
            "tdpd": TDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                                     kappa_c=[1.0], eps_c=[0.0], rcc=1.0,
                                     seed=1)}[system.model]
    params = SystemParams.build(pair)
    box = Box.cubic(6.0)
    state = create_random(torch.Generator().manual_seed(0), 648, box,
                          n_species=int(system.model == "tdpd"),
                          with_energy=system.model == "edpd")
    return system, params, state


@pytest.mark.parametrize("change,match", [
    (dict(model="edpd", force_path="nlist", wrap_mode="step"),
     "edpd does not support 'nlist'"),
    (dict(model="tdpd", force_path="nlist", wrap_mode="step"),
     "tdpd does not support 'nlist'"),
    (dict(force_path="bucket", cells=CellConfig(
        ncell=(5, 5, 5), capacity=8, spill=True)), "strict buckets"),
])
def test_unported_paths_raise(change, match):
    """The neighbour-list path takes classic DPD only and the sweep strict
    buckets only, as in the JAX package: both raise, naming the reason."""
    system, params, state = _system_case(change)
    with pytest.raises(ValueError, match=match):
        setup(system, params, state)


SELECTORS = {
    "v2-dpd": (dict(pair_kernel="v2"), pair_dpd_fused,
               "bucket_forces_pallas_fused", "pair_fused_dpd"),
    "v2-edpd": (dict(model="edpd", pair_kernel="v2"), pair_dpd_fused,
                "bucket_forces_pallas_edpd_fused", "pair_fused_edpd"),
    "v2-tdpd": (dict(model="tdpd", pair_kernel="v2"), pair_dpd_fused,
                "bucket_forces_pallas_tdpd_fused", "pair_fused_tdpd"),
    "banded-dpd": (dict(force_path="pallas_banded"), pair_dpd,
                   "bucket_forces_pallas", "pair_banded_dpd"),
    "banded-edpd": (dict(model="edpd", force_path="pallas_banded"),
                    pair_multiphysics, "bucket_forces_pallas_edpd",
                    "pair_banded_edpd"),
    "banded-tdpd": (dict(model="tdpd", force_path="pallas_banded"),
                    pair_multiphysics, "bucket_forces_pallas_tdpd",
                    "pair_banded_tdpd"),
}


@pytest.mark.parametrize("selector", list(SELECTORS))
def test_selectors_reach_their_entry_points(monkeypatch, selector):
    """setup and a step of each ported selector call its own entry point
    (the CPU runs its plain version, so the launch count stays 0)."""
    change, module, entry, name = SELECTORS[selector]
    system, params, state = _system_case(change)
    if system.force_path == "pallas_banded":
        system = system.replace(wrap_mode="step", cells=system.cells.replace(
            wrap_at_rebuild=False))
    calls = []
    real = getattr(module, entry)

    def spy(*a, **kw):
        calls.append(entry)
        return real(*a, **kw)

    monkeypatch.setattr(module, entry, spy)
    state = setup(system, params, state)
    state = make_step(system)(params, state)
    assert calls == [entry, entry] and _brick.LAUNCHES[name] == 0
    assert bool(torch.isfinite(state.f).all())


@pytest.mark.parametrize("selector", list(SELECTORS))
def test_selector_wrappers_without_nvcc_raise(monkeypatch, selector):
    """The new entry points on a non-CPU tensor with no kernel library and
    no compiler raise; none falls back to its plain version."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("CUDA_PATH", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    _build.load_library.cache_clear()
    change, module, entry, name = SELECTORS[selector]
    system, _, st = _meta_case()
    cells = system.cells.replace(spill=False, wrap_at_rebuild=False)
    n = st.n
    model = change.get("model", "dpd")
    if model == "dpd":
        pair, field = DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                                      seed=1).to("meta"), ()
    elif model == "edpd":
        pair = EDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kappa=1.0,
                                cv=10.0, seed=1).to("meta")
        field = (torch.ones(n, device="meta"),)
    else:
        pair = TDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                                kappa_c=[1.0], eps_c=[0.1], rcc=1.0,
                                seed=1).to("meta")
        pair.__dict__["rc_max"] = 1.0   # a meta table cannot be read
        field = (torch.ones((n, 1), device="meta"),)
    before = dict(_brick.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(module, entry)(st.x, st.v, *field, st.typ, st.tag, st.mask,
                               st.box, 1, pair, 0.01, cells)
    assert _brick.LAUNCHES == before


def test_wrap_mode_rebuild_needs_bucket_path():
    with pytest.raises(ValueError, match="bucket-resident"):
        make_step(System(force_path="dense", wrap_mode="rebuild"))


def _ring_of_one(model="dpd", spill=True, **change):
    """A 498-particle CPU fluid on one rank's slab (6 x 4 x 4 cells of
    side 1.2): (system, params, slab state, dcfg)."""
    from meso_tpu_torch.parallel import build_domain, distribute_state
    lx, lyz = 7.2, 4.8
    cfg = CellConfig.for_box([lx, lyz, lyz], 1.0, 3.0, skin=0.2,
                             rebuild_every=2, spill=spill)
    system = System(rng_mode="fast", force_path="pallas", model=model,
                    cells=cfg).replace(**change)
    pair = {"dpd": DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                                   seed=1),
            "edpd": EDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kappa=1.0,
                                     cv=10.0, seed=1),
            "tdpd": TDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                                     kappa_c=[1.0], eps_c=[0.0], rcc=1.0,
                                     seed=1)}[model]
    state = create_random(torch.Generator().manual_seed(0), 498,
                          Box.orthorhombic(lx, lyz, lyz),
                          n_species=int(model == "tdpd"),
                          with_energy=model == "edpd")
    dcfg = build_domain(system, 1, lx_global=lx, rebuild_every=2)
    (slab,) = distribute_state(state, dcfg, device="cpu")
    return system, SystemParams.build(pair), slab, dcfg


@pytest.mark.parametrize("overlap,calls", [(True, 3), (False, 1)],
                         ids=["dd_overlap", "one-call"])
def test_dd_overlap_selects_the_border_inner_split(monkeypatch, overlap,
                                                   calls):
    """dd_overlap is no longer ignored: the distributed step makes three K4
    calls (interior, two edges) with it and one without."""
    from meso_tpu_torch.parallel import Ring, run_distributed
    system, params, slab, dcfg = _ring_of_one(dd_overlap=overlap)
    seen = []
    real = pair_dpd_fused.halo_forces_pallas_fused

    def spy(channels, box, step, *a, **kw):
        seen.append(step)
        return real(channels, box, step, *a, **kw)

    monkeypatch.setattr(pair_dpd_fused, "halo_forces_pallas_fused", spy)
    state, diag = run_distributed(system, params, slab, 1, Ring.single(),
                                  dcfg)
    assert seen == [1] * calls + [2] * calls
    assert int(diag["overflow"]) == 0 and state.step == 2


def test_post_forces_skip_bonded():
    """_post_forces takes skip_bonded, as in the JAX package: the
    distributed step adds the bonded terms itself."""
    from meso_tpu_torch.core.system import _post_forces
    system, params, state = polymer_melt(l=6.0, n_chains=2, chain_len=5,
                                         force_path="dense", device="cpu")
    f0 = torch.zeros_like(state.f)
    with_b = _post_forces(system, params, state, state.x, state.v, f0)
    without = _post_forces(system, params, state, state.x, state.v, f0,
                           skip_bonded=True)
    assert bool((with_b != 0).any()) and bool((without == 0).all())
    assert "ignored" not in System.__doc__.split("dd_overlap")[1][:80]


def test_halo_routes_refuse_spill_r7():
    """K6-halo and every banded distributed route take strict buckets only
    (R7), before any exchange."""
    from meso_tpu_torch.parallel import Ring, run_distributed
    for model in ("dpd", "edpd", "tdpd"):
        system, params, slab, dcfg = _ring_of_one(
            model, force_path="pallas_banded")
        with pytest.raises(ValueError, match="R7"):
            run_distributed(system, params, slab, 1, Ring.single(), dcfg)
    planes = {n: torch.zeros((4, 4, 8, 9)) for n in (
        "x", "y", "z", "vx", "vy", "vz", "tag", "valid", "h")}
    cfg = CellConfig(ncell=(5, 4, 4), capacity=8, spill=True)
    pair = DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=1)
    with pytest.raises(ValueError, match="R7"):
        pair_dpd.halo_forces_pallas_1d(planes, Box.cubic(6.0), 1, pair,
                                       0.01, cfg)


@pytest.mark.parametrize("change,match", [
    (dict(s_exp=0.5), "R8"),
    (dict(rc=[[1.0, 0.7], [0.7, 1.0]], n_types=2), "R9")], ids=["R8", "R9"])
def test_distributed_tdpd_refuses_r8_r9(change, match):
    """The distributed tDPD route (K4's model form, which runs s_exp = 1
    whatever the parameters say on the TPU) refuses s_exp != 1 and rcc
    above the smallest rc_ij."""
    from meso_tpu_torch.parallel import Ring, run_distributed
    system, params, slab, dcfg = _ring_of_one("tdpd")
    kw = dict(a=25.0, gamma=4.5, rc=1.0, kt=1.0, kappa_c=[1.0], eps_c=[0.0],
              rcc=0.8, seed=1)
    s_exp = change.pop("s_exp", None)
    pair = TDPDParams.build(**{**kw, **change})
    if s_exp is not None:
        pair = pair.replace(s_exp=s_exp)
    with pytest.raises(ValueError, match=match):
        run_distributed(system, SystemParams.build(pair), slab, 1,
                        Ring.single(), dcfg)


def test_halo_wrappers_without_nvcc_raise(monkeypatch):
    """K4 and K6-halo on non-CPU planes with no kernel library and no
    compiler raise; none falls back to its plain version."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("CUDA_PATH", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    _build.load_library.cache_clear()
    names = ("x", "y", "z", "vx", "vy", "vz", "tag", "valid", "h", "T", "C0")
    planes = {n: torch.zeros((4, 4, 8, 7), device="meta") for n in names}
    cfg = CellConfig(ncell=(5, 4, 4), capacity=8)
    box = Box.cubic(6.0, device="meta")
    pair = DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                           seed=1).to("meta")
    edpd = EDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kappa=1.0, cv=10.0,
                            seed=1).to("meta")
    before = dict(_brick.LAUNCHES)
    calls = [
        lambda: pair_dpd_fused.halo_forces_pallas_fused(planes, box, 1, pair,
                                                        0.01, cfg),
        lambda: pair_dpd_fused.halo_forces_pallas_model_fused(
            planes, box, 1, edpd, 0.01, cfg, model="edpd"),
        lambda: pair_dpd.halo_forces_pallas_1d(planes, box, 1, pair, 0.01,
                                               cfg)]
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert _brick.LAUNCHES == before


def test_distributed_entry_points_default_to_the_card():
    """The brick, ensemble and dry-run entry points place their states on
    the card unless the caller names another device."""
    from meso_tpu_torch.parallel import (distribute_ensemble_spatial,
                                         distribute_state_2d,
                                         distribute_state_3d)
    from meso_tpu_torch.parallel.dryrun import dryrun_multichip
    for fn in (distribute_state_2d, distribute_state_3d,
               distribute_ensemble_spatial, dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
