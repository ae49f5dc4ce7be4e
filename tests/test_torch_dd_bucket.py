"""The port's 1-D domain decomposition with force_path "bucket" (the
27-offset sweep over the x-extended slab, ``parallel.domain._halo_forces``
and ``_halo_forces_model``) on 2 gloo ranks on the CPU, against the port's
single-card bucket path (``run_bucket_fixed``) from the same start, by tag,
within the bounds of tests/test_torch_dd_slice.py (x < 2e-4, v < 2e-3, T
within 2e-4). Cases, on one start of the two ranks: classic DPD in the
fast and TEA tiers, eDPD, and classic DPD with ``FixMomentumZero`` every 5
steps (ROADMAP Queue 3, R12: under the decomposition the fix removes the
drift of the whole box, as on one card). The sweep runs one call over the
extended slab whatever dd_overlap says: the border/inner split rounds
differently (1 ulp in about 2% of the rows), so it is not kept."""

import numpy as np
import pytest
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import create_random
from meso_tpu_torch.core.system import (System, SystemParams,
                                        run_bucket_fixed, setup)
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops.dpd import DPDParams
from meso_tpu_torch.ops.edpd import EDPDParams
from meso_tpu_torch.ops.fixes import FixMomentumZero
from meso_tpu_torch.parallel import (Ring, build_domain, collect_state,
                                     distribute_state, launch)
from meso_tpu_torch.parallel.domain import _halo_forces, _halo_forces_model
from test_torch_imports import one_torch_thread  # noqa: F401


N_DEV, CHUNKS, EVERY = 2, 3, 5
LX, LYZ, RC, SKIN, DENSITY = 7.2, 4.8, 1.0, 0.2, 3.0


def case(model="dpd", rng_mode="fast", fixes=()):
    """(system, params, start after setup) on strict buckets of 6 x 4 x 4
    cells of side 1.2: 3 cell columns per rank."""
    box = Box.orthorhombic(LX, LYZ, LYZ)
    n = int(round(DENSITY * LX * LYZ * LYZ))
    state = create_random(torch.Generator().manual_seed(4), n, box,
                          with_energy=model == "edpd")
    if model == "edpd":
        pair = EDPDParams.build(a=25.0, gamma=4.5, rc=RC, kappa=0.5,
                                cv=100.0, seed=3)
        state = state.replace(
            T=1.0 + 0.2 * torch.sin(2 * np.pi * state.x[:, 0] / LX))
    else:
        pair = DPDParams.build(a=25.0, gamma=4.5, rc=RC, kt=1.0, seed=3)
    cfg = CellConfig.for_box([LX, LYZ, LYZ], RC, DENSITY, skin=SKIN,
                             rebuild_every=EVERY)
    system = System(force_path="bucket", model=model, rng_mode=rng_mode,
                    cells=cfg, fixes=fixes, rc_max=RC)
    params = SystemParams.build(pair)
    return system, params, setup(system, params, state)


CASES = {"classic-fast": {}, "classic-tea": dict(rng_mode="tea"),
         "edpd": dict(model="edpd"),
         "momentum-zero-R12": dict(fixes=(FixMomentumZero(every=5),))}


def by_tag(state):
    mask = state.mask.numpy()
    order = np.argsort(state.tag.numpy()[mask])
    return {f: getattr(state, f).numpy()[mask][order] for f in ("x", "v", "T")
            if getattr(state, f) is not None}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs, wants = [], {}
    for name, kw in CASES.items():
        system, params, state = case(**kw)
        want, diag = run_bucket_fixed(system, params, state, CHUNKS, EVERY)
        assert int(diag["bucket_overflow"]) == 0
        wants[name] = by_tag(want)
        dcfg = build_domain(system, N_DEV, lx_global=LX,
                            rebuild_every=EVERY)
        jobs.append(dict(system=system, params=params,
                         states=distribute_state(state, dcfg, device="cpu"),
                         dcfg=dcfg, nchunks=CHUNKS))
    results = launch.spawn(launch.slab_runs, N_DEV,
                           tmp_path_factory.mktemp("dd_bucket"),
                           args=(jobs,), device="cpu", timeout_s=120.0)
    got = {}
    for j, name in enumerate(CASES):
        ranks = [r[j] for r in results]
        got[name] = ([r["diag"] for r in ranks],
                     collect_state([r["state"] for r in ranks]))
    return wants, got


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_single_card_bucket(runs, name):
    wants, got = runs
    diags, final = got[name]
    want = wants[name]
    assert all(d["overflow"] == 0 for d in diags)
    tags = final.tag.numpy()[final.mask.numpy()]
    assert (np.sort(tags) == np.arange(1, len(want["x"]) + 1)).all()
    have = by_tag(final)
    assert np.abs(have["x"] - want["x"]).max() < 2e-4
    assert np.abs(have["v"] - want["v"]).max() < 2e-3
    if "T" in want:
        assert np.abs(have["T"] - want["T"]).max() < 2e-4


@pytest.mark.parametrize("model", ["dpd", "edpd"])
def test_sweep_takes_one_call_whatever_dd_overlap(monkeypatch, model):
    """One sweep over the x-extended slab (nx + 2 columns) with dd_overlap
    on and off, and the same forces bit for bit."""
    from meso_tpu_torch.ops import sweep as sweepmod
    system, params, state = case(model=model)
    dcfg = build_domain(system, 1, lx_global=LX, rebuild_every=EVERY)
    (slab,) = distribute_state(state, dcfg, device="cpu")
    widths = []
    real = sweepmod.sweep

    def spy(channels, *a, **kw):
        widths.append(channels["x"].shape[-1])
        return real(channels, *a, **kw)

    monkeypatch.setattr(sweepmod, "sweep", spy)
    out = {}
    for overlap in (True, False):
        sysx = system.replace(dd_overlap=overlap)
        if model == "dpd":
            out[overlap] = _halo_forces(slab, sysx, params, dcfg,
                                        Ring.single(), 7, slab.x, slab.v)[0]
        else:
            f, aux = _halo_forces_model(slab, sysx, params, dcfg,
                                        Ring.single(), 7, slab.x, slab.v,
                                        slab.T, None)
            out[overlap] = torch.cat([f, aux["dTdt"][:, None]], dim=1)
    assert widths == [dcfg.ncx_local + 2] * 2
    assert torch.equal(out[True], out[False])
