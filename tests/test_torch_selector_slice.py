"""The fused selector (``pair_kernel="v2"``, K5) as a whole, against the
JAX package's own chunk on the same selector.

For each model a JAX builder state (classic_fluid, edpd_slab,
tdpd_diffusion at l=6.5, spill buckets, forces from the dense set-up) is
carried across by the bridge, and one chunk of ``run_bucket_chunked``
(rebuild + 2 steps) runs in both packages: JAX's own
``run_bucket_chunked`` with its Pallas kernel interpreted on the CPU
(``MESO_PALLAS_INTERPRET=1``), the port's with the plain version of its
kernel. The classic case runs the deferred wrap (``wrap_mode="rebuild"``)
over spill buckets, the main path's layout. The banded selector's chunk is
tests/test_torch_selector_slice_banded.py.

Bounds are those of the port's slice tests (tests/test_torch_slice.py,
tests/test_torch_transport_slice.py): tags bitwise after the chunk, forces
and dT/dt or dC/dt within 1e-4 of their scale, v within 1e-4, x within
1e-5, T or C within 1e-5, pad rows exactly 0, overflow 0 in both."""

import numpy as np
import pytest

from meso_tpu.core.system import run_bucket_chunked as j_run
from meso_tpu.models.classic import classic_fluid as j_classic
from meso_tpu.models.transport import edpd_slab as j_edpd_slab
from meso_tpu.models.transport import tdpd_diffusion as j_tdpd_diffusion
from meso_tpu.neighbor.bucket_layout import to_bucket_state as j_to_bucket
from meso_tpu.neighbor.cells import CellConfig as JCellConfig
from meso_tpu_torch import bridge
from meso_tpu_torch.core.system import run_bucket_chunked
from test_torch_imports import one_torch_thread  # noqa: F401

L, SKIN, EVERY = 6.5, 0.4, 2
FIELD = {"dpd": (), "edpd": ("T", "dTdt"), "tdpd": ("C", "dCdt")}


def jax_start(model, force_path, pair_kernel, l=L, spill=True):
    """A JAX builder state with dense set-up forces, put into the
    selector's bucket rows (spill or strict), and the JAX system of the
    selector."""
    if model == "dpd":
        jsys, jp, jst = j_classic(l=l, rng_mode="fast", force_path="dense",
                                  skin=SKIN, rebuild_every=EVERY)
    elif model == "edpd":
        jsys, jp, jst = j_edpd_slab(l=l, kappa=2.0, cv=30.0, t_hot=1.3,
                                    t_cold=0.7, force_path="dense", skin=SKIN)
    else:
        jsys, jp, jst = j_tdpd_diffusion(l=l, eps_c=0.3, force_path="dense",
                                         skin=SKIN)
    deferred = model == "dpd" and spill
    cfg = JCellConfig.for_box([l] * 3, rc=1.0, density=3.0, skin=SKIN,
                              rebuild_every=EVERY, spill=spill,
                              rebuild="sort", wrap_at_rebuild=deferred)
    jsys = jsys.replace(force_path=force_path, pair_kernel=pair_kernel,
                        cells=cfg,
                        wrap_mode="rebuild" if deferred else "step")
    return jsys, jp, j_to_bucket(jst, cfg)


def check_chunk(model, jsys, jp, jst):
    """One chunk in both packages from the same start; the comparisons of
    the module docstring."""
    end_j, diag_j = j_run(jsys, jp, jst, 1, EVERY, thermo_trace=False)
    end_t, diag_t = run_bucket_chunked(
        bridge.system_from(jsys), bridge.system_params_from(jp),
        bridge.state_from(jst), 1, EVERY, thermo_trace=False)
    assert int(diag_t["bucket_overflow"]) == int(diag_j["bucket_overflow"])
    assert int(diag_j["bucket_overflow"]) == 0
    m = np.asarray(end_j.mask)
    np.testing.assert_array_equal(end_t.tag.numpy(), np.asarray(end_j.tag))
    f_j = np.asarray(end_j.f)[m]
    assert np.abs(end_t.f.numpy()[m] - f_j).max() / np.abs(f_j).max() < 1e-4
    assert np.abs(end_t.v.numpy()[m] - np.asarray(end_j.v)[m]).max() < 1e-4
    assert np.abs(end_t.x.numpy()[m] - np.asarray(end_j.x)[m]).max() < 1e-5
    assert np.abs(end_t.f.numpy()[~m]).max() == 0.0
    if FIELD[model]:
        name, dname = FIELD[model]
        q_j = np.asarray(getattr(end_j, dname))[m]
        q_t = getattr(end_t, dname).numpy()[m]
        assert np.abs(q_t - q_j).max() / np.abs(q_j).max() < 1e-4
        fld_j = np.asarray(getattr(end_j, name))[m]
        assert np.abs(getattr(end_t, name).numpy()[m] - fld_j).max() < 1e-5
        assert np.abs(getattr(end_t, dname).numpy()[~m]).max() == 0.0


@pytest.mark.parametrize("model", ["dpd", "edpd", "tdpd"])
def test_v2_chunk_matches_jax(monkeypatch, model):
    monkeypatch.setenv("MESO_PALLAS_INTERPRET", "1")
    check_chunk(model, *jax_start(model, "pallas", "v2"))
