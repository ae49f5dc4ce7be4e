"""The port's main path as a whole, against the JAX package.

A JAX ``classic_fluid`` state (l=8, spill buckets, sort rebuild every 3
steps, deferred wrap, fast RNG) is carried across by the bridge. One port
chunk (rebuild + 3 steps through ``_bucket_chunk``, the plain pair kernel
on the CPU) is held against the same chunk built from the JAX package's
own pieces, in ``make_step``'s order (meso_tpu/core/system.py:324-377):
``rebuild_buckets``, then per step ``initial_integrate(wrap=False)``, the
dense oracle at the new step, ``final_integrate``. Placement after the
rebuild is bitwise equal; x, v and f after 3 steps agree within the
tolerances below. A longer port-only run checks kT and momentum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.integrate import final_integrate, initial_integrate
from meso_tpu.models.classic import classic_fluid as j_classic_fluid
from meso_tpu.neighbor.bucket_layout import rebuild_buckets as j_rebuild
from meso_tpu.neighbor.bucket_layout import to_bucket_state as j_to_bucket
from meso_tpu.ops.dpd import dense_forces as j_dense
from meso_tpu_torch import bridge
from meso_tpu_torch.core.system import System, _bucket_chunk, \
    run_bucket_chunked
from meso_tpu_torch.models.classic import classic_fluid
from meso_tpu_torch.neighbor.bucket_layout import rebuild_buckets
from meso_tpu_torch.obs import kinetic_temperature, total_momentum
from test_torch_imports import one_torch_thread  # noqa: F401

LAM = 0.65
FLUID = dict(l=8.0, rng_mode="fast", wrap_mode="rebuild", rebuild="sort",
             skin=0.4, rebuild_every=3, spill=True, init_seed=5)


def _jax_start():
    """JAX classic_fluid state in bucket rows. The JAX pallas setup needs
    its interpreted kernel (minutes on a CPU), so the initial forces come
    from the dense oracle; the bucket conversion is JAX's own."""
    jsys, jparams, jst = j_classic_fluid(force_path="dense", **FLUID)
    jsys = jsys.replace(force_path="pallas", lam=LAM)
    return jsys, jparams, j_to_bucket(jst, jsys.cells)


def _port_system(jsys):
    return System(dt=jsys.dt, lam=jsys.lam, rng_mode=jsys.rng_mode,
                  force_path="pallas", pair_kernel="v3",
                  wrap_mode="rebuild",
                  cells=bridge.cell_config_from(jsys.cells))


def _jax_dense_rows(jparams, st, x, v, step):
    m = np.asarray(st.mask)
    idx = np.flatnonzero(m)
    f, _, _ = j_dense(x[idx], v[idx], st.typ[idx], st.tag[idx],
                      st.mask[idx], st.box, step, jparams.pair, 0.01,
                      rng_mode="fast")
    return jnp.zeros_like(x).at[idx].set(f)


def _jax_reference_chunk(jsys, jparams, st):
    st, of = jax.jit(j_rebuild, static_argnames="cfg")(st, jsys.cells)
    placed = st
    inv_m = jparams.inv_mass[:1]
    for _ in range(jsys.cells.rebuild_every):
        move = st.mask
        x1, im1, vt = initial_integrate(st.x, st.v, st.f, st.image, st.box,
                                        jsys.dt, jsys.lam, inv_m, move,
                                        wrap=False)
        new_step = st.step + 1
        f1 = _jax_dense_rows(jparams, st, x1, vt, new_step)
        v1 = final_integrate(st.v, st.f, f1, jsys.dt, inv_m, move)
        st = st.replace(x=x1, v=v1, f=f1, image=im1, step=new_step)
    return placed, int(of), st


def test_one_chunk_matches_jax_step():
    jsys, jparams, jst = _jax_start()
    placed_j, of_j, end_j = _jax_reference_chunk(jsys, jparams, jst)

    tsys = _port_system(jsys)
    tparams = bridge.system_params_from(jparams)
    tst = bridge.state_from(jst)
    placed_t, of_t = rebuild_buckets(tst, tsys.cells)
    assert int(of_t) == of_j == 0
    got = bridge.state_to_numpy(placed_t)
    for name in ("x", "v", "f", "tag", "image", "mask"):
        want = np.asarray(getattr(placed_j, name))
        np.testing.assert_array_equal(got[name].view(np.uint32)
                                      if want.dtype == np.float32
                                      else got[name],
                                      want.view(np.uint32)
                                      if want.dtype == np.float32 else want,
                                      err_msg=name)

    end_t, of_c, disp, _ = _bucket_chunk(tsys, tparams, tst, 3,
                                         thermo_trace=False)
    assert int(of_c) == 0 and end_t.step == int(end_j.step) == 3
    assert float(disp) / (0.5 * tsys.cells.skin) < 1.0
    m = np.asarray(end_j.mask)
    np.testing.assert_array_equal(end_t.tag.numpy(), np.asarray(end_j.tag))
    # the plain kernel and the dense oracle sum in different orders:
    # forces agree to ~1e-5 of their scale, and 3 steps of dt=0.01 carry
    # that into v and x at the 1e-6 level and below
    f_j, f_t = np.asarray(end_j.f)[m], end_t.f.numpy()[m]
    assert np.abs(f_t - f_j).max() / np.abs(f_j).max() < 1e-4
    assert np.abs(end_t.v.numpy()[m] - np.asarray(end_j.v)[m]).max() < 1e-4
    assert np.abs(end_t.x.numpy()[m] - np.asarray(end_j.x)[m]).max() < 1e-5
    assert np.abs(end_t.f.numpy()[~m]).max() == 0.0


def test_long_run_kt_and_momentum():
    """450 port-only steps at l=7 (the spill, deferred-wrap, sort-rebuild
    main path at 1,029 particles): kT averaged over the last 150 steps is
    within 3 sigma of 1 (sigma from the lag-1 autocorrelation, as bench.py
    computes it), and total momentum drifts by less than 1e-4."""
    system, params, state = classic_fluid(
        l=7.0, rng_mode="fast", force_path="pallas", rebuild="sort",
        wrap_mode="rebuild", skin=0.4, rebuild_every=3, init_seed=1,
        device="cpu")
    system = system.replace(lam=LAM)
    mass = params.mass[:1]
    p0 = total_momentum(state.v, mass, state.mask)
    state, diag = run_bucket_chunked(system, params, state, 150, 3)
    assert int(diag["bucket_overflow"]) == 0
    assert float(diag["worst_skin_ratio"]) < 1.0
    assert bool(torch.isfinite(state.x).all() & torch.isfinite(state.v).all())
    kts = diag["kt_trace"].numpy()[300:]
    dk = kts - kts.mean()
    acf1 = float((dk[:-1] * dk[1:]).mean() / max(dk.var(), 1e-30))
    n_eff = max(kts.size / (2 * (1 + acf1) / max(1 - acf1, 1e-3)), 1.0)
    sem = float(kts.std(ddof=1) / np.sqrt(n_eff))
    assert abs(float(kts.mean()) - 1.0) < 3 * sem, (kts.mean(), sem)
    assert float(kinetic_temperature(state.v, mass, state.mask)) == \
        pytest.approx(float(diag["kt_trace"][-1]))
    drift = (total_momentum(state.v, mass, state.mask) - p0).abs().max()
    assert float(drift) < 1e-4


@pytest.mark.slow
def test_matches_jax_run_bucket_chunked_interpret(monkeypatch):
    """End to end against JAX's own run_bucket_chunked, with its Pallas
    kernel interpreted on the CPU (minutes): same start, one chunk."""
    from meso_tpu.core.system import run_bucket_chunked as j_run
    monkeypatch.setenv("MESO_PALLAS_INTERPRET", "1")
    jsys, jparams, jst = _jax_start()
    end_j, diag_j = j_run(jsys, jparams, jst, 1, 3)
    tsys = _port_system(jsys)
    end_t, diag_t = run_bucket_chunked(
        tsys, bridge.system_params_from(jparams), bridge.state_from(jst), 1, 3)
    assert int(diag_t["bucket_overflow"]) == int(diag_j["bucket_overflow"])
    m = np.asarray(end_j.mask)
    np.testing.assert_array_equal(end_t.tag.numpy(), np.asarray(end_j.tag))
    f_j = np.asarray(end_j.f)[m]
    assert np.abs(end_t.f.numpy()[m] - f_j).max() / np.abs(f_j).max() < 1e-4
    assert np.abs(end_t.x.numpy()[m] - np.asarray(end_j.x)[m]).max() < 1e-5
    np.testing.assert_allclose(diag_t["kt_trace"].numpy(),
                               np.asarray(diag_j["kt_trace"]), rtol=1e-5)
    np.testing.assert_allclose(diag_t["virial_trace"].numpy(),
                               np.asarray(diag_j["virial_trace"]), rtol=1e-3)
