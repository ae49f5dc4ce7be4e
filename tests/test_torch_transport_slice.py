"""The port's eDPD and tDPD paths as a whole, against the JAX package.

JAX ``edpd_slab(l=8)`` (the deck's kappa 2, cv 30, t_hot 1.3, t_cold 0.7)
and ``tdpd_diffusion(l=8, eps_c=0.3)`` states are put into spill bucket rows
with JAX's own ``CellConfig.for_box``/``to_bucket_state`` and carried
across by the bridge. One port chunk (rebuild + 3 steps through
``_bucket_chunk`` with force_path "pallas", the plain kernels on the CPU) is
held against the same chunk built from the JAX package's pieces in
``make_step``'s order (meso_tpu/core/system.py:324-377): rebuild,
initial_integrate, the dense oracle at the new step, final_integrate, the T
or C update, the end-of-step fixes. Placement after the rebuild is bitwise
equal, T, dT/dt, C and dC/dt included. Two port-only runs check the
conservation laws: sum C under the random flux, and KE + cv sum T + PE of a
free eDPD fluid. FixSourceC, the field profiles and the potential energy
are held against JAX's on one small state."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.integrate import final_integrate, initial_integrate
from meso_tpu.models.transport import edpd_slab as j_edpd_slab
from meso_tpu.models.transport import tdpd_diffusion as j_tdpd_diffusion
from meso_tpu.neighbor.bucket_layout import rebuild_buckets as j_rebuild
from meso_tpu.neighbor.bucket_layout import to_bucket_state as j_to_bucket
from meso_tpu.neighbor.cells import CellConfig as JCellConfig
from meso_tpu.ops.edpd import dense_forces_edpd as j_dense_edpd
from meso_tpu.ops.tdpd import dense_forces_tdpd as j_dense_tdpd
from meso_tpu_torch import bridge
from meso_tpu_torch.core.system import System, _bucket_chunk, \
    run_bucket_chunked
from meso_tpu_torch.models.transport import (FixRegionT, edpd_slab,
                                             tdpd_diffusion)
from meso_tpu_torch.neighbor.bucket_layout import rebuild_buckets
from meso_tpu_torch.obs import kinetic_energy, potential_energy_dense
from test_torch_imports import one_torch_thread  # noqa: F401

EDPD_DECK = dict(l=8.0, kappa=2.0, cv=30.0, t_hot=1.3, t_cold=0.7)
TDPD_DECK = dict(l=8.0, eps_c=0.3)
STEPS = 3
FIELD = {"edpd": ("T", "dTdt"), "tdpd": ("C", "dCdt")}


def _jax_start(model):
    """JAX state in spill bucket rows, its forces from the dense setup (the
    JAX Pallas path needs its interpreted kernel, minutes on a CPU)."""
    if model == "edpd":
        jsys, jparams, jst = j_edpd_slab(force_path="dense", **EDPD_DECK)
    else:
        jsys, jparams, jst = j_tdpd_diffusion(force_path="dense", **TDPD_DECK)
    cfg = JCellConfig.for_box([8.0] * 3, rc=1.0, density=3.0, skin=0.3,
                              rebuild_every=STEPS, spill=True, rebuild="sort")
    return jsys.replace(force_path="pallas", cells=cfg), jparams, \
        j_to_bucket(jst, cfg)


def _jax_step(model, jsys, jparams, idx, st):
    """One JAX step in make_step's order, the dense oracle over the valid
    rows ``idx`` (fixed between rebuilds)."""
    inv_m = jparams.inv_mass[:1]
    name, dname = FIELD[model]
    move = st.mask
    x1, im1, vt = initial_integrate(st.x, st.v, st.f, st.image, st.box,
                                    jsys.dt, jsys.lam, inv_m, move, wrap=True)
    new_step = st.step + 1
    fn = j_dense_edpd if model == "edpd" else j_dense_tdpd
    fld = getattr(st, name)
    f, q, _ = fn(x1[idx], vt[idx], fld[idx], st.typ[idx], st.tag[idx],
                 st.mask[idx], st.box, new_step, jparams.pair, 0.01,
                 rng_mode="fast")
    f1 = jnp.zeros_like(x1).at[idx].set(f)
    q1 = jnp.zeros_like(fld).at[idx].set(q)
    v1 = final_integrate(st.v, st.f, f1, jsys.dt, inv_m, move)
    mv = move if model == "edpd" else move[:, None]
    st = st.replace(x=x1, v=v1, f=f1, image=im1, step=new_step,
                    **{name: fld + jsys.dt * jnp.where(mv, q1, 0.0),
                       dname: q1})
    for fx in jsys.fixes:
        st = fx.end_of_step(jsys, jparams, st)
    return st


def _jax_reference_chunk(model, jsys, jparams, st):
    st, of = jax.jit(j_rebuild, static_argnames="cfg")(st, jsys.cells)
    placed = st
    idx = np.flatnonzero(np.asarray(st.mask))
    step = jax.jit(functools.partial(_jax_step, model, jsys, jparams, idx))
    for _ in range(STEPS):
        st = step(st)
    return placed, int(of), st


def _port_system(model, jsys):
    fixes = tuple(FixRegionT(**{k: getattr(fx, k) for k in (
        "axis", "hot_lo", "hot_hi", "cold_lo", "cold_hi", "t_hot",
        "t_cold")}) for fx in jsys.fixes)
    return System(dt=jsys.dt, lam=jsys.lam, rng_mode=jsys.rng_mode,
                  model=model, force_path="pallas", pair_kernel="v3",
                  fixes=fixes, cells=bridge.cell_config_from(jsys.cells))


def _bits(a):
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("model", ["edpd", "tdpd"])
def test_one_chunk_matches_jax_step(model):
    jsys, jparams, jst = _jax_start(model)
    placed_j, of_j, end_j = _jax_reference_chunk(model, jsys, jparams, jst)

    tsys = _port_system(model, jsys)
    tparams = bridge.system_params_from(jparams)
    tst = bridge.state_from(jst)
    placed_t, of_t = rebuild_buckets(tst, tsys.cells)
    assert int(of_t) == of_j == 0
    got = bridge.state_to_numpy(placed_t)
    for name in ("x", "v", "f", "tag", "image", "mask") + FIELD[model]:
        np.testing.assert_array_equal(
            _bits(got[name]), _bits(np.asarray(getattr(placed_j, name))),
            err_msg=name)

    end_t, of_c, disp, _ = _bucket_chunk(tsys, tparams, tst, STEPS,
                                         thermo_trace=False)
    assert int(of_c) == 0 and end_t.step == int(end_j.step) == STEPS
    assert float(disp) / (0.5 * tsys.cells.skin) < 1.0
    m = np.asarray(end_j.mask)
    np.testing.assert_array_equal(end_t.tag.numpy(), np.asarray(end_j.tag))
    # the plain kernel and the dense oracle sum in different orders: forces
    # and fluxes agree to ~1e-6 of their scale, which 3 steps of dt=0.01
    # carry into v, x, T and C at the 1e-6 level and below
    f_j, f_t = np.asarray(end_j.f)[m], end_t.f.numpy()[m]
    assert np.abs(f_t - f_j).max() / np.abs(f_j).max() < 1e-4
    assert np.abs(end_t.v.numpy()[m] - np.asarray(end_j.v)[m]).max() < 1e-4
    assert np.abs(end_t.x.numpy()[m] - np.asarray(end_j.x)[m]).max() < 1e-5
    name, dname = FIELD[model]
    q_j = np.asarray(getattr(end_j, dname))[m]
    q_t = getattr(end_t, dname).numpy()[m]
    assert np.abs(q_t - q_j).max() / np.abs(q_j).max() < 1e-4
    fld_j = np.asarray(getattr(end_j, name))[m]
    assert np.abs(getattr(end_t, name).numpy()[m] - fld_j).max() < 1e-5
    for t in (end_t.f, getattr(end_t, name), getattr(end_t, dname)):
        assert np.abs(t.numpy()[~m]).max() == 0.0


def test_tdpd_random_flux_conserves_sum_c():
    """About 150 port-only steps of tDPD with a random flux (l=6, eps_c
    0.3): the relative drift of sum C stays below 1e-4."""
    system, params, state = tdpd_diffusion(l=6.0, eps_c=0.3,
                                           force_path="pallas", skin=0.4,
                                           device="cpu")
    c0 = float(torch.sum(state.C[state.mask]))
    state, diag = run_bucket_chunked(system, params, state, 50, 3,
                                     thermo_trace=False)
    assert int(diag["bucket_overflow"]) == 0
    c1 = float(torch.sum(state.C[state.mask]))
    assert abs(c1 - c0) / abs(c0) < 1e-4, (c0, c1)
    assert bool(torch.isfinite(state.C).all())


def test_free_edpd_fluid_conserves_energy():
    """About 150 port-only steps of a free eDPD fluid (l=5, cv 20, kappa
    0.5, no slabs): KE + cv sum T + PE drifts by less than 1%, as in the
    JAX physics test (tests/physics/test_transport.py:14-37)."""
    system, params, state = edpd_slab(l=5.0, cv=20.0, kappa=0.5,
                                      force_path="pallas", skin=0.4,
                                      device="cpu")
    system = system.replace(fixes=())
    pair = params.pair

    def total_e(s):
        m = s.mask
        return float(kinetic_energy(s.v, params.mass[:1], m)
                     + pair.cv * torch.sum(s.T[m])
                     + potential_energy_dense(s.x[m], s.typ[m], s.mask[m],
                                              s.box, pair.a, pair.rc))

    e0 = total_e(state)
    state, diag = run_bucket_chunked(system, params, state, 50, 3,
                                     thermo_trace=False)
    e1 = total_e(state)
    assert int(diag["bucket_overflow"]) == 0
    assert abs(e1 - e0) / abs(e0) < 0.01, (e0, e1)
    t = state.T[state.mask]
    assert bool(torch.isfinite(t).all()) and float(t.min()) > 0.3 \
        and float(t.max()) < 3.0


def test_fit_capacity_places_a_crowded_start():
    """A start with 45 rows packed into one cell overflows the capacity
    sized from the density; fit_capacity raises K just far enough, and
    setup then keeps every particle. With 200 rows there, no K up to 8
    slots more fits: the system comes back unchanged and setup raises
    naming K."""
    from meso_tpu_torch.core.box import Box
    from meso_tpu_torch.core.state import create_random
    from meso_tpu_torch.core.system import fit_capacity, setup
    system, params, _ = tdpd_diffusion(l=8.0, force_path="pallas", skin=0.4,
                                       device="cpu")
    gen = torch.Generator().manual_seed(1)
    st = create_random(gen, 1536, Box.cubic(8.0), n_species=1)
    x = st.x.clone()
    x[:45] = 3.3 + 0.2 * torch.rand((45, 3), generator=gen)
    st = st.replace(x=x, C=torch.ones((1536, 1)))
    k0 = system.cells.capacity
    fitted = fit_capacity(system, st)
    k = fitted.cells.capacity
    assert k0 < k <= k0 + 8
    assert int(rebuild_buckets(st, system.cells.replace(capacity=k - 1))[1])
    placed = setup(fitted, params, st)
    assert int(placed.n_valid()) == 1536
    x = x.clone()
    x[:200] = 3.3 + 0.2 * torch.rand((200, 3), generator=gen)
    crowded = st.replace(x=x)
    assert fit_capacity(system, crowded) is system
    with pytest.raises(ValueError, match=f"K={k0} overflowed"):
        setup(system, params, crowded)
    # the uniform start keeps the K sized from the density
    assert fit_capacity(system, st.replace(x=st.x.clone().index_copy_(
        0, torch.arange(45), 8.0 * torch.rand((45, 3), generator=gen)))
    ).cells.capacity == k0


@functools.lru_cache(maxsize=None)
def _small_jax_state():
    """375 rows at l=5 from a numpy seed, two types, 15 pad rows, T and two
    C species, as a JAX State."""
    from meso_tpu.core.box import Box as JBox
    from meso_tpu.core.state import zeros_state as j_zeros_state
    rng = np.random.default_rng(2)
    n = 375
    x = rng.uniform(0.0, 5.0, (n, 3)).astype(np.float32)
    tag = np.arange(1, n + 1, dtype=np.int32)
    t = (1.0 + 0.3 * np.sin(x[:, 0])).astype(np.float32)
    c = np.stack([1.0 + 0.5 * np.cos(x[:, 0]),
                  0.5 + 0.2 * np.sin(x[:, 1])], -1).astype(np.float32)
    st = j_zeros_state(n, JBox.cubic(5.0), n_species=2, with_energy=True)
    return st.replace(x=jnp.asarray(x), tag=jnp.asarray(tag),
                      typ=jnp.asarray(tag % 2), mask=jnp.asarray(tag < 361),
                      T=jnp.asarray(t), C=jnp.asarray(c))


def test_fix_source_c_matches_jax():
    """FixSourceC on mobile particles inside its slab, frozen types
    excluded, against JAX's on the same state."""
    from meso_tpu.core.system import System as JSystem
    from meso_tpu.ops.fixes import FixSourceC as JFixSourceC
    from meso_tpu_torch.ops.fixes import FixSourceC
    jst = _small_jax_state()
    kw = dict(source=(0.1, 0.2), rate=(0.05, 0.3), axis=0, lo=1.0, hi=3.5)
    want = jax.jit(lambda st: JFixSourceC(**kw).end_of_step(
        JSystem(dt=0.01, frozen_types=(1,)), None, st))(jst)
    got = FixSourceC(**kw).end_of_step(
        System(dt=0.01, frozen_types=(1,)), None, bridge.state_from(jst))
    np.testing.assert_allclose(got.C.numpy(), np.asarray(want.C),
                               rtol=0, atol=1e-7)
    assert not np.array_equal(np.asarray(want.C), np.asarray(jst.C))


def test_profiles_and_potential_energy_match_jax():
    from meso_tpu.obs.profiles import field_profile as j_field_profile
    from meso_tpu.obs.thermo import potential_energy_dense as j_pe
    from meso_tpu_torch.obs.profiles import field_profile
    jst = _small_jax_state()
    tst = bridge.state_from(jst)
    for fld in ("T", "C"):
        jf = getattr(jst, fld)
        tf = getattr(tst, fld)
        jc, jm, jn = jax.jit(lambda st, w: j_field_profile(
            st, w, axis=0, nbins=7, typ=1))(
                jst, jf if jf.ndim > 1 else jf[:, None])
        tc, tm, tn = field_profile(tst, tf if tf.ndim > 1 else tf[:, None],
                                   axis=0, nbins=7, typ=1)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    a = jnp.asarray([[25.0, 35.0], [35.0, 18.0]], jnp.float32)
    rc = jnp.asarray([[1.0, 0.9], [0.9, 1.1]], jnp.float32)
    want = float(jax.jit(j_pe)(jst.x, jst.typ, jst.mask, jst.box, a, rc))
    got = float(potential_energy_dense(
        tst.x, tst.typ, tst.mask, tst.box, torch.from_numpy(np.array(a)),
        torch.from_numpy(np.array(rc))))
    assert got == pytest.approx(want, rel=1e-5)
