"""The port's last observables and its utils against the JAX package's on
the same inputs: ``obs.msd``, ``obs.rdf`` and ``obs.stress`` on states
carried across with the bridge, ``utils.checks.check_diag``'s messages and
``utils.timer.PhaseTimer``. Gates: msd and rdf within 1e-6 relative (rdf
counts equal but for pairs within 1e-6 of a bin edge); the per-particle
virial and the pressure profile within the kernel gate of 2e-5 relative
(tests/unit/test_pallas_v3.py:40-59) on a fast-tier, one-type system. The
JAX package's stress always takes the fast tier and type 0's coefficients
(R14): with TEA, two types or exclusions the port's virial is held against
its own dense pair forces instead, and the cases it does not cover raise.
``validate_forces`` is in tests/test_torch_validate.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.state import State as JState
from meso_tpu.core.system import System as JSystem
from meso_tpu.core.system import SystemParams as JSystemParams
from meso_tpu.neighbor.cells import CellConfig as JCellConfig
from meso_tpu.obs.msd import msd as j_msd
from meso_tpu.obs.msd import unwrapped as j_unwrapped
from meso_tpu.obs import rdf as jrdf
from meso_tpu.obs import stress as jstress
from meso_tpu.ops.dpd import DPDParams as JDPDParams
from meso_tpu.ops.dpd import build_exclusions as j_build_exclusions
from meso_tpu.utils import checks as jchecks
from meso_tpu_torch import bridge
from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import create_random
from meso_tpu_torch.neighbor.bucket_layout import to_bucket_state
from meso_tpu_torch.obs.msd import diffusion_coefficient, msd, unwrapped
from meso_tpu_torch.obs import rdf as trdf
from meso_tpu_torch.obs import stress as tstress
from meso_tpu_torch.ops import dpd as tdpd
from meso_tpu_torch.utils import checks as tchecks
from meso_tpu_torch.utils.timer import PhaseTimer
from test_torch_imports import one_torch_thread  # noqa: F401

L, N, STEP = 6.0, 630, 12


def _jax_case(rng_mode="fast", two_types=False, excl=False):
    """A bucket state of N particles in an L box on strict cells, as the
    JAX package holds it, with its System and SystemParams. The start and
    its bucket rows come from the port (bitwise JAX's placement,
    tests/test_torch_bucket_layout.py), which spares the file JAX's
    compile of the rebuild."""
    cfg = JCellConfig.for_box([L] * 3, 1.0, 3.0, skin=0.3)
    box = Box.cubic(L)
    st = create_random(torch.Generator().manual_seed(5), N, box, kt=1.0)
    if two_types:
        st = st.replace(typ=(torch.arange(N) % 2).to(torch.int32))
        pair = JDPDParams.build(a=[[25.0, 35.0], [35.0, 40.0]], gamma=4.5,
                                rc=[[1.0, 0.8], [0.8, 1.0]], kt=1.0,
                                seed=77, n_types=2)
    else:
        pair = JDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=77)
    if excl:
        bonds = np.stack([np.arange(1, N), np.arange(2, N + 1)], 1)
        ex, w = j_build_exclusions(bonds, N, weight=0.25)
        pair = pair.replace(excl=ex, excl_w=w)
    st = to_bucket_state(st, bridge.cell_config_from(cfg))
    arrays = bridge.state_to_numpy(st)
    jst = JState(**{f: jnp.asarray(arrays[f]) for f in
                    ("x", "v", "f", "typ", "tag", "image", "mask", "mol")},
                 box=JBox(lo=jnp.asarray(arrays["lo"]),
                          hi=jnp.asarray(arrays["hi"])),
                 step=jnp.int32(STEP))
    system = JSystem(dt=0.01, rng_mode=rng_mode, force_path="bucket",
                     cells=cfg)
    params = JSystemParams.build(pair, mass=[1.0, 2.0] if two_types
                                 else 1.0)
    return system, params, jst


def _carried(system, params, st):
    return (bridge.system_from(system),
            bridge.system_params_from(params, device="cpu"),
            bridge.state_from(st, device="cpu"))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_msd_matches_jax():
    rs = np.random.RandomState(3)
    box = JBox.cubic(L)
    x0 = rs.uniform(0, L, (N, 3)).astype(np.float32)
    img0 = rs.randint(-2, 3, (N, 3)).astype(np.int32)
    x1 = rs.uniform(0, L, (N, 3)).astype(np.float32)
    img1 = img0 + rs.randint(-1, 2, (N, 3)).astype(np.int32)
    mask = rs.uniform(size=N) > 0.1
    tbox = bridge.box_from(box)
    j0u = j_unwrapped(jnp.asarray(x0), jnp.asarray(img0), box)
    t0u = unwrapped(torch.from_numpy(x0), torch.from_numpy(img0), tbox)
    assert np.array_equal(np.asarray(j0u), t0u.numpy())
    want = float(j_msd(jnp.asarray(x1), jnp.asarray(img1), j0u,
                          jnp.asarray(mask), box))
    got = float(msd(torch.from_numpy(x1), torch.from_numpy(img1), t0u,
                         torch.from_numpy(mask), tbox))
    assert abs(got - want) <= 1e-6 * abs(want)
    assert diffusion_coefficient(got, 1.5) == got / 9.0


def test_rdf_matches_jax():
    """g(r) within 1e-6; the pair counts equal, but for pairs within 1e-6
    of a bin edge (a float32 r may fall on either side)."""
    rs = np.random.RandomState(4)
    box = JBox.cubic(L)
    x = rs.uniform(0, L, (N, 3)).astype(np.float32)
    mask = np.ones(N, bool)
    mask[-7:] = False
    r_max, nbins = 2.9, 58
    jc, jg = jrdf(jnp.asarray(x), jnp.asarray(mask), box, r_max, nbins)
    tc, tg = trdf(torch.from_numpy(x), torch.from_numpy(mask),
                  bridge.box_from(box), r_max, nbins)
    assert np.allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=0)
    # the pair counts behind g: g * ideal, with ideal from either package
    n_real = mask.sum()
    edges = np.arange(nbins + 1) * (r_max / nbins)
    ideal = n_real / L ** 3 * 4.0 / 3.0 * np.pi * np.diff(edges ** 3) \
        * n_real
    jn = np.rint(np.asarray(jg, np.float64) * ideal)
    tn = np.rint(tg.numpy().astype(np.float64) * ideal)
    xv = x[mask].astype(np.float64)
    d = xv[:, None] - xv[None]
    d -= np.round(d / L) * L
    r = np.sqrt((d * d).sum(-1))
    near_edge = np.abs(r / (r_max / nbins) - np.rint(r / (r_max / nbins)))
    slack = np.bincount(np.clip(np.rint(r / (r_max / nbins)), 0,
                                nbins).astype(int).ravel()[
        (near_edge.ravel() < 1e-6 * nbins / r_max * 3)], minlength=nbins + 2)
    for b in range(nbins):
        allowed = slack[b] + slack[b + 1]
        assert abs(tn[b] - jn[b]) <= allowed, (b, tn[b], jn[b])
        if tn[b] == jn[b]:
            assert abs(float(tg[b]) - float(jg[b])) <= 1e-6 * abs(
                float(jg[b])) + 1e-12


def test_rdf_blocks_do_not_change_counts(monkeypatch):
    """The row blocks bound memory only: tiny blocks give the same g."""
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.uniform(0, L, (200, 3)).astype(np.float32))
    mask = torch.ones(200, dtype=torch.bool)
    box = bridge.box_from(JBox.cubic(L))
    _, whole = trdf(x, mask, box, 2.5, 25)
    import sys
    monkeypatch.setattr(sys.modules["meso_tpu_torch.obs.rdf"],
                        "_BLOCK_PAIRS", 3 * 200)
    _, blocked = trdf(x, mask, box, 2.5, 25)
    assert torch.equal(whole, blocked)


def test_stress_matches_jax_fast_one_type():
    """per_particle_virial and pressure_profile on a fast-tier, one-type
    system: the case the JAX package computes right."""
    system, params, st = _jax_case()
    jw = jax.jit(jstress.per_particle_virial, static_argnums=0)(
        system, params, st)
    want_w = np.asarray(jw)
    # JAX's profile of that virial (its sweep, run eagerly, costs seconds
    # a call: it is not run twice)
    orig = jstress.per_particle_virial
    jstress.per_particle_virial = lambda *a: jw
    try:
        jcent, jprof = jstress.pressure_profile(system, params, st, 1, 6)
    finally:
        jstress.per_particle_virial = orig
    tsys, tpar, tst = _carried(system, params, st)
    got_w = tstress.per_particle_virial(tsys, tpar, tst)
    assert _rel(got_w.numpy(), want_w) < 2e-5
    assert bool((got_w[~tst.mask] == 0).all())
    tcent, tprof = tstress.pressure_profile(tsys, tpar, tst, 1, 6)
    assert np.allclose(tcent.numpy(), np.asarray(jcent), rtol=1e-6)
    assert _rel(tprof.numpy(), np.asarray(jprof)) < 2e-5


def _dense_virial(system, params, st) -> torch.Tensor:
    """Each row's half-virial summed from the port's dense pair forces
    (over the valid rows; 0 on padding)."""
    pair = params.pair
    rows = torch.nonzero(st.mask).squeeze(1)
    x, v, tag, typ = st.x[rows], st.v[rows], st.tag[rows], st.typ[rows]
    typ = typ.long()
    dr = st.box.min_image(x[:, None, :] - x[None, :, :])
    theta = tdpd._theta_dense(tag, st.step, pair, system.rng_mode,
                              system.rng_rounds)
    valid = ~torch.eye(len(rows), dtype=torch.bool)
    ti, tj = typ[:, None], typ[None, :]
    rc = torch.where(valid, pair.rc[ti, tj], torch.zeros(()))
    _, vir = tdpd.pair_force(dr, v[:, None] - v[None], theta, pair.a[ti, tj],
                             pair.gamma[ti, tj], pair.sigma[ti, tj], rc,
                             1.0 / np.sqrt(system.dt), pair.s_exp)
    if pair.excl is not None:
        vir = vir * tdpd.special_weight(tag[:, None], tag[None, :], pair)
    return torch.zeros(st.n).index_copy_(0, rows, torch.sum(vir, dim=1))


@pytest.mark.parametrize("case", [dict(rng_mode="tea"),
                                  dict(two_types=True),
                                  dict(rng_mode="tea", two_types=True,
                                       excl=True)],
                         ids=["tea", "two-types", "tea-two-types-excl"])
def test_stress_r14_takes_the_systems_tier_and_table(case):
    """R14: TEA, two types and exclusions give the virial of the system
    that runs, held against the port's dense pair forces; the pressure
    profile bins that virial."""
    system, params, st = _jax_case(**case)
    tsys, tpar, tst = _carried(system, params, st)
    got = tstress.per_particle_virial(tsys, tpar, tst)
    want = _dense_virial(tsys, tpar, tst)
    assert _rel(got.numpy(), want.numpy()) < 2e-5
    _, prof = tstress.pressure_profile(tsys, tpar, tst, 0, 4)
    assert bool(torch.isfinite(prof).all())


def test_stress_y_blocks_do_not_change_the_sums(monkeypatch):
    """The sweep over a few cell rows at a time bounds memory only: one
    row a block and the whole grid at once give the same virial."""
    import sys
    system, params, st = _jax_case()
    tsys, tpar, tst = _carried(system, params, st)
    mod = sys.modules["meso_tpu_torch.obs.stress"]
    monkeypatch.setattr(mod, "_Y_BLOCK", 1)
    one = tstress.per_particle_virial(tsys, tpar, tst)
    monkeypatch.setattr(mod, "_Y_BLOCK", 1000)
    assert torch.equal(one, tstress.per_particle_virial(tsys, tpar, tst))


def test_stress_refuses_what_it_does_not_cover():
    """Spill layouts (the sweep walks +-1 cell), other models and states
    off the bucket rows raise ValueError."""
    system, params, st = _jax_case()
    tsys, tpar, tst = _carried(system, params, st)
    spill = tsys.replace(cells=tsys.cells.replace(spill=True))
    with pytest.raises(ValueError, match="strict buckets"):
        tstress.per_particle_virial(spill, tpar, tst)
    with pytest.raises(ValueError, match="classic DPD"):
        tstress.per_particle_virial(tsys.replace(model="edpd"), tpar, tst)
    short = tst.replace(**{f: getattr(tst, f)[:-8] for f in
                           ("x", "v", "f", "typ", "tag", "image", "mask",
                            "mol")})
    with pytest.raises(ValueError, match="bucket rows"):
        tstress.per_particle_virial(tsys, tpar, short)


@pytest.mark.parametrize("diag", [
    {}, {"cell_overflow": 0, "worst_skin_ratio": 0.5},
    {"bucket_overflow": 3}, {"cell_overflow": [0, 2], "nlist_overflow": 1},
    {"overflow": 7, "skin_violation": 1, "worst_skin_ratio": 1.37},
    {"worst_skin_ratio": [0.4, 2.0]}], ids=lambda d: "-".join(d) or "clean")
def test_check_diag_messages_match_jax(diag):
    def run(fn, conv):
        try:
            fn({k: conv(v) for k, v in diag.items()}, context="chunk 3")
        except RuntimeError as e:
            return str(e)
        return None
    want = run(jchecks.check_diag, jnp.asarray)
    assert run(tchecks.check_diag, torch.as_tensor) == want
    assert run(tchecks.check_diag, lambda v: v) == want


def test_phase_timer_syncs_at_each_boundary():
    calls = []
    timer = PhaseTimer(sync=lambda: calls.append(1))
    timer.begin("run")
    timer.begin("output")
    text = timer.summary()
    assert len(calls) >= 4
    assert text.splitlines()[0].split() == ["Phase", "time", "(s)", "%",
                                            "calls"]
    assert {ln.split()[0] for ln in text.splitlines()[1:]} == {
        "run", "output", "total"}
