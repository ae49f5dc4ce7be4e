"""The decay rate of the tDPD cosine mode: the JAX package's dense path
against chip_smoke.py's reference, and the port from the same start.

chip_smoke.py's transport-physics phase holds the decay rate of
``tdpd_diffusion(l=8, kappa_c=2)`` on the card against
``TDPD_DECAY_RATE_JAX``. This test derives that number: the JAX dense path
(``run_adaptive``, as tests/physics/test_transport.py runs it) from JAX
init_seeds 0-11, each rate fitted by chip_smoke's own ``decay_fit`` on the
mean-subtracted amplitude. It also carries one of those starts across by
the bridge and runs the port's bucket path from it (the plain kernels on
the CPU, advanced as chip_smoke advances the card): the two rates agree
within 2%. It writes the JAX starts and their rates to
build/tdpd_decay_jax_starts.npz, which
``python3 chip_smoke.py --decay-from build/tdpd_decay_jax_starts.npz``
runs on the card from the same starts. About three minutes on a CPU, hence
``slow``."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
from test_torch_imports import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JAX_SEEDS = range(12)
SAME_START_SEED = 4
STARTS_FILE = ROOT / "build" / "tdpd_decay_jax_starts.npz"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_tdpd_decay_rate_reference_and_port_from_the_same_start():
    from meso_tpu.core.system import run_adaptive
    from meso_tpu.models.transport import tdpd_diffusion as j_tdpd_diffusion
    from meso_tpu_torch import bridge
    from meso_tpu_torch.core.system import fit_capacity, setup
    from meso_tpu_torch.models.transport import tdpd_diffusion
    cs = _chip_smoke()
    cs.DEVICE = "cpu"

    def amplitudes(x, c):
        return cs.mode_amplitudes(np.asarray(x)[:, 0],
                                  np.asarray(c, np.float64)[:, 0], 8.0)

    rates = {}
    starts = {}
    for init_seed in JAX_SEEDS:
        jsys, jparams, jst = j_tdpd_diffusion(l=8.0, kappa_c=2.0, eps_c=0.0,
                                              init_seed=init_seed)
        m = np.asarray(jst.mask)
        start = jst
        amps = [amplitudes(np.asarray(jst.x)[m], np.asarray(jst.C)[m])]
        for _ in range(6):
            jst, _ = run_adaptive(jsys, jparams, jst, 100)
            amps.append(amplitudes(np.asarray(jst.x)[m],
                                   np.asarray(jst.C)[m]))
        amps, amps_jax = zip(*amps)
        ok, rates[init_seed], _ = cs.decay_fit(amps)
        assert ok, (init_seed, amps)
        # the JAX test's own estimator, whose verdict chip_smoke reports
        starts[f"{init_seed}/jax_estimator_passes"] = np.bool_(
            cs.decay_fit(amps_jax)[0])
        for name, a in bridge.state_to_numpy(
                bridge.state_from(start)).items():
            starts[f"{init_seed}/{name}"] = a
        starts[f"{init_seed}/rate"] = np.float64(rates[init_seed])
        if init_seed == SAME_START_SEED:
            system, params, _ = tdpd_diffusion(
                l=8.0, kappa_c=2.0, eps_c=0.0, force_path="pallas",
                skin=cs.SKIN, device="cpu")
            st = bridge.state_from(start)
            system = fit_capacity(system, st)
            st = setup(system, params, st)
            port_amps = [amplitudes(st.x[st.mask], st.C[st.mask])[0]]
            for _ in range(6):
                st, diags = cs.advance(system, params, st, 100)
                assert max(int(d["bucket_overflow"]) for d in diags) == 0
                port_amps.append(amplitudes(st.x[st.mask],
                                            st.C[st.mask])[0])
            port_ok, port_rate, _ = cs.decay_fit(port_amps)
    STARTS_FILE.parent.mkdir(exist_ok=True)
    np.savez(STARTS_FILE, **starts)
    assert port_ok, port_amps
    assert abs(port_rate / rates[SAME_START_SEED] - 1.0) < 0.02, \
        (port_rate, rates[SAME_START_SEED])
    r = np.asarray(list(rates.values()))
    ref = cs.TDPD_DECAY_RATE_JAX
    assert abs(r.mean() / ref - 1.0) < 0.005, (r.mean(), ref)
    assert abs(r / ref - 1.0).max() < cs.TDPD_DECAY_RATE_TOL, rates
