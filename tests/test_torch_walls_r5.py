"""R5: does the Poiseuille deck's bounce-back hold under the deferred wrap
(``wrap_mode="rebuild"``)? Its fixes are a body force and an end-of-step
bounce-back, so the JAX guard against post_integrate fixes lets it through
(meso_tpu/core/system.py:314-322).

From one port-built deck-size state (``poiseuille()``, 1,800 particles,
two types, spill buckets), ``run_bucket`` advances both modes on the CPU
through the plain K1 general kernel. The wall axis is y and the walls stop
every fluid bead before it reaches the box's y faces, so the deferred wrap
touches x and z only, where the bounce-back does not look.

Over 50 steps positions modulo L and velocities agree, by tag, within the
chunk-test bounds (x 1e-5, v 1e-4; tests/test_torch_slice.py). The two
modes round x + L differently, and the flow is chaotic: those last-bit
differences grow about tenfold every 50 steps, as a one-ulp nudge of a
single bead does in the wrapped run (the slow test). So over a few hundred
steps the check is what bounce-back must guarantee: no fluid bead outside
the channel, the frozen walls unmoved, and the same mean flow."""

import numpy as np
import pytest
import torch

from meso_tpu_torch.core.system import run_bucket
from meso_tpu_torch.models.walls import poiseuille
from test_torch_imports import one_torch_thread  # noqa: F401

W, H = 1.0, 6.0


def _deck():
    system, params, state = poiseuille(force_path="pallas", device="cpu")
    deferred = system.replace(
        wrap_mode="rebuild",
        cells=system.cells.replace(wrap_at_rebuild=True))
    return system, deferred, params, state


def _by_tag(state):
    m = state.mask
    o = torch.argsort(state.tag[m])
    lens = state.box.lengths
    return (torch.remainder(state.x[m][o], lens), state.x[m][o],
            state.v[m][o], state.typ[m][o])


def _gap(a, b):
    """Largest position (modulo L) and velocity difference, by tag."""
    xa, _, va, _ = _by_tag(a)
    xb, _, vb, _ = _by_tag(b)
    lens = a.box.lengths
    dx = xa - xb
    dx = dx - torch.round(dx / lens) * lens
    return float(dx.abs().max()), float((va - vb).abs().max())


def _confined(state, start):
    """Every fluid bead inside the channel [W, H - W], and every wall bead
    where it started, bitwise, modulo L (the deferred wrap's rebuild
    pre-shifts the rows of the last x cell by -L)."""
    xm, x, _, typ = _by_tag(state)
    xm0, _, _, _ = _by_tag(start)
    fluid = typ == 0
    y = x[fluid, 1]
    return (bool(((y >= W) & (y <= H - W)).all())
            and torch.equal(xm[~fluid], xm0[~fluid]))


def test_r5_rebuild_matches_step_over_50_steps():
    step_sys, deferred, params, start = _deck()
    a, da = run_bucket(step_sys, params, start, 50)
    b, db = run_bucket(deferred, params, start, 50)
    assert int(da["bucket_overflow"]) == int(db["bucket_overflow"]) == 0
    assert da["n_rebuilds"] == db["n_rebuilds"] > 0
    dx, dv = _gap(a, b)
    assert dx < 1e-5 and dv < 1e-4, (dx, dv)
    assert _confined(a, start) and _confined(b, start)
    # the deferred run really ran unwrapped between rebuilds
    assert deferred.cells.wrap_at_rebuild and not step_sys.cells.wrap_at_rebuild


@pytest.mark.slow
def test_r5_rebuild_over_300_steps():
    """300 steps: the modes drift apart no faster than a one-ulp nudge of one
    bead drifts from the wrapped run, and bounce-back holds throughout."""
    step_sys, deferred, params, start = _deck()
    x = start.x.clone()
    i = int(torch.nonzero(start.mask & (start.typ == 0))[0])
    x[i, 0] = torch.nextafter(x[i, 0], torch.tensor(np.inf))
    nudged = start.replace(x=x)
    a, b, c = start, start, nudged
    gaps, control = [], []
    for _ in range(6):
        a, _ = run_bucket(step_sys, params, a, 50)
        b, _ = run_bucket(deferred, params, b, 50)
        c, _ = run_bucket(step_sys, params, c, 50)
        assert _confined(a, start) and _confined(b, start)
        gaps.append(_gap(a, b))
        control.append(_gap(a, c))
    # the chaotic growth of a last-bit difference sets both gaps: on the
    # CPU the modes' gap in v stayed 1-9 times the nudge's at every sample
    for (_, dv), (_, cv) in zip(gaps, control):
        assert dv < max(20 * cv, 1e-4), (gaps, control)
    mean_vx = [float(s.v[s.mask & (s.typ == 0), 0].mean()) for s in (a, b)]
    assert abs(mean_vx[0] - mean_vx[1]) < 0.02, mean_vx
