"""The pair term's byte count per valid particle, and that it does not
depend on the layout's rows."""

from __future__ import annotations

import pytest

from roofline import pair, rates, step

N = 1_029_000


def test_bytes_per_valid_particle():
    per_particle = 12 + 12 + 4 + 12
    assert pair.BYTES_PER_PARTICLE == per_particle
    seconds, by, nbytes = pair.bound(N, 12_930_000)
    assert nbytes == N * per_particle
    assert by == "bytes"
    assert seconds == pytest.approx(nbytes / 3.35e12)


def test_same_count_on_spill_and_strict_rows():
    """The two classic cells run 2,000,000 and 3,500,000 bucket rows; the
    bound reads only the valid particles and the in-range pairs."""
    assert pair.bound(N, 12_930_000)[2] == 41_160_000


def test_bytes_bound_picks_the_larger():
    assert rates.bytes_bound(3.35e12, rates.Ops(0, 0))[1] == "bytes"
    t, by = rates.bytes_bound(0, rates.Ops(67e12, 0))
    assert by == "operations" and t == pytest.approx(1.0)
    assert rates.ISSUE_PER_S == pytest.approx(33.5e12)


def test_step_operations():
    assert step.fp32_ops(N, 2 * 1000) == 33 * 1000 + 18 * N
