"""``utils.debug.validate_forces`` on the JAX package's six validate decks
(tests/unit/test_golden_decks.py:50-73, one per model path), built by the
port's deck loader on the CPU: every force path within 1e-4 of the dense
oracle, the transport fluxes too, and the bonded terms resolved, finite
and free of net momentum, as JAX's test holds them. On the CPU the pallas
paths run their plain versions; chip_smoke.py's cli phase runs the decks
on the kernels."""

from pathlib import Path

import pytest
import torch

from meso_tpu_torch.io.deck import build_from_deck, load_deck
from meso_tpu_torch.utils.debug import validate_forces
from test_torch_imports import one_torch_thread  # noqa: F401

DECKS = Path(__file__).resolve().parent / "golden_decks"
VALIDATE_DECKS = ["classic_fluid", "poiseuille", "edpd_slab",
                  "tdpd_diffusion", "polymer_special", "membrane_suspension"]


@pytest.mark.parametrize("name", VALIDATE_DECKS)
def test_validate_forces_on_deck(name):
    system, params, state, _ = build_from_deck(
        load_deck(str(DECKS / f"{name}.toml")), device="cpu")
    report = validate_forces(system, params, state)
    assert report["max_rel"] < 1e-4, report
    for key in ("dTdt_max_rel", "dCdt_max_rel"):
        if key in report:
            assert report[key] < 1e-4, report
    if system.bond_style is not None:
        assert report["bonded_missing"] == 0
        assert report["bonded_finite"]
        assert report["bonded_momentum_rel"] < 1e-4, report


def test_validate_reports_a_deviating_path(monkeypatch):
    """A force path that is off shows in the report: validate_forces reads
    the path it is given, not the oracle twice."""
    from meso_tpu_torch.core import system as sysmod
    system, params, state, _ = build_from_deck(
        load_deck(str(DECKS / "classic_fluid.toml")), device="cpu")
    real = sysmod.compute_forces

    def off(*a, **kw):
        f, aux = real(*a, **kw)
        return f * 1.01, aux

    monkeypatch.setattr("meso_tpu_torch.utils.debug.compute_forces", off)
    report = validate_forces(system, params, state)
    assert 0.005 < report["max_rel"] < 0.02
    assert torch.isfinite(torch.tensor(report["f_scale"]))
