"""``build_from_deck`` on every golden deck against the JAX package's:
the port's System (through ``bridge.system_from``) and parameters
(through ``bridge.system_params_from``) equal to JAX's, and the same
particle count. JAX's ``setup`` (the first force evaluation, whose compile
costs 2-19 s a deck here) is stubbed for JAX's build: it returns the
state and changes neither the System nor the parameters. The starts
differ (each package draws its own), so states are not compared here;
tests/test_torch_io.py and tests/test_torch_cli.py hold the decks' runs."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import meso_tpu.models.classic
import meso_tpu.models.polymer
import meso_tpu.models.transport
import meso_tpu.models.walls
from meso_tpu.io import deck as jdeck
from meso_tpu_torch import bridge
from meso_tpu_torch.io import deck as tdeck
from test_torch_imports import one_torch_thread  # noqa: F401

DECKS = sorted((Path(__file__).resolve().parent / "golden_decks")
               .glob("*.toml"))


def _same(got, want, where="") -> None:
    """Field by field: tensors equal in dtype, shape and value, the rest
    equal."""
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(got) is type(want), where
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name),
                  f"{where}.{f.name}")
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == want.dtype and torch.equal(got, want), where
    else:
        assert got == want, where


@pytest.fixture
def jax_setup_stubbed(monkeypatch):
    for mod in (jdeck, meso_tpu.models.classic, meso_tpu.models.walls,
                meso_tpu.models.transport, meso_tpu.models.polymer):
        monkeypatch.setattr(mod, "setup", lambda system, params, st: st)


@pytest.mark.parametrize("path", DECKS, ids=[p.stem for p in DECKS])
def test_build_from_deck_matches_jax(path, jax_setup_stubbed):
    deck = jdeck.load_deck(str(path))
    jsys, jpar, jst, jrun = jdeck.build_from_deck(deck)
    tsys, tpar, tst, trun = tdeck.build_from_deck(tdeck.load_deck(str(path)),
                                                  device="cpu")
    assert tsys == bridge.system_from(jsys)
    _same(tpar, bridge.system_params_from(jpar, device="cpu"), "params")
    assert dataclasses.asdict(trun) == dataclasses.asdict(jrun)
    assert int(tst.n_valid()) == int(np.asarray(jst.mask).sum())
    assert tst.device.type == "cpu" and bool(torch.isfinite(tst.f).all())


def test_engine_knobs_accepted_and_tpu_ones_ignored(tmp_path):
    """Every engine knob of the JAX deck loads; the TPU-only ones
    (z_chunks, v3_dynroll) stay on the System and run the same forces as
    the plain v3 settings."""
    text = (Path(DECKS[0]).read_text()
            .replace("[6.0, 6.0, 6.0]", "[8.0, 8.0, 8.0]")
            .replace("[neighbor]\nskin = 0.3",
                     "[neighbor]\nskin = 0.4\nrebuild_every = 3\n\n"
                     "[rng]\nmode = \"fast\"\n\n[engine]\n"
                     "force_path = \"pallas\"\nspill = true\n"
                     "rebuild = \"sort\"\nwrap_mode = \"rebuild\"\n"
                     "pair_kernel = \"v3_dynroll\"\nz_chunks = 2"))
    (tmp_path / "d.toml").write_text(text)
    sys_a, _, st_a, _ = tdeck.build_from_deck(
        tdeck.load_deck(str(tmp_path / "d.toml")), device="cpu")
    assert (sys_a.pair_kernel, sys_a.z_chunks) == ("v3_dynroll", 2)
    assert sys_a.cells.spill and sys_a.cells.rebuild == "sort"
    assert sys_a.wrap_mode == "rebuild" and sys_a.force_path == "pallas"
    (tmp_path / "e.toml").write_text(text.replace("v3_dynroll", "v3")
                                     .replace("z_chunks = 2", "z_chunks = 0"))
    _, _, st_b, _ = tdeck.build_from_deck(
        tdeck.load_deck(str(tmp_path / "e.toml")), device="cpu")
    assert torch.equal(st_a.f, st_b.f) and torch.equal(st_a.x, st_b.x)
