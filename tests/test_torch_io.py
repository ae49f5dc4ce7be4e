"""The port's I/O against the JAX package's on the same inputs: the deck
loader (every golden deck and a [variables] deck with overrides),
``read_data`` (the inputs of tests/unit/test_read_data.py), restart files
(each package reads the other's, bitwise, member for member), the dumps
(.xyz, .lammpstrj and binary frames of one state, byte for byte) and
``thermo_row`` (within 1e-6). The builds of the golden decks are held
against JAX's in tests/test_torch_decks.py."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.core.box import Box as JBox
from meso_tpu.core.system import System as JSystem
from meso_tpu.core.system import SystemParams as JSystemParams
from meso_tpu.io import data as jdata
from meso_tpu.io import deck as jdeck
from meso_tpu.io import dump as jdump
from meso_tpu.io import restart as jrestart
from meso_tpu.io import thermo as jthermo
from meso_tpu.ops.dpd import DPDParams as JDPDParams
from meso_tpu_torch import bridge
from meso_tpu_torch.io import data as tdata
from meso_tpu_torch.io import deck as tdeck
from meso_tpu_torch.io import dump as tdump
from meso_tpu_torch.io import restart as trestart
from meso_tpu_torch.io import thermo as tthermo
from test_torch_imports import one_torch_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
DECKS = sorted((TESTS / "golden_decks").glob("*.toml"))
_spec = importlib.util.spec_from_file_location(
    "jax_read_data_inputs", TESTS / "unit" / "test_read_data.py")
READ_DATA = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(READ_DATA)


@pytest.mark.parametrize("path", DECKS, ids=[p.stem for p in DECKS])
def test_load_deck_matches_jax(path):
    assert tdeck.load_deck(str(path)) == jdeck.load_deck(str(path))


VARIABLES_DECK = '''
[variables]
L = 6.0
dens = 3.0
tag = "run_${L}"
half = "${L}"

[box]
lengths = ["${L}", "${L}", "${L}"]

[atoms]
density = "${dens}"

[run]
steps = 100
label = "${tag}"
mid = "${half}"
'''


@pytest.mark.parametrize("overrides", [None, {"L": 8.0},
                                       {"L": 7, "tag": "x"}],
                         ids=["none", "L", "L-int-tag"])
def test_variables_and_overrides_match_jax(tmp_path, overrides):
    p = tmp_path / "d.toml"
    p.write_text(VARIABLES_DECK)
    got = tdeck.load_deck(str(p), overrides=overrides)
    assert got == jdeck.load_deck(str(p), overrides=overrides)
    assert got["run"]["mid"] == (overrides or {}).get("L", 6.0)
    (tmp_path / "bad.toml").write_text('[box]\nlengths = ["${nope}", 1]\n')
    with pytest.raises(KeyError):
        tdeck.load_deck(str(tmp_path / "bad.toml"))


def _same_data(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("text", ["LAMMPS_DATA", "ATOMIC_DATA",
                                  "ATOMIC_NOHINT", "ATOMIC_NOVEL"])
def test_read_data_matches_jax(tmp_path, text):
    """The parsed dicts bitwise, and the states' x, typ, tag, mol, image
    (and v, where the file gives velocities) bitwise."""
    body = {"LAMMPS_DATA": READ_DATA.LAMMPS_DATA,
            "ATOMIC_DATA": READ_DATA.ATOMIC_DATA,
            "ATOMIC_NOHINT": READ_DATA.ATOMIC_DATA.replace("Atoms # atomic",
                                                           "Atoms"),
            "ATOMIC_NOVEL": READ_DATA.ATOMIC_DATA.split("Velocities")[0]
            }[text]
    p = tmp_path / "config.data"
    p.write_text(body)
    want = jdata.read_data(str(p))
    got = tdata.read_data(str(p))
    _same_data(got, want)
    jbox, jst = jdata.state_from_data(want, kt_init=1.0)
    tbox, tst = tdata.state_from_data(got, kt_init=1.0, device="cpu")
    assert np.array_equal(tbox.hi.numpy(), np.asarray(jbox.hi))
    names = ["x", "typ", "tag", "mol", "image", "mask"]
    if want["has_velocities"]:
        names.append("v")
    else:   # drawn from each package's own generator, at kT 1
        assert float(torch.abs(tst.v).max()) > 0.0
    for name in names:
        assert np.array_equal(getattr(tst, name).numpy(),
                              np.asarray(getattr(jst, name))), name


def test_read_npz_and_bad_bonds_match_jax(tmp_path):
    """npz input; non-contiguous tags size n_tags from the largest tag;
    a bond naming an unknown tag raises in both packages."""
    rs = np.random.RandomState(2)
    n = 375
    x = rs.uniform(0, 5, (n, 3)).astype(np.float32)
    x[1] = x[0] + 0.4
    tags = np.arange(1, n + 1, dtype=np.int32)
    tags[-1] = 1000
    p = tmp_path / "tags.npz"
    np.savez(p, x=x, box_hi=np.asarray([5.0, 5.0, 5.0]), tag=tags,
             bonds=np.asarray([[1, 1000]], np.int32))
    _same_data(tdata.read_data(str(p)), jdata.read_data(str(p)))
    deck = {
        "atoms": {"create": "read_data", "file": str(p), "kt_init": 1.0},
        "pair": {"dpd": {"a": 25.0, "gamma": 4.5, "rc": 1.0, "kt": 1.0,
                         "seed": 7}},
        "bonds": {"style": "harmonic", "coeffs": [[30.0, 1.0, 0.0, 0.0]]},
        "engine": {"force_path": "dense"},
        "run": {"steps": 1},
    }
    system, params, state, _ = tdeck.build_from_deck(deck, device="cpu")
    assert system.n_tags == 1000 and system.bond_style == "harmonic"
    assert params.bonded.bond_tags.tolist() == [[1, 1000]]
    assert bool(torch.isfinite(state.f).all())
    p2 = tmp_path / "bad.npz"
    np.savez(p2, x=x, box_hi=np.asarray([5.0, 5.0, 5.0]),
             bonds=np.asarray([[1, 9999]], np.int32))
    bad = {**deck, "atoms": {"create": "read_data", "file": str(p2),
                             "kt_init": 1.0}}
    with pytest.raises(ValueError, match="out of range") as te:
        tdeck.build_from_deck(bad, device="cpu")
    with pytest.raises(ValueError, match="out of range") as je:
        jdeck.build_from_deck(bad)
    assert str(te.value) == str(je.value)


def _jax_state(with_energy=False, n_species=0, n=100):
    box = JBox.cubic(5.0)
    st = j_create_random(jax.random.PRNGKey(3), n, box, kt=1.0,
                         with_energy=with_energy, n_species=n_species)
    st = st.replace(step=jnp.int32(777))
    rs = np.random.RandomState(0)
    return st.replace(
        f=jnp.asarray(rs.normal(size=(n, 3)).astype(np.float32)),
        image=jnp.asarray(rs.randint(-3, 4, (n, 3)).astype(np.int32)),
        mol=jnp.asarray(rs.randint(0, 4, n).astype(np.int32)),
        typ=jnp.asarray(rs.randint(0, 2, n).astype(np.int32)),
        mask=jnp.asarray(rs.uniform(size=n) > 0.1))


def _members(path) -> list:
    with np.load(path) as z:
        return [(k, z[k].dtype.str, z[k].shape, z[k].tobytes())
                for k in z.files]


@pytest.mark.parametrize("extra", [{}, {"with_energy": True},
                                   {"n_species": 2}],
                         ids=["classic", "edpd", "tdpd"])
def test_restart_files_cross_bitwise(tmp_path, extra):
    """A file written by JAX loads bitwise in the port and the reverse;
    both packages write the same members (keys in order, dtypes, shapes,
    bytes), the step as a 0-d int32 that loads as a Python int."""
    jst = _jax_state(**extra)
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jrestart.save_restart(a, jst)
    tst = trestart.load_restart(a, device="cpu")
    assert isinstance(tst.step, int) and tst.step == 777
    for name in ("x", "v", "f", "typ", "tag", "image", "mask", "mol", "T",
                 "dTdt", "C", "dCdt"):
        want = getattr(jst, name)
        if want is None:
            assert getattr(tst, name) is None, name
            continue
        got = getattr(tst, name).numpy()
        assert got.dtype == np.asarray(want).dtype, name
        assert np.array_equal(got, np.asarray(want)), name
    trestart.save_restart(b, tst)
    assert _members(b) == _members(a)
    back = jrestart.load_restart(b)
    for name in ("x", "v", "f", "mask", "image"):
        assert np.array_equal(np.asarray(getattr(back, name)),
                              np.asarray(getattr(jst, name)))
    assert int(back.step) == 777


def test_dump_files_are_byte_identical(tmp_path):
    """.xyz (appended twice), .lammpstrj and binary frames of one state,
    written by each package: the same bytes; the port reads its binary
    frames back."""
    jst = _jax_state()
    tst = bridge.state_from(jst, device="cpu")
    for name in ("xyz", "lammpstrj", "bin"):
        a, b = tmp_path / f"jax.{name}", tmp_path / f"port.{name}"
        for append in (False, True):
            jw = {"xyz": jdump.write_xyz, "lammpstrj": jdump.write_lammpstrj,
                  "bin": jdump.write_frame_bin}[name]
            tw = {"xyz": tdump.write_xyz, "lammpstrj": tdump.write_lammpstrj,
                  "bin": tdump.write_frame_bin}[name]
            jw(str(a), jst, append=append)
            tw(str(b), tst, append=append)
        assert b.read_bytes() == a.read_bytes(), name
    frames = tdump.read_frames_bin(str(tmp_path / "port.bin"))
    jframes = jdump.read_frames_bin(str(tmp_path / "jax.bin"))
    assert len(frames) == 2 and frames[0]["step"] == 777
    mask = np.asarray(jst.mask)
    order = np.argsort(np.asarray(jst.tag)[mask])
    assert np.array_equal(frames[1]["x"], np.asarray(jst.x)[mask][order])
    for got, want in zip(frames, jframes):
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_native_codec_is_the_ports_own(monkeypatch, tmp_path):
    """The port builds and loads its own module (never the JAX package's
    ``_mesoio``), and a failed build raises with the compiler's output
    instead of writing through Python."""
    import sys

    from meso_tpu_torch import native
    mod = native.load()
    assert mod.__name__ == "_mesoio_torch"
    assert Path(mod.__file__).parent == native.BUILD_DIR
    assert "_mesoio" not in sys.modules or \
        sys.modules["_mesoio"] is not mod
    src = tmp_path / "mesoio.cpp"
    src.write_text(native.SOURCE.read_text() + "\n#error broken\n")
    monkeypatch.setattr(native, "SOURCE", src)
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="broken"):
            tdump.write_lammpstrj(str(tmp_path / "t.lammpstrj"),
                                  bridge.state_from(_jax_state(n=8),
                                                    device="cpu"))
    finally:
        native.load.cache_clear()
    assert not (tmp_path / "t.lammpstrj").exists()


def test_thermo_row_matches_jax():
    jst = _jax_state()
    pair = JDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=1,
                            n_types=2)
    jpar = JSystemParams.build(pair, mass=[1.0, 2.5])
    jsys = JSystem(dt=0.01)
    want = jthermo.thermo_row(jsys, jpar, jst, virial=jnp.float32(-321.5))
    got = tthermo.thermo_row(bridge.system_from(jsys),
                             bridge.system_params_from(jpar, device="cpu"),
                             bridge.state_from(jst, device="cpu"),
                             virial=torch.tensor(-321.5))
    assert got.keys() == want.keys() and got["step"] == want["step"] == 777
    for k in ("temp", "px", "press"):
        assert abs(got[k] - want[k]) <= 1e-6 * max(abs(want[k]), 1e-3), k


def test_thermo_logger_formats_like_jax(tmp_path):
    """The same columns, formats and JSONL keys (wall_s aside)."""
    import io
    jst = _jax_state()
    pair = JDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=1)
    jpar = JSystemParams.build(pair)
    jsys = JSystem(dt=0.01)
    outs = []
    for mod, sy, pa, st in (
            (jthermo, jsys, jpar, jst),
            (tthermo, bridge.system_from(jsys),
             bridge.system_params_from(jpar, device="cpu"),
             bridge.state_from(jst, device="cpu"))):
        buf = io.StringIO()
        log = mod.ThermoLogger(every=10, stream=buf,
                               jsonl_path=str(tmp_path / f"{mod.__name__}"))
        log.log(sy, pa, st, extra={"rebuilds": 3})
        log.log(sy, pa, st)
        text = buf.getvalue().splitlines()
        outs.append(([ln.split()[:3] for ln in text], [
            sorted(r) for r in log.rows]))
    assert outs[0] == outs[1]
