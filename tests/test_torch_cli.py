"""``python -m meso_tpu_torch deck.toml``: the port's CLI, run in-process
through ``__main__.main`` on the CPU (``--device cpu``). It prints thermo
rows and writes the JSONL log, the dump and the restart; a run saved,
loaded and continued is bitwise the run without a stop, as
tests/unit/test_io.py:40 holds JAX's; ``--dd 2`` runs a small bonded deck
on two gloo ranks; ``--profile`` writes a trace; ``--validate`` reports;
the autotuner refuses an empty pool; and with no card and no ``--device
cpu`` torch raises instead of running on the CPU."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from meso_tpu_torch.__main__ import main
from meso_tpu_torch.core.system import run_adaptive, run_bucket_chunked
from meso_tpu_torch.io.deck import build_from_deck, load_deck
from meso_tpu_torch.io.dump import read_frames_bin
from meso_tpu_torch.io.restart import load_restart, save_restart
from meso_tpu_torch.utils.autotune import autotune_fluid
from test_torch_imports import one_torch_thread  # noqa: F401

DECKS = Path(__file__).resolve().parent / "golden_decks"
CLASSIC = DECKS / "classic_fluid.toml"


def _deck_copy(tmp_path, src=CLASSIC, run="", replace=()):
    """The deck at ``src`` with its [run] table replaced by ``run`` (and
    text replacements), written into tmp_path."""
    text = src.read_text()
    for old, new in replace:
        text = text.replace(old, new)
    if run:
        text = text.split("[run]")[0] + "[run]\n" + run
    p = tmp_path / src.name
    p.write_text(text)
    return str(p)


def test_cli_runs_deck_and_writes_outputs(tmp_path, capsys):
    deck = _deck_copy(tmp_path, run=(
        f'steps = 300\nthermo_every = 10\ndump_every = 20\n'
        f'dump_path = "{tmp_path / "t.lammpstrj"}"\nrestart_every = 30\n'
        f'restart_path = "{tmp_path / "r.npz"}"\n'))
    log = tmp_path / "t.jsonl"
    code = main([deck, "--steps", "30", "--device", "cpu", "--log",
                 str(log)])
    out = capsys.readouterr().out
    assert code == 0
    lines = out.splitlines()
    assert lines[0].split() == ["step", "temp", "px", "wall_s"]
    assert [int(ln.split()[0]) for ln in lines[1:5]] == [0, 10, 20, 30]
    assert "Phase" in out and "run" in out and "total" in out
    rows = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 10, 20, 30]
    assert all(np.isfinite(r["temp"]) for r in rows)
    dump = (tmp_path / "t.lammpstrj").read_text().splitlines()
    assert dump.count("ITEM: TIMESTEP") == 1 and dump[1] == "20"
    assert len(dump) == 9 + 648
    st = load_restart(str(tmp_path / "r.npz"), device="cpu")
    assert st.step == 30 and int(st.n_valid()) == 648
    assert bool(torch.isfinite(st.x).all())


def _by_tag(state):
    order = torch.argsort(state.tag[state.mask])
    return state.x[state.mask][order], state.v[state.mask][order]


@pytest.mark.parametrize("path", ["nlist", "pallas"])
def test_resume_from_restart_is_bitwise(tmp_path, path):
    """Saved, loaded and continued is bitwise the uninterrupted run, on
    the deck's neighbour lists (run_adaptive, JAX's test) and on the
    bucket path the CLI runs (run_bucket_chunked)."""
    deck = load_deck(str(CLASSIC))
    if path == "nlist":
        deck["atoms"]["n"] = 200

        def run(sy, pa, st, n):
            return run_adaptive(sy, pa, st, n)[0]
    else:
        deck["box"]["lengths"] = [8.0, 8.0, 8.0]
        deck["neighbor"] = {"skin": 0.4, "rebuild_every": 3}
        deck["rng"] = {"mode": "fast"}
        deck["engine"] = {"force_path": "pallas", "rebuild": "sort",
                          "wrap_mode": "rebuild"}

        def run(sy, pa, st, n):
            return run_bucket_chunked(sy, pa, st, n // 3, 3,
                                      thermo_trace=False)[0]
    system, params, state, _ = build_from_deck(deck, device="cpu")
    mid = run(system, params, state, 3)
    p = str(tmp_path / "mid.npz")
    save_restart(p, mid)
    cont = run(system, params, mid, 3)
    resumed = run(system, params, load_restart(p, device="cpu"), 3)
    assert resumed.step == cont.step == 6
    for a, b in zip(_by_tag(cont), _by_tag(resumed)):
        assert torch.equal(a, b)


def test_cli_dd_two_ranks_on_a_bonded_deck(tmp_path):
    """--dd 2 on a polymer melt: two gloo ranks on the CPU, thermo rows
    from rank 0, bonded_missing 0, N and the tags kept (from the restart
    written from the gathered state)."""
    deck = _deck_copy(tmp_path, DECKS / "polymer_melt.toml", run=(
        f'steps = 10\nthermo_every = 10\nrestart_every = 10\n'
        f'restart_path = "{tmp_path / "dd.npz"}"\n'))
    log = tmp_path / "dd.jsonl"
    code = main([deck, "--dd", "2", "--device", "cpu", "--log", str(log)])
    assert code == 0
    rows = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 10]
    assert rows[1]["bonded_missing"] == 0
    st = load_restart(str(tmp_path / "dd.npz"), device="cpu")
    tags = st.tag[st.mask]
    assert st.step == 10 and tags.numel() == 1536
    assert torch.equal(torch.sort(tags).values,
                       torch.arange(1, 1537, dtype=torch.int32))


def test_cli_profile_writes_a_trace(tmp_path):
    deck = _deck_copy(tmp_path, run="steps = 2\nthermo_every = 1\n")
    prof = tmp_path / "prof"
    assert main([deck, "--device", "cpu", "--profile", str(prof)]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def test_cli_validate_reports_and_passes(tmp_path, capsys):
    deck = _deck_copy(tmp_path, run="steps = 1\nthermo_every = 1\n")
    assert main([deck, "--device", "cpu", "--validate"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("validate:")][0]
    report = dict(kv.split("=") for kv in line.split()[1:])
    assert float(report["max_rel"]) < 1e-4


def test_cli_binary_frames_and_var_override(tmp_path):
    """--var reaches the deck's [variables]; the binary frame codec
    round-trips a CLI state."""
    from meso_tpu_torch.io.dump import write_frame_bin
    p = tmp_path / "v.toml"
    p.write_text(CLASSIC.read_text().replace(
        "[box]\nlengths = [6.0, 6.0, 6.0]",
        '[variables]\nL = 6.0\n\n[box]\nlengths = ["${L}", "${L}", "${L}"]'))
    assert main([str(p), "--steps", "2", "--device", "cpu", "--var",
                 "L=5.0"]) == 0
    system, params, state, _ = build_from_deck(
        load_deck(str(p), {"L": 5.0}), device="cpu")
    assert int(state.n_valid()) == 375
    write_frame_bin(str(tmp_path / "f.bin"), state, append=False)
    (frame,) = read_frames_bin(str(tmp_path / "f.bin"))
    assert frame["tag"].tolist() == list(range(1, 376))


def test_autotune_empty_pool_raises():
    _, params, state, _ = build_from_deck(load_deck(str(CLASSIC)),
                                          device="cpu")

    def refuse(skin, every, **kw):
        raise ValueError("no such configuration")

    with pytest.raises(ValueError, match="none of the 2 candidates"):
        autotune_fluid(refuse, params, state,
                       candidates=[(0.3, 3), (0.4, 5)], verbose=False)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_without_card_does_not_fall_back(tmp_path):
    deck = _deck_copy(tmp_path, run="steps = 1\nthermo_every = 1\n")
    with pytest.raises((RuntimeError, AssertionError)):
        main([deck])
