"""chip_smoke.py's least-time bounds, on the CPU: the operation counts and
their rates (``Ops``, ``bytes_bound``) and the count of the hash kernel's
instructions by pipe from a disassembly (``hash_sass_ops``), here on a
short listing written in the form ``cuobjdump -sass`` prints."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from meso_tpu_torch.kernels import _build  # noqa: E402
from test_torch_imports import one_torch_thread  # noqa: E402,F401


def test_rates_follow_the_fp32_rate():
    """128 fp32 lanes an SM, an FMA two operations: the clock the data
    sheet's 67 TFLOP/s implies; the issue rate is 128 lanes, each pipe
    64."""
    c = chip_smoke
    assert c.SM_CLOCK_HZ == pytest.approx(1.98e9, rel=2e-3)
    assert c.ISSUE_PER_S == pytest.approx(c.FP32_OPS_PER_S / 2)
    assert c.ALU_PER_S == c.IMAD_PER_S == pytest.approx(c.ISSUE_PER_S / 2)


def test_ops_add_scale_subtract():
    a = chip_smoke.Ops(1, 2, 3, 4)
    assert a + chip_smoke.Ops(1, 1) == (2, 3, 3, 4)
    assert 2 * a == a * 2 == (2, 4, 6, 8)
    assert a - chip_smoke.Ops(0, 1, 1) == (1, 1, 2, 4)


@pytest.mark.parametrize("ops,want_ms,by", [
    (chip_smoke.Ops(0, 0), 1e3 * 3.35e6 / 3.35e12, "bytes"),
    (chip_smoke.Ops(67e9), 1e-3 * 1e3, "operations"),
    (chip_smoke.Ops(0, 33.5e9), 1.0, "operations"),
    # the ALU pipe binds before the issue rate: 20 of 30 instructions
    (chip_smoke.Ops(0, 30e9, 20e9), 20e9 / 16.75e12 * 1e3, "operations"),
    (chip_smoke.Ops(0, 30e9, 0, 20e9), 20e9 / 16.75e12 * 1e3,
     "operations")])
def test_bound_is_the_longest_of_bytes_and_each_rate(ops, want_ms, by):
    ms, got_by = chip_smoke.bytes_bound(3.35e6, ops)
    assert ms == pytest.approx(want_ms, rel=1e-3)
    assert got_by == by


def _line(addr, text):
    return (f"        /*{addr:04x}*/                   {text} ;"
            "   /* 0x000000000000 */")


def _function(name, ops):
    lines = [f"\t\tFunction : {name}"]
    lines += [_line(16 * i, op) for i, op in enumerate(ops)]
    return "\n".join(lines)


HALF = ["LEA R1, R2, UR6, 0x4", "VIADD R3, R2, 0x9e3779b9",
        "LEA.HI R4, R2, UR7, RZ, 0x1b", "LOP3.LUT R4, R4, R1, R3, 0x96, !PT",
        "IMAD.IADD R5, R5, 0x1, R4"]


def test_hash_sass_ops_counts_the_tea_block(monkeypatch):
    """The longest straight run of integer instructions of
    particle_hash_kernel<8>, over its 4 rows, by pipe: branches, loads and
    the other kernels' code left out, convergence marks skipped."""
    tea = ["LOP3.LUT R10, R4, 0xdeadbeef, RZ, 0x3c, !PT"] * 4
    tea += ["BSSY B0, 0x1800"] + HALF * (2 * 8 * 4)
    hash8 = ["S2R R0, SR_TID.X", "IMAD R11, R11, UR4, R0",
             "ISETP.GE.AND P0, PT, R11, UR5, PT", "@P0 EXIT",
             "LDG.E.128.CONSTANT R4, desc[UR8][R4.64]", "BSYNC B0"]
    hash8 += tea + ["@!P0 BRA 0x17d0", "IMAD.WIDE R12, R11, 0x10, R2",
                    "STG.E.128 desc[UR8][R12.64], R4", "EXIT"]
    listing = "\n".join([
        _function("_ZN4anon20particle_hash_kernelILi0EEEvPKiPjijjii",
                  HALF * 200 + ["EXIT"]),
        _function("_ZN4anon20particle_hash_kernelILi8EEEvPKiPjijjii", hash8),
        _function("_ZN4anon15tea_roll_kernelEPKfPKiS3_iPfiiiiii",
                  HALF * 500)])
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(_build, "library_path", lambda nvcc: "lib.so")
    calls = []

    def run(cmd):
        calls.append(cmd)
        return listing

    monkeypatch.setattr(chip_smoke, "run", run)
    ops, counts = chip_smoke.hash_sass_ops()
    assert calls == [["/cuda/bin/cuobjdump", "-sass", "lib.so"]]
    # a row: one xor, then 16 half-rounds of 5 (3 ALU, 1 IMAD, 1 VIADD)
    assert ops == (0, 1 + 80, 1 + 48, 16)
    assert counts["VIADD"] == 64
    assert "BSSY" not in counts and "IMAD" not in counts
