"""Span attribution on a synthetic trace: innermost span, the residue to
the step glue, every device operation counted once; the busy union and
the idle gaps; the span wrappers put the program's functions back."""

from __future__ import annotations

import importlib

import pytest

from benchlib import trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """A window 0-100 us. Host: span rebuild 5-30 containing span pair
    10-20 (a nested span of another layer); a launch in each region and
    one under no span; device operations for each, one outside the window
    and one without a launch record."""
    return [
        _x("user_annotation", trace.WINDOW_SPAN, 0, 100),
        _x("user_annotation", "bench:rebuild", 5, 25),
        _x("user_annotation", "bench:pair", 10, 10),
        _x("cpu_op", "aten::sort", 6, 3),
        _x("cuda_runtime", "cudaLaunchKernel", 7, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=4),
        _x("kernel", "sort_kernel", 30, 10, tid=7, corr=1),
        _x("kernel", "pair_kernel", 40, 20, tid=7, corr=2),
        _x("gpu_memcpy", "copy", 60, 5, tid=7, corr=3),
        _x("kernel", "integrate", 70, 10, tid=7, corr=4),
        _x("kernel", "orphan", 85, 5, tid=7, corr=99),
        _x("kernel", "after_window", 150, 5, tid=7, corr=4),
    ]


def test_innermost_span_and_residue():
    att = trace.attribute(synthetic())
    assert att["window"] == (0.0, 100.0)
    assert att["layer_us"] == {"rebuild": 10.0 + 5.0, "pair": 20.0,
                               trace.GLUE: 10.0 + 5.0}
    assert att["kernels"] == 4
    # each operation inside the window once
    assert sorted(o[2] for o in att["ops"]) == [
        "copy", "integrate", "orphan", "pair_kernel", "sort_kernel"]
    assert sum(att["layer_us"].values()) == sum(o[1] - o[0]
                                                for o in att["ops"])
    ops = {o[2]: o for o in att["ops"]}
    assert ops["sort_kernel"][3:] == ("rebuild", "aten::sort")
    assert ops["pair_kernel"][3] == "pair"


def test_busy_union_and_gaps():
    att = trace.attribute(synthetic())
    busy, gaps = trace.busy_and_gaps(att["ops"], att["window"])
    assert busy == 10 + 20 + 5 + 10 + 5
    assert sum(g for g, _ in gaps) == 100 - busy
    brk = trace.breakdown(att["ops"], gaps)
    assert brk["device_ops"][0] == ["pair_kernel", 20e-6]
    assert len(brk["device_ops"]) <= 10 and len(brk["idle_gaps"]) <= 10


def test_overlapping_operations_count_once_in_busy():
    ops = [(0.0, 10.0, "a", "glue", ""), (5.0, 15.0, "b", "glue", "")]
    busy, gaps = trace.busy_and_gaps(ops, (0.0, 20.0))
    assert busy == 15.0 and gaps == [(5.0, "window end")]


def test_one_window_span_required():
    with pytest.raises(ValueError):
        trace.attribute([_x("kernel", "k", 0, 1, corr=1)])


def test_spans_wrap_and_restore():
    mod = importlib.import_module("meso_tpu_torch.core.integrate")
    orig = mod.final_integrate
    with trace.Spans({"glue_test": [
            "meso_tpu_torch.core.integrate:final_integrate"]}) as spans:
        assert mod.final_integrate is not orig
        assert mod.final_integrate.__wrapped__ is orig
        import torch
        v = torch.zeros((2, 3))
        mod.final_integrate(v, v, v, 0.01, torch.ones(2),
                            torch.ones(2, dtype=torch.bool))
        assert spans.opened["glue_test"] == 1
    assert mod.final_integrate is orig
