"""Spans around the program's layer entry functions, and the reduction of
a torch.profiler trace to device time per layer.

In a traced run the harness replaces each listed ``module:function`` with
a wrapper that opens ``torch.profiler.record_function("bench:<layer>")``
around the call; the program is never edited. A device operation
(kernel, copy or fill) belongs to the innermost span that was open on
the launching thread when it was launched; one launched under no span is
the step glue's. Each operation is counted once.
"""

from __future__ import annotations

import functools
import importlib
import json
from collections import defaultdict

SPAN_PREFIX = "bench:"
WINDOW_SPAN = "bench-window"
GLUE = "glue"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Wraps layer entry functions for the life of the object (use it as a
    context manager); ``opened[layer]`` counts the calls."""

    def __init__(self, layers: dict):
        self.layers = layers
        self.opened = defaultdict(int)
        self._saved = []

    def __enter__(self):
        from torch.profiler import record_function
        for layer, entries in self.layers.items():
            for entry in entries:
                modname, fname = entry.split(":")
                mod = importlib.import_module(modname)
                orig = getattr(mod, fname)

                def wrapper(*a, _orig=orig, _layer=layer, **kw):
                    self.opened[_layer] += 1
                    with record_function(SPAN_PREFIX + _layer):
                        return _orig(*a, **kw)

                functools.update_wrapper(wrapper, orig)
                self._saved.append((mod, fname, orig))
                setattr(mod, fname, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, fname, orig in reversed(self._saved):
            setattr(mod, fname, orig)
        self._saved.clear()
        return False


def attribute(events: list) -> dict:
    """Reduce Chrome-trace events (torch.profiler's export) to the traced
    window's device time by layer.

    Returns {"window": (t0, t1) in us, "layer_us": {layer: us},
    "ops": [(t0, t1, name, layer, host op)], "kernels": n} over the
    device operations that start inside the window span."""
    window = [e for e in events if e.get("name") == WINDOW_SPAN
              and e.get("cat") == "user_annotation"]
    if len(window) != 1:
        raise ValueError(f"expected one {WINDOW_SPAN} span, "
                         f"found {len(window)}")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    launches = {}
    host = defaultdict(list)          # tid -> [(t0, t1, name, is_span)]
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("tid"))
        elif cat == "user_annotation" and \
                str(e.get("name", "")).startswith(SPAN_PREFIX):
            t0 = float(e["ts"])
            host[e.get("tid")].append((t0, t0 + float(e["dur"]),
                                       e["name"][len(SPAN_PREFIX):], True))
        elif cat == "cpu_op":
            t0 = float(e["ts"])
            host[e.get("tid")].append((t0, t0 + float(e["dur"]),
                                       e["name"], False))
    # (layer, host op) open at each launch time, by a sweep per thread
    queries = defaultdict(list)
    for corr, (ts, tid) in launches.items():
        queries[tid].append((ts, corr))
    owner = {}
    for tid, qs in queries.items():
        marks = []
        for i, (t0, t1, name, is_span) in enumerate(host.get(tid, [])):
            marks.append((t0, 1, i))
            marks.append((t1, 0, i))
        marks += [(ts, 2, corr) for ts, corr in qs]
        marks.sort(key=lambda m: (m[0], m[1]))
        spans = host.get(tid, [])
        open_spans, open_ops = [], []
        for _, kind, i in marks:
            if kind == 2:
                owner[i] = (open_spans[-1] if open_spans else GLUE,
                            open_ops[-1] if open_ops else "")
                continue
            _, _, name, is_span = spans[i]
            stack = open_spans if is_span else open_ops
            if kind == 1:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
    layer_us = defaultdict(float)
    ops = []
    kernels = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t0 = float(e["ts"])
        if not (w0 <= t0 < w1):
            continue
        dur = float(e.get("dur", 0.0))
        layer, op = owner.get(e.get("args", {}).get("correlation"),
                              (GLUE, ""))
        layer_us[layer] += dur
        ops.append((t0, t0 + dur, e.get("name", ""), layer, op))
        kernels += e.get("cat") == "kernel"
    return {"window": (w0, w1), "layer_us": dict(layer_us), "ops": ops,
            "kernels": kernels}


def busy_and_gaps(ops: list, window: tuple):
    """(busy us: the union of the operations' intervals inside the
    window, [(gap us, what the host launched next)] of the idle gaps)."""
    w0, w1 = window
    busy, gaps = 0.0, []
    cur = w0
    for t0, t1, name, layer, op in sorted(ops):
        t0, t1 = max(t0, w0), min(t1, w1)
        if t0 > cur:
            gaps.append((t0 - cur, f"{layer}/{op or name}"))
        if t1 > cur:
            busy += t1 - max(t0, cur)
            cur = t1
    if w1 > cur:
        gaps.append((w1 - cur, "window end"))
    return busy, gaps


def breakdown(ops: list, gaps: list, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by what the host launched next, in seconds."""
    by_op = defaultdict(float)
    for t0, t1, name, _, _ in ops:
        by_op[name[:120]] += (t1 - t0) / 1e6
    by_gap = defaultdict(float)
    for us, what in gaps:
        by_gap[what[:120]] += us / 1e6
    return {"device_ops": sorted(([k, v] for k, v in by_op.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in by_gap.items()),
                                key=lambda kv: -kv[1])[:top]}


def read_trace(path) -> list:
    with open(path) as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data
