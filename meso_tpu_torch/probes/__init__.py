"""Hopper ports of the JAX package's TPU probes under ``tools/`` (T1-T4).

Each module carries its probe's name (``toy_dynroll``, ``toy_mxu_tile``,
``toy_tea_roll``, ``r5a_stage``): the wrappers of its CUDA kernels
(``csrc/probes.cu``), the plain torch version beside each, the probe's
inputs and a ``main()`` that runs the probe on the card and prints PASS or
FAIL lines, as the JAX tool does::

    python -m meso_tpu_torch.probes.toy_dynroll

A wrapper runs its plain version on a CPU tensor, and only there; on a
CUDA tensor it launches its kernel, adding one to ``LAUNCHES[name]``, or
raises.
"""

from __future__ import annotations

import torch

from meso_tpu_torch.kernels import _build

LAUNCHES = {"probe_dynroll": 0, "probe_cond": 0, "probe_dot_a": 0,
            "probe_dot_b": 0, "probe_tile": 0, "probe_dot_c": 0,
            "probe_tea_roll": 0, "probe_null_stage": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_inputs(specs: dict) -> None:
    """The kernel library, built where it is not yet (raising where it
    cannot be), then specs: name -> (tensor, dtype), every tensor a
    contiguous CUDA tensor of its dtype on the first one's device."""
    from meso_tpu_torch.kernels.common import check_cuda
    _build.load_library()
    check_cuda({name: (t, dtype, None) for name, (t, dtype) in specs.items()})


def launch(name: str, fn: str, *args, device) -> None:
    """Call the C entry point ``fn`` of the kernel library on the current
    stream of ``device``, raise on a launch error, count the launch."""
    lib = _build.load_library()
    code = getattr(lib, fn)(*args,
                            torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, name)
    LAUNCHES[name] += 1


def on_cpu(*tensors) -> bool:
    """True where every tensor lies on the CPU (the plain version's case)."""
    return all(t.device.type == "cpu" for t in tensors)


def report(name: str, ok: bool, **numbers) -> bool:
    """One PASS or FAIL line of a probe's main(), with its numbers."""
    detail = " ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                      for k, v in numbers.items())
    print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)
    return ok
