"""Hopper ports of the JAX package's TPU probes under ``tools/`` (T1-T4).

Each module carries its probe's name (``toy_dynroll``, ``toy_mxu_tile``,
``toy_tea_roll``, ``r5a_stage``): the wrappers of its CUDA kernels
(``csrc/probes.cu``), the plain torch version beside each, the probe's
inputs and a ``main()`` that runs the probe on the card and prints PASS or
FAIL lines, as the JAX tool does::

    python -m meso_tpu_torch.probes.toy_dynroll

A wrapper runs its plain version on a CPU tensor, and only there; on a
CUDA tensor it launches its kernel through ``_build.launch``, counted in
``_build.LAUNCHES`` under the probe's name, or raises.
"""

from __future__ import annotations

from meso_tpu_torch.kernels.common import check_cuda


def check_inputs(specs: dict) -> None:
    """The kernel library, built where it is not yet (raising where it
    cannot be), then specs: name -> (tensor, dtype), every tensor a
    contiguous CUDA tensor of its dtype on the first one's device."""
    check_cuda({name: (t, dtype, None) for name, (t, dtype) in specs.items()})


def on_cpu(*tensors) -> bool:
    """True where every tensor lies on the CPU (the plain version's case)."""
    return all(t.device.type == "cpu" for t in tensors)


def report(name: str, ok: bool, **numbers) -> bool:
    """One PASS or FAIL line of a probe's main(), with its numbers."""
    detail = " ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                      for k, v in numbers.items())
    print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)
    return ok
