"""T1: a roll by shifts read at run time, and a branch on device-read
scalars around seven carries (port of ``tools/toy_dynroll.py``: ``k_dynroll``
and ``k_cond``).

On the TPU the probe asked whether Mosaic lowers ``pltpu.roll`` with a
traced shift and ``lax.cond`` over a tuple of carries. On Hopper the same
functions are a gather from a row staged in shared memory at offsets read
from device memory (``dynroll``), and a branch on two device-read scalars
around register carries (``cond``), both in ``csrc/probes.cu``. Both are
launch-bound at the probe's (8, 256) shape.

    python -m meso_tpu_torch.probes.toy_dynroll
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from meso_tpu_torch import probes

L = 256
OFFS = (1, -2, 5, 0)
JM = (9, 2)


def inputs(device="cuda"):
    """The probe's inputs: x (8, 256) from RandomState(0) with offs
    [[1, -2, 5, 0]] for dynroll; x from RandomState(1) with jm [[9, 2]]
    for cond, as the JAX tool draws them."""
    x0 = torch.from_numpy(np.random.RandomState(0).rand(8, L)
                          .astype(np.float32)).to(device)
    x1 = torch.from_numpy(np.random.RandomState(1).rand(8, L)
                          .astype(np.float32)).to(device)
    offs = torch.tensor([OFFS], dtype=torch.int32, device=device)
    jm = torch.tensor([JM], dtype=torch.int32, device=device)
    return (x0, offs), (x1, jm)


def dynroll_plain(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """sum_i roll(x, -offs[i], 1), added in the offsets' order."""
    acc = torch.zeros_like(x)
    for o in offs.reshape(-1).tolist():
        acc = acc + torch.roll(x, -int(o), 1)
    return acc


def dynroll(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """out[r, c] = sum_i x[r, (c + offs[i]) mod L]: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    if probes.on_cpu(x, offs):
        return dynroll_plain(x, offs)
    probes.check_inputs({"x": (x, torch.float32), "offs": (offs,
                                                           torch.int32)})
    out = torch.empty_like(x)
    rows, n = x.shape
    probes.launch("probe_dynroll", "meso_probe_dynroll", x.data_ptr(),
                  offs.data_ptr(), offs.numel(), out.data_ptr(), rows, n,
                  device=x.device)
    return out


def cond_plain(x: torch.Tensor, jm: torch.Tensor) -> torch.Tensor:
    """Seven zero carries; each branch whose scalar exceeds 4 sets carry i
    to 0 + x (i + 1) from the zero carries (the TPU kernel's branch binds
    the initial tuple, so a second taken branch does not accumulate);
    out = carry0 + carry6."""
    zero = tuple(torch.zeros_like(x) for _ in range(7))
    acc = zero
    for j in jm.reshape(-1).tolist():
        if j > 4:
            acc = tuple(a + x * float(i + 1) for i, a in enumerate(zero))
    return acc[0] + acc[6]


def cond(x: torch.Tensor, jm: torch.Tensor) -> torch.Tensor:
    if probes.on_cpu(x, jm):
        return cond_plain(x, jm)
    probes.check_inputs({"x": (x, torch.float32), "jm": (jm, torch.int32)})
    out = torch.empty_like(x)
    probes.launch("probe_cond", "meso_probe_cond", x.data_ptr(),
                  jm.data_ptr(), out.data_ptr(), x.numel(), device=x.device)
    return out


def run(device="cuda") -> dict:
    """Both probes on ``device`` against their plain versions on the same
    inputs (bitwise), and against the functions the JAX tool checks
    (sum of rolls; x + 7x, as only the first branch fires)."""
    (x0, offs), (x1, jm) = inputs(device)
    got = {"dynroll": dynroll(x0, offs), "cond": cond(x1, jm)}
    want = {"dynroll": dynroll_plain(x0.cpu(), offs.cpu()),
            "cond": cond_plain(x1.cpu(), jm.cpu())}
    ref = {"dynroll": sum(torch.roll(x0.cpu(), -o, 1) for o in OFFS),
           "cond": x1.cpu() * 1 + x1.cpu() * 7}
    out = {}
    for name in got:
        g = got[name].cpu()
        out[name] = {"max_abs_err": float((g - want[name]).abs().max()),
                     "bitwise": bool(torch.equal(g, want[name])),
                     "ref_err": float((g - ref[name]).abs().max())}
    return out


def main() -> int:
    res = run()
    ok = [probes.report(f"toy_{name}", r["bitwise"] and r["ref_err"] < 1e-6,
                        max_abs_err=r["max_abs_err"], ref_err=r["ref_err"])
          for name, r in res.items()]
    print(f"TOY_DYNROLL {'PASS' if ok[0] else 'FAIL'} / "
          f"TOY_COND {'PASS' if ok[1] else 'FAIL'}", flush=True)
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
