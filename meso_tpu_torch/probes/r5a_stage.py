"""T4: the null stage of K1's grid (port of ``null_pallas`` from
``tools/r5a_stage.py``).

The TPU kernel ran K1's grid and block specs with null math, to measure
the floor of data movement and grid dispatch under the real kernel. Its
function: for every grid cell (cy, cb) of a (n_chan, ny + 2, zc, kp,
l_lane) view, each of the 4 x 2 output planes is channel 0 of band cy + 1
plus channel 1 of band cy + 2. The Hopper kernel (``csrc/probes.cu``)
computes that function with 16-byte loads and writes every output element
once, one block per grid cell and slice of its plane: its bytes over its
time at K1's 1M view are the card's achieved streaming rate, the measured
floor of a pair kernel's bytes, and its times over zc the cost of more,
smaller grid cells. The rest of the JAX tool (the TPU epilogue replica,
the VPU census, the step and call times) is TPU history; the port's step
and call times are in chip_smoke.py.

    python -m meso_tpu_torch.probes.r5a_stage
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from meso_tpu_torch import probes
from meso_tpu_torch.kernels import _build

N_OUT = 4
# K1's rows at 1,029,000 particles: 50^3 cells of K = 16 (L = 70, spill)
N_CHAN, NY, NZ, NX, KP = 8, 50, 50, 50, 16
ZCS = (1, 5, 10, 25)


def null_stage_plain(view: torch.Tensor) -> torch.Tensor:
    """(4, 2, ny, zc, kp, l_lane): every plane = view[0, 1:ny+1] +
    view[1, 2:ny+2]."""
    ny = view.shape[1] - 2
    s = view[0, 1:ny + 1] + view[1, 2:ny + 2]
    return s[None, None].expand((N_OUT, 2) + s.shape).contiguous()


def null_stage(view: torch.Tensor) -> torch.Tensor:
    if probes.on_cpu(view):
        return null_stage_plain(view)
    probes.check_inputs({"view": (view, torch.float32)})
    n_chan, ny2, zc, kp, l_lane = view.shape
    if n_chan < 2 or (kp * l_lane) % 4:
        raise ValueError("null_stage takes n_chan >= 2 and kp * l_lane a "
                         "multiple of 4 (16-byte loads)")
    out = torch.empty((N_OUT, 2, ny2 - 2, zc, kp, l_lane),
                      dtype=torch.float32, device=view.device)
    _build.launch("probe_null_stage", "meso_probe_null_stage",
                  view.data_ptr(), out.data_ptr(), ny2 - 2, zc, kp * l_lane,
                  device=view.device)
    return out


def view_1m(zc: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """K1's view at 1M rows: (8, 52, zc, 16, 2500 / zc), random."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((N_CHAN, NY + 2, zc, KP, NZ * NX // zc),
                      generator=gen, device=device)


def bytes_moved(view: torch.Tensor) -> int:
    """The bytes the function must move: the two planes it reads, once,
    and the eight it writes."""
    n_chan, ny2, zc, kp, l_lane = view.shape
    return (2 + 2 * N_OUT) * (ny2 - 2) * zc * kp * l_lane * 4


def smoke_view(device="cuda") -> torch.Tensor:
    """The (8, 5, 1, 8, 16) view the JAX tool's SMOKE setting gives, from
    numpy's RandomState(0)."""
    v = np.random.RandomState(0).rand(8, 5, 1, 8, 16).astype(np.float32)
    return torch.from_numpy(v).to(device)


def run(device="cuda") -> dict:
    """The null stage at the smoke view and at K1's 1M view (zc = 5) on
    ``device``, bitwise against the plain version."""
    res = {}
    for name, view in (("smoke", smoke_view(device)),
                       ("1m-zc5", view_1m(5, device=device))):
        got = null_stage(view)
        want = null_stage_plain(view)
        res[name] = {"bitwise": bool(torch.equal(got, want)),
                     "max_abs_err": float((got - want).abs().max())}
    return res


def main() -> int:
    ok = [probes.report(f"null_stage[{k}]", r["bitwise"],
                        max_abs_err=r["max_abs_err"])
          for k, r in run().items()]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
