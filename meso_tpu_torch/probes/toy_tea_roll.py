"""T3: the TEA pair hash on rolled spill lanes (port of
``tools/toy_tea_roll.py``: ``_kernel`` and ``_kernel_scratch``).

The TPU probe reproduced a Mosaic miscompile of the spill layout with the
TEA tier in ten variants that differ in how the kernel was lowered. On a
(K, L) = (16, 60) brick of tags and a mask, each variant sums over seven
lane offsets o the symmetric uniform of a pair hash of the tag at (k, c)
and the tag of a row at lane (c + o) mod L, where both rows' mask is set.
On the probe's inputs (tags below 2^24, keys iscal = [42, 977], the
branch's bound iscal[0] > 0) the ten variants are five functions: the
mixer (TEA of 8 rounds, of 2, or ``pair_uniform_fast`` of the two keys),
the ordering of the keys (min/max, or none) and the row set (row 0, or
all 16 rows in groups of 8). One kernel (``csrc/probes.cu``), one thread
per (k, lane), takes each case; it reuses the TEA and uniform device
functions of ``csrc/dpd_common.cuh`` that K1-K3 hold bitwise against the
JAX package.

    python -m meso_tpu_torch.probes.toy_tea_roll
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from meso_tpu_torch import probes
from meso_tpu_torch.core import rng as rngmod

K, W, NZ = 16, 10, 6
L = NZ * W
OFFS = (1, 2, W - 2, W - 1, W, W + 1, W + 2)
ISCAL = (42, 977)
VARIANTS = ("base", "fast", "pre_bc", "no_minmax", "const_key", "rounds2",
            "scratch", "grp8", "cond", "vals")
# variant -> (mixer, rounds, ordering, all_rows); mixer 0: TEA, 1: fast.
# pre_bc and scratch change only where the tags are bit-cast and staged;
# const_key keys TEA with (42, 977), which iscal holds; cond gates the
# sum on iscal[0] > 0, which holds; vals orders the tags as float32
# values, exact below 2^24: each is base's function on these inputs.
CASES = {"base": (0, 8, 1, 0), "fast": (1, 8, 1, 0), "pre_bc": (0, 8, 1, 0),
         "no_minmax": (0, 8, 0, 0), "const_key": (0, 8, 1, 0),
         "rounds2": (0, 2, 1, 0), "scratch": (0, 8, 1, 0),
         "grp8": (0, 8, 1, 1), "cond": (0, 8, 1, 0), "vals": (0, 8, 1, 0)}


def inputs(device="cuda"):
    """stack (3, 1, K, L) float32 (the mask, the tags' bits, the tags as
    values) and iscal (1, 2) int32, drawn as the JAX tool draws them from
    RandomState(7)."""
    rs = np.random.RandomState(7)
    tags = rs.permutation(2 * K * L)[:K * L].astype(np.int32).reshape(K, L)
    mask = (rs.rand(K, L) < 0.7).astype(np.float32)
    stack = np.stack([mask, tags.view(np.float32), tags.astype(np.float32)])
    return (torch.from_numpy(stack[:, None].copy()).to(device),
            torch.tensor([ISCAL], dtype=torch.int32, device=device))


def tea_roll_plain(stack: torch.Tensor, iscal: torch.Tensor,
                   variant: str) -> torch.Tensor:
    """(1, 1, K, L) float32: the variant's sum, in the kernel's order (row
    groups, then offsets, then the group's rows)."""
    mixer, rounds, ordering, all_rows = CASES[variant]
    mask = stack[0, 0]
    tags = stack[1, 0].contiguous().view(torch.int32)
    step, seed = (int(v) for v in iscal.reshape(-1).tolist())
    k, n = tags.shape
    acc = torch.zeros((k, n), dtype=torch.float32, device=stack.device)
    groups = [list(range(g, g + 8)) for g in range(0, k, 8)] if all_rows \
        else [[0]]
    for rows in groups:
        for off in OFFS:
            rolled_t = torch.roll(tags, -off, 1)
            rolled_m = torch.roll(mask, -off, 1)
            for r in rows:
                other = rolled_t[r:r + 1]
                if ordering:
                    lo, hi = torch.minimum(tags, other), torch.maximum(tags,
                                                                       other)
                else:
                    lo, hi = tags, other.expand_as(tags)
                if mixer == 1:
                    theta = rngmod.pair_uniform_fast(lo, hi)
                else:
                    v0, _ = rngmod.tea(lo, hi, step, seed, rounds=rounds)
                    theta = rngmod._u32_to_symmetric_uniform(v0)
                acc = acc + torch.where(mask * rolled_m[r:r + 1] > 0.5,
                                        theta, torch.zeros_like(theta))
    return acc[None, None]


@functools.lru_cache(maxsize=None)
def _offsets(device: torch.device) -> torch.Tensor:
    """OFFS as an int32 tensor on ``device``, copied there once."""
    return torch.tensor(OFFS, dtype=torch.int32, device=device)


def tea_roll(stack: torch.Tensor, iscal: torch.Tensor,
             variant: str) -> torch.Tensor:
    """The variant's (1, 1, K, L) sum: the kernel on CUDA tensors, the
    plain version on CPU ones."""
    if variant not in CASES:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if probes.on_cpu(stack, iscal):
        return tea_roll_plain(stack, iscal, variant)
    probes.check_inputs({"stack": (stack, torch.float32),
                         "iscal": (iscal, torch.int32)})
    k, n = stack.shape[-2:]
    if stack.shape != (3, 1, k, n) or (CASES[variant][3] and k % 8):
        raise ValueError("tea_roll takes a (3, 1, K, L) stack, K % 8 == 0 "
                         "for grp8")
    mixer, rounds, ordering, all_rows = CASES[variant]
    offs = _offsets(stack.device)
    out = torch.empty((1, 1, k, n), dtype=torch.float32, device=stack.device)
    probes.launch("probe_tea_roll", "meso_probe_tea_roll", stack.data_ptr(),
                  iscal.data_ptr(), offs.data_ptr(), len(OFFS),
                  out.data_ptr(), k, n, mixer, rounds, ordering, all_rows,
                  device=stack.device)
    return out


def run(device="cuda") -> dict:
    """All ten variants on ``device`` against the plain version on the
    CPU, bitwise."""
    stack, iscal = inputs(device)
    res = {}
    for v in VARIANTS:
        got = tea_roll(stack, iscal, v).cpu()
        want = tea_roll_plain(stack.cpu(), iscal.cpu(), v)
        res[v] = {"bitwise": bool(torch.equal(got, want)),
                  "max_abs_err": float((got - want).abs().max()),
                  "mean": float(got.mean())}
    return res


def main() -> int:
    ok = [probes.report(f"tea-roll[{v}]", r["bitwise"],
                        max_abs_err=r["max_abs_err"], mean=r["mean"])
          for v, r in run().items()]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
