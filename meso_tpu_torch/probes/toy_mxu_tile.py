"""T2: matrix-unit tile products and a DPD pair tile (port of
``tools/toy_mxu_tile.py``: ``k_dot_a``, ``k_dot_b``, ``k_tile``,
``k_dot_c``).

The TPU probe asked whether Mosaic lowers these shapes onto the MXU. On
Hopper the three products run on ``mma.sync.aligned.m16n8k8`` in TF32 with
the 3xTF32 split (hi.hi + hi.lo + lo.hi): plain TF32 keeps about three
digits. ``tile``, the DPD pair tile, runs on the CUDA cores as an n-body
tile (``csrc/probes.cu``): r^2 as the float32 sum of squared differences,
g / 25 = rsqrt(r^2) - 1 = (1 - r) / r, and F_i = sum_j g (x_i - x_j) summed
in registers, j in order. The tile done as two tensor-core products
cancelled twice (r^2 = |xi|^2 + |xj|^2 - 2 xi.xj; F = x_i sum g - sum g x_j)
and needed 6xTF32 to survive it (PERF.md has both designs' times).

Every function takes a leading batch of independent tiles (one warp a
tile for ``tile``); the probe is batch 1, and chip_smoke.py times 8,192
tiles. Tolerance, the JAX tool's own: max |out - ref| / max |ref| < 1e-5
against the plain version, for the three products. ``tile`` cannot be held
that close to any other float32 evaluation: at the closest pairs of the
probe's random positions (r ~ 0.07) its output moves by dg/dr^2 ~ 25 /
(2 r^3) per unit of r^2, so one rounding of the cancelling r^2 can move it
by more than 1e-5 of its largest value, and two float32 evaluations that
round r^2 differently differ by that much. So ``tile`` is held against the
plain version in float64: its error there must be at most 1e-5 or four
times the float32 plain version's own error against float64, whichever is
larger (``tile_check``). The tile reads only x: r^2 by differences has no
cancellation and is closer to float64 than the plain version's expansion.

    python -m meso_tpu_torch.probes.toy_mxu_tile
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from meso_tpu_torch import probes
from meso_tpu_torch.kernels import _build

TOL = 1e-5
# the tile's error against float64 may be this many times the float32
# plain version's own (see tile_check)
TILE_FACTOR = 4.0


def _batched(*ts):
    """The tensors with a leading batch axis, and whether one was added."""
    one = ts[0].dim() == 2
    return [t[None] if one else t for t in ts], one


def _gemm(name, a, b, transpose_a: bool):
    """C[b] = op(A[b]) . B[b] through the tensor-core kernel, op the
    transpose for ``transpose_a``."""
    (a, b), one = _batched(a, b)
    probes.check_inputs({"a": (a, torch.float32), "b": (b, torch.float32)})
    nb, r, s = a.shape
    m, k = (s, r) if transpose_a else (r, s)
    n = b.shape[2]
    if b.shape[1] != k or m % 16 or m > 512 or n % 8 or (n > 32 and n % 32) \
            or k % 8:
        raise ValueError(f"{name}: shapes {tuple(a.shape)}, {tuple(b.shape)}"
                         " need M % 16 == 0 (M <= 512), N % 8 == 0 (N % 32 "
                         "== 0 above 32), K % 8 == 0 and matching K")
    c = torch.empty((nb, m, n), dtype=torch.float32, device=a.device)
    _build.launch(name, "meso_probe_gemm", a.data_ptr(), b.data_ptr(),
                  c.data_ptr(), nb, m, n, k, int(transpose_a),
                  device=a.device)
    return c[0] if one else c


def product_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A . B (batched or not) as float32 products summed over k: the
    plain version, which repeats the arithmetic without a library GEMM."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def dot_a(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(128, 8) . (8, 128) -> (128, 128)."""
    if probes.on_cpu(a, b):
        return product_plain(a, b)
    return _gemm("probe_dot_a", a, b, False)


def dot_b(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(128, 128) . (128, 8) -> (128, 8)."""
    if probes.on_cpu(g, x):
        return product_plain(g, x)
    return _gemm("probe_dot_b", g, x, False)


def dot_c(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Contraction over dim 0 of both (8, 128) operands: A^T . B."""
    if probes.on_cpu(a, b):
        return product_plain(a.transpose(-1, -2), b)
    return _gemm("probe_dot_c", a, b, True)


def tile_plain(ai: torch.Tensor, bj: torch.Tensor) -> torch.Tensor:
    """The fused pair tile: r^2 = (|xi|^2 + |xj|^2) - 2 xi.xj, pairs with
    1e-12 < r^2 < 1 get g = 25 (1 - r) / r, and F_i = x_i sum_j g_ij -
    sum_j g_ij x_j. ai (..., 128, 8), bj (..., 8, 128) -> (..., 128, 3)."""
    # the products as torch.matmul takes them, which on the CPU rounds r^2
    # as the JAX tool's XLA dot does
    cross = torch.matmul(ai[..., :, :3], bj[..., :3, :])
    r2 = ai[..., :, 3:4] + bj[..., 3:4, :] - 2.0 * cross
    ok = (r2 < 1.0) & (r2 > 1e-12)
    r2s = torch.where(ok, r2, torch.ones_like(r2))
    rinv = torch.rsqrt(r2s)
    w = 1.0 - r2s * rinv
    g = torch.where(ok, 25.0 * w * rinv, torch.zeros_like(r2))
    red = torch.matmul(g, bj[..., :5, :].transpose(-1, -2))
    return ai[..., :, :3] * red[..., 4:5] - red[..., :3]


def tile(ai: torch.Tensor, bj: torch.Tensor) -> torch.Tensor:
    """The pair tile through the n-body kernel (``tile_plain``'s function);
    ai (..., 128, 8), bj (..., 8, 128) -> (..., 128, 3)."""
    if probes.on_cpu(ai, bj):
        return tile_plain(ai, bj)
    (ai, bj), one = _batched(ai, bj)
    probes.check_inputs({"ai": (ai, torch.float32),
                         "bj": (bj, torch.float32)})
    if ai.shape[1:] != (128, 8) or bj.shape[1:] != (8, 128):
        raise ValueError("tile takes ai (B, 128, 8) and bj (B, 8, 128)")
    out = torch.empty((ai.shape[0], 128, 3), dtype=torch.float32,
                      device=ai.device)
    _build.launch("probe_tile", "meso_probe_tile", ai.data_ptr(),
                  bj.data_ptr(), out.data_ptr(), ai.shape[0],
                  device=ai.device)
    return out[0] if one else out


def inputs(batch: int = 1, seed: int = 0, device="cuda") -> dict:
    """The probe's inputs, drawn as the JAX tool draws them (normals for
    the products; positions uniform in [0, 3) for the tile, ai = [x, |x|^2,
    0], bj = [x^T; |x|^2; 1; 0]) but from numpy's RandomState(seed), with a
    leading batch axis where batch > 1."""
    rs = np.random.RandomState(seed)
    lead = (batch,) if batch > 1 else ()

    def normal(*shape):
        return rs.standard_normal(lead + shape).astype(np.float32)

    a8, b8, g, x8 = normal(128, 8), normal(8, 128), normal(128, 128), \
        normal(128, 8)
    x = (rs.rand(*lead, 128, 3) * 3.0).astype(np.float32)
    xj = (rs.rand(*lead, 128, 3) * 3.0).astype(np.float32)
    ai = np.concatenate([x, (x * x).sum(-1, keepdims=True),
                         np.zeros(lead + (128, 4), np.float32)], -1)
    bj = np.concatenate([np.swapaxes(xj, -1, -2),
                         (xj * xj).sum(-1)[..., None, :],
                         np.ones(lead + (1, 128), np.float32),
                         np.zeros(lead + (3, 128), np.float32)], -2)
    out = {"dot_a": (a8, b8), "dot_b": (g, x8), "tile": (ai, bj),
           "dot_c": (b8, b8)}
    return {k: tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                     for t in v) for k, v in out.items()}


FUNCS = {"dot_a": (dot_a, lambda a, b: product_plain(a, b)),
         "dot_b": (dot_b, lambda a, b: product_plain(a, b)),
         "tile": (tile, tile_plain),
         "dot_c": (dot_c,
                   lambda a, b: product_plain(a.transpose(-1, -2), b))}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, the JAX tool's measure."""
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def tile_check(got: torch.Tensor, ai: torch.Tensor,
               bj: torch.Tensor) -> dict:
    """``tile``'s output against the plain version in float32 and in
    float64: ok where its error against float64 is at most max(TOL, 4x the
    float32 plain version's own error against float64)."""
    want = tile_plain(ai, bj)
    exact = tile_plain(ai.double(), bj.double())
    plain_err = rel_err(want.double(), exact)
    err = rel_err(got.double(), exact)
    return {"rel": rel_err(got, want), "rel_f64": err,
            "plain_rel_f64": plain_err,
            "ok": err <= max(TOL, TILE_FACTOR * plain_err)}


def run(device="cuda", batch: int = 1) -> dict:
    """Every product on ``device`` against its plain version on the same
    device, with TF32 off for the plain version's products."""
    res = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, args in inputs(batch, device=device).items():
        fn, plain = FUNCS[name]
        got = fn(*args)
        want = plain(*args)
        res[name] = {"rel": rel_err(got, want),
                     "max_abs_err": float((got - want).abs().max())}
        if name == "tile":
            res[name].update(tile_check(got, *args))
        else:
            res[name]["ok"] = res[name]["rel"] < TOL
    return res


def main() -> int:
    names = {"dot_a": "dot_128x8x128", "dot_b": "dot_128x128x8",
             "tile": "fused_tile", "dot_c": "dotgen_contract_dim0"}
    ok = [probes.report(names[k], r["ok"], **{
        n: r[n] for n in ("rel", "rel_f64", "plain_rel_f64") if n in r})
        for k, r in run().items()]
    print("MXU_PROBE:", "ALL PASS" if all(ok) else "FAILURES", flush=True)
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
