"""T2c's n-body pair tile (``csrc/probes.cu::tile_kernel``) held on the CPU
through ``tile_arith``, a torch copy of the kernel's float32 order (r^2
by differences with fused multiply-adds, g / 25 = rsqrt(r^2) - 1, the
force summed j in order, times 25 at the end): it passes the probe's own
gate, ``tile_check`` (error against float64 at most max(1e-5,
4x the float32 plain version's)), on the probe's inputs and on a batch
drawn as chip_smoke.py draws its 8,192 tiles. The kernel runs only on the
card, where chip_smoke.py holds it to the same gate."""

import pytest
import torch

from meso_tpu_torch.probes import toy_mxu_tile
from test_torch_imports import one_torch_thread  # noqa: F401


def _fma(a, b, c):
    """float32 a * b + c rounded once: the product of two float32 values
    is exact in float64, and the sum rounds there first (a double
    rounding that can differ from a true fused multiply-add in the last
    bit, rarely)."""
    return (a.double() * b.double() + c.double()).float()


def tile_arith(ai, bj):
    """The kernel's arithmetic in torch, in its order: per j in order, dr
    = x_i - x_j, r^2 = fma(dz, dz, fma(dy, dy, dx dx)), g / 25 = rsqrt(r^2)
    - 1 where 1e-12 < r^2 < 1, F_i = fma(g / 25, dr, F_i); out = 25 F_i.
    float32 (``torch.rsqrt`` for the card's approximate one)."""
    xi = ai[..., :, :3]
    xj = bj[..., :3, :].transpose(-1, -2)
    acc = torch.zeros_like(xi)
    for j in range(xj.shape[-2]):
        d = xi - xj[..., j:j + 1, :]
        r2 = _fma(d[..., 2], d[..., 2],
                  _fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))
        ok = (r2 < 1.0) & (r2 > 1e-12)
        g = torch.where(ok, torch.rsqrt(r2) - 1.0, torch.zeros_like(r2))
        acc = _fma(g[..., None], d, acc)
    return 25.0 * acc


@pytest.mark.parametrize("batch,seed", [(1, 0), (64, 1)])
def test_tile_arith_passes_tile_check(batch, seed):
    ai, bj = toy_mxu_tile.inputs(batch, seed=seed, device="cpu")["tile"]
    got = tile_arith(ai, bj)
    assert got.shape == ai.shape[:-1] + (3,) and got.dtype == torch.float32
    res = toy_mxu_tile.tile_check(got, ai, bj)
    assert res["ok"], res
    # no cancellation: closer to float64 than the plain version's
    # expansion of r^2
    assert res["rel_f64"] <= res["plain_rel_f64"], res


def test_tile_arith_drops_coincident_and_distant_pairs():
    """A source on top of a target (r^2 = 0, where rsqrt is infinite) adds
    nothing to that target, and a source beyond every target's cutoff
    nothing to any (g = 0, and an FMA by 0 leaves the sum as it was): the
    output is finite and, bitwise, the output without them."""
    ai, bj = toy_mxu_tile.inputs(device="cpu")["tile"]
    bj = bj.clone()
    bj[:3, 0] = ai[5, :3]         # j = 0 on top of i = 5
    bj[:3, 1] = ai[5, :3] + 10.0  # j = 1 far from every i
    bj[3] = (bj[:3] * bj[:3]).sum(0)
    got = tile_arith(ai, bj)
    assert torch.isfinite(got).all()
    assert toy_mxu_tile.tile_check(got, ai, bj)["ok"]
    # row 5 without j = 0 (the other rows do feel j = 0), every row
    # without j = 1
    torch.testing.assert_close(got[5],
                               tile_arith(ai, bj[:, 1:])[5],
                               rtol=0, atol=0)
    without_1 = torch.cat([bj[:, :1], bj[:, 2:]], 1)
    torch.testing.assert_close(got, tile_arith(ai, without_1),
                               rtol=0, atol=0)
