"""The pair noise of the configurations, in plain integer arithmetic.

A frozen copy of the counter-based generator the DPD engine specifies (the
"fast" tier): one TEA evaluation per particle and step, then a short
symmetric mixer of the two particles' words, whose top 23 bits become a
zero-mean, unit-variance uniform number. theta_ij is a pure function of
(tag_i, tag_j, step, seed), so the reference regenerates every number the
program drew without reading any of its state.

uint32 values are held in int64 tensors and masked after each operation
that can carry out of 32 bits; products split the constant so that no
int64 product overflows.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
DELTA = 0x9E3779B9
KEY2, KEY3 = 0xC2B2AE35, 0x27D4EB2F
TWO_POW_M23 = 1.1920928955078125e-07
SQRT12 = 3.4641016151377544


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def tea_v0(v0: torch.Tensor, v1: torch.Tensor, k0: int, k1: int,
           rounds: int) -> torch.Tensor:
    """First output word of TEA with the key (k0, k1, KEY2, KEY3)."""
    s = 0
    for _ in range(rounds):
        s = (s + DELTA) & M32
        v0 = (v0 + (((v1 << 4) + k0) ^ (v1 + s) ^ ((v1 >> 5) + k1))) & M32
        v1 = (v1 + (((v0 << 4) + KEY2) ^ (v0 + s) ^ ((v0 >> 5) + KEY3))) & M32
    return v0


def particle_words(tag: torch.Tensor, step: int, seed: int,
                   rounds: int) -> torch.Tensor:
    """One mixed uint32 per particle and step."""
    t = tag.to(torch.int64) & M32
    return tea_v0(t, t ^ 0xDEADBEEF, step & M32, seed & M32, rounds)


def pair_uniform(h_i: torch.Tensor, h_j: torch.Tensor) -> torch.Tensor:
    """Symmetric theta_ij (float32) from the two particles' words."""
    a = (h_i + h_j) & M32
    b = h_i ^ h_j
    a = a ^ (a >> 16)
    a = _mul32(a, 0x7FEB352D)
    a = a ^ b
    a = a ^ (a >> 15)
    a = _mul32(a, 0x846CA68B)
    a = a ^ (a >> 16)
    unit = (a >> 9).to(torch.int32).to(torch.float32) * TWO_POW_M23
    return (unit - 0.5) * SQRT12
