"""Counter-based, per-pair symmetric random numbers (port of
``meso_tpu/core/rng.py``).

theta_ij is a pure function of (min(tag_i, tag_j), max(tag_i, tag_j),
step, seed): both rows of a pair regenerate the same number, and no RNG
state exists. Every function here except ``maxwell_velocities`` is bitwise
equal to its JAX counterpart.

uint32 arithmetic: PyTorch on the CPU implements neither ``+`` nor the
shifts for ``torch.uint32``, so these plain versions hold each uint32 value
in an int64 tensor, in [0, 2^32), and mask with ``& 0xFFFFFFFF`` after every
operation that can carry out of 32 bits. Products go through ``_mul32``,
which splits the constant so that no int64 product overflows. The CUDA
kernels (``csrc/pair_dpd_v3.cu``) do the same arithmetic in native uint32.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_DELTA = 0x9E3779B9
_K2 = 0xC2B2AE35
_K3 = 0x27D4EB2F
_U23_TO_UNIT = 1.1920928955078125e-07  # 2^-23
_SQRT12 = 3.4641016151377544  # sqrt(12): uniform -> unit variance


def _u32(x):
    """uint32 bits of an int tensor (any int dtype) or Python int, held in
    int64 (tensors) or a Python int."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _mul32(a, c: int):
    """(a * c) mod 2^32 for a in [0, 2^32) and a constant c < 2^32, with
    every partial product below 2^49."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def tea(v0, v1, k0, k1, rounds: int = 8):
    """Tiny Encryption Algorithm with a (k0, k1, K2, K3) key schedule.
    Returns the mixed (v0, v1) as uint32 values in int64."""
    v0, v1, k0, k1 = _u32(v0), _u32(v1), _u32(k0), _u32(k1)
    s = 0
    for _ in range(rounds):
        s = (s + _DELTA) & _M32
        v0 = (v0 + (((v1 << 4) + k0) ^ (v1 + s) ^ ((v1 >> 5) + k1))) & _M32
        v1 = (v1 + (((v0 << 4) + _K2) ^ (v0 + s) ^ ((v0 >> 5) + _K3))) & _M32
    return v0, v1


def _u32_to_symmetric_uniform(u: torch.Tensor) -> torch.Tensor:
    """uint32 -> zero-mean unit-variance float32 uniform on (-sqrt 3, sqrt 3),
    from the top 23 bits (exact through int32 and float32)."""
    bits = (u >> 9).to(torch.int32)                        # [0, 2^23)
    unit = bits.to(torch.float32) * _U23_TO_UNIT           # [0, 1)
    return (unit - 0.5) * _SQRT12


def pair_uniform_tea(tag_i, tag_j, step, seed, rounds: int = 8):
    """Symmetric theta_ij from TEA-``rounds`` on the sorted tag pair."""
    lo = torch.minimum(tag_i, tag_j)
    hi = torch.maximum(tag_i, tag_j)
    v0, _ = tea(lo, hi, step, seed, rounds=rounds)
    return _u32_to_symmetric_uniform(v0)


def particle_hash(tag, step, seed, rounds: int = 8):
    """Per-particle well-mixed uint32 (one TEA evaluation per particle).

    The plain version of the ``particle_hash`` CUDA kernel; see
    ``kernels.pair_dpd_v3.particle_hash_v3`` for the dispatching wrapper."""
    t = _u32(tag)
    v0, _ = tea(t, t ^ 0xDEADBEEF, step, seed, rounds=rounds)
    return v0


def combine_symmetric(h_i, h_j):
    """Short symmetric mixer of two already-random uint32s."""
    h_i, h_j = _u32(h_i), _u32(h_j)
    a = (h_i + h_j) & _M32
    b = h_i ^ h_j
    a = a ^ (a >> 16)
    a = _mul32(a, 0x7FEB352D)
    a = a ^ b
    a = a ^ (a >> 15)
    a = _mul32(a, 0x846CA68B)
    a = a ^ (a >> 16)
    return a


def pair_uniform_fast(h_i, h_j):
    """Symmetric theta_ij from precomputed per-particle hashes."""
    return _u32_to_symmetric_uniform(combine_symmetric(h_i, h_j))


def uniform_stream(h, salt: int):
    """An independent symmetric-uniform stream from a pair hash and a salt."""
    a = _u32(h) ^ _mul32(_u32(salt), 0x9E3779B9)
    a = a ^ (a >> 16)
    a = _mul32(a, 0x2C1B3C6D)
    a = a ^ (a >> 12)
    a = _mul32(a, 0x297A2D39)
    a = a ^ (a >> 15)
    return _u32_to_symmetric_uniform(a)


def pair_hash_tea(tag_i, tag_j, step, seed, rounds: int = 8):
    """Symmetric per-pair uint32 from full TEA on the sorted tag pair."""
    lo = torch.minimum(tag_i, tag_j)
    hi = torch.maximum(tag_i, tag_j)
    v0, _ = tea(lo, hi, step, seed, rounds=rounds)
    return v0


def pair_hash(tag_i, tag_j, step, seed, rounds: int = 8,
              rng_mode: str = "fast"):
    """The symmetric pair hash the transport models draw their streams
    from: ``pair_hash_tea`` in the TEA tier, ``combine_symmetric`` of the
    two particle hashes in the fast tier (meso_tpu/ops/edpd.py:102-110 and
    ops/tdpd.py:89-96 write this choice out in place)."""
    if rng_mode == "tea":
        return pair_hash_tea(tag_i, tag_j, step, seed, rounds=rounds)
    if rng_mode == "fast":
        return combine_symmetric(particle_hash(tag_i, step, seed, rounds),
                                 particle_hash(tag_j, step, seed, rounds))
    raise ValueError(f"unknown rng_mode {rng_mode!r}")


def maxwell_velocities(generator: torch.Generator, n: int, kt: float, mass,
                       dim: int = 3, device=None) -> torch.Tensor:
    """`velocity create`-style Maxwell init: draw, zero the momentum,
    rescale so that the kinetic temperature (dim*(n-1) degrees of freedom)
    is exactly ``kt``. Draws come from ``generator``, not from JAX's keys."""
    mass = torch.as_tensor(mass, dtype=torch.float32, device=device)
    v = torch.randn((n, dim), generator=generator, dtype=torch.float32,
                    device=device) * torch.sqrt(kt / mass).reshape(-1, 1)
    m_col = mass.reshape(-1, 1) if mass.ndim else mass
    v = v - torch.mean(m_col * v, dim=0) / torch.mean(mass)
    ke2 = torch.sum(m_col * v * v)
    dof = dim * (n - 1)
    return v * torch.sqrt(dof * kt / ke2)
