"""The port's counter RNG (meso_tpu_torch/core/rng.py) against the JAX
package's (meso_tpu/core/rng.py): bitwise equal over grids of tag, step and
seed, including tags near 2^24 and 2^31 - 1 and seeds >= 2^31."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core import rng as jrng
from meso_tpu_torch.core import rng as trng
from test_torch_imports import one_torch_thread  # noqa: F401

TAGS = np.array([1, 2, 3, 7, 100, 4097, 2 ** 24 - 2, 2 ** 24 - 1, 2 ** 24,
                 2 ** 24 + 1, 2 ** 31 - 2, 2 ** 31 - 1], np.int32)
STEPS = [0, 1, 42, 12345, 2 ** 31 - 1]
SEEDS = [0, 77, 928459, 2 ** 31, 2 ** 32 - 1]


def _random_u32(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    u[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    return u


def _u32_equal(jax_out, torch_out):
    np.testing.assert_array_equal(
        np.asarray(jax_out).astype(np.uint32).astype(np.int64),
        torch_out.numpy())


def _f32_bits_equal(jax_out, torch_out):
    np.testing.assert_array_equal(
        np.asarray(jax_out, np.float32).view(np.uint32),
        torch_out.numpy().astype(np.float32).view(np.uint32))


@pytest.mark.parametrize("rounds", [1, 8])
def test_tea_bitwise(rounds):
    v0 = _random_u32(257, 1)
    v1 = _random_u32(257, 2)
    keys = [(0, 0), (42, 77), (2 ** 31 - 1, 2 ** 31), (12345, 2 ** 32 - 1)]
    for k0, k1 in keys:
        j0, j1 = jrng.tea(jnp.asarray(v0), jnp.asarray(v1), jnp.uint32(k0),
                          jnp.uint32(k1), rounds=rounds)
        t0, t1 = trng.tea(torch.from_numpy(v0.astype(np.int64)),
                          torch.from_numpy(v1.astype(np.int64)), k0, k1,
                          rounds=rounds)
        _u32_equal(j0, t0)
        _u32_equal(j1, t1)


@pytest.mark.parametrize("seed", SEEDS)
def test_particle_hash_bitwise(seed):
    tags = torch.from_numpy(TAGS)
    for step in STEPS:
        _u32_equal(jrng.particle_hash(jnp.asarray(TAGS), jnp.int32(step),
                                      jnp.uint32(seed)),
                   trng.particle_hash(tags, step, seed))


def test_combine_symmetric_and_fast_uniform_bitwise():
    hi, hj = _random_u32(4096, 3), _random_u32(4096, 4)
    ti = torch.from_numpy(hi.astype(np.int64))
    tj = torch.from_numpy(hj.astype(np.int64))
    _u32_equal(jrng.combine_symmetric(jnp.asarray(hi), jnp.asarray(hj)),
               trng.combine_symmetric(ti, tj))
    _f32_bits_equal(jrng.pair_uniform_fast(jnp.asarray(hi), jnp.asarray(hj)),
                    trng.pair_uniform_fast(ti, tj))
    # symmetric in its two arguments
    assert torch.equal(trng.combine_symmetric(ti, tj),
                       trng.combine_symmetric(tj, ti))


def test_u32_to_symmetric_uniform_bitwise():
    u = _random_u32(4096, 5)
    _f32_bits_equal(jrng._u32_to_symmetric_uniform(jnp.asarray(u)),
                    trng._u32_to_symmetric_uniform(
                        torch.from_numpy(u.astype(np.int64))))


@pytest.mark.parametrize("seed", SEEDS)
def test_pair_tea_bitwise(seed):
    ti = torch.from_numpy(TAGS)[:, None]
    tj = torch.from_numpy(TAGS)[None, :]
    ji, jj = jnp.asarray(TAGS)[:, None], jnp.asarray(TAGS)[None, :]
    for step in STEPS:
        _f32_bits_equal(jrng.pair_uniform_tea(ji, jj, jnp.int32(step),
                                              jnp.uint32(seed)),
                        trng.pair_uniform_tea(ti, tj, step, seed))
        _u32_equal(jrng.pair_hash_tea(ji, jj, jnp.int32(step),
                                      jnp.uint32(seed)),
                   trng.pair_hash_tea(ti, tj, step, seed))


@pytest.mark.parametrize("salt", [0, 1, 2, 7])
def test_uniform_stream_bitwise(salt):
    h = _random_u32(4096, 6 + salt)
    _f32_bits_equal(jrng.uniform_stream(jnp.asarray(h), salt),
                    trng.uniform_stream(torch.from_numpy(h.astype(np.int64)),
                                        salt))


def test_maxwell_velocities_zero_momentum_exact_kt():
    gen = torch.Generator().manual_seed(3)
    v = trng.maxwell_velocities(gen, 2000, 1.3, 1.0)
    assert v.shape == (2000, 3) and v.dtype == torch.float32
    assert float(v.sum(0).abs().max()) < 1e-3
    kt = float((v.double() ** 2).sum() / (3 * 1999))
    assert abs(kt - 1.3) < 1e-5
