// Device helpers shared by the kernels of meso_tpu_torch (sm_90a): the
// counter RNG, bitwise equal to meso_tpu/core/rng.py and to the plain
// torch versions in meso_tpu_torch/core/rng.py.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace meso {

constexpr uint32_t kDelta = 0x9E3779B9u;
constexpr uint32_t kK2 = 0xC2B2AE35u;
constexpr uint32_t kK3 = 0x27D4EB2Fu;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t tea_v0(uint32_t v0, uint32_t v1,
                                           uint32_t k0, uint32_t k1,
                                           int rounds) {
  uint32_t s = 0u;
  for (int r = 0; r < rounds; ++r) {
    s += kDelta;
    v0 += ((v1 << 4) + k0) ^ (v1 + s) ^ ((v1 >> 5) + k1);
    v1 += ((v0 << 4) + kK2) ^ (v0 + s) ^ ((v0 >> 5) + kK3);
  }
  return v0;
}

__device__ __forceinline__ uint32_t combine_symmetric(uint32_t hi,
                                                      uint32_t hj) {
  uint32_t a = hi + hj;
  const uint32_t b = hi ^ hj;
  a ^= a >> 16;
  a *= 0x7FEB352Du;
  a ^= b;
  a ^= a >> 15;
  a *= 0x846CA68Bu;
  a ^= a >> 16;
  return a;
}

__device__ __forceinline__ float u32_to_symmetric_uniform(uint32_t u) {
  // top 23 bits through int32: exact in float32
  const float unit = static_cast<float>(static_cast<int>(u >> 9)) *
                     1.1920928955078125e-07f;
  return (unit - 0.5f) * 3.4641016151377544f;
}

// An independent zero-mean unit-variance stream of a pair hash
// (rng.uniform_stream): eDPD draws theta from salt 0 and zeta from salt 1,
// tDPD theta from salt 0 and species s from salt 2 + s.
__device__ __forceinline__ float uniform_stream(uint32_t h, uint32_t salt) {
  uint32_t a = h ^ (salt * 0x9E3779B9u);
  a ^= a >> 16;
  a *= 0x2C1B3C6Du;
  a ^= a >> 12;
  a *= 0x297A2D39u;
  a ^= a >> 15;
  return u32_to_symmetric_uniform(a);
}

// Symmetric pair hash: TEA-rounds on (min tag, max tag, step, seed) in the
// TEA tier, combine_symmetric of the per-particle hashes in the fast tier.
template <bool kTea>
__device__ __forceinline__ uint32_t pair_hash(int32_t tag_i, int32_t tag_j,
                                              uint32_t h_i, uint32_t h_j,
                                              uint32_t step, uint32_t seed,
                                              int rounds) {
  if (kTea) {
    const int32_t lo = tag_i < tag_j ? tag_i : tag_j;
    const int32_t hi = tag_i < tag_j ? tag_j : tag_i;
    return tea_v0(static_cast<uint32_t>(lo), static_cast<uint32_t>(hi), step,
                  seed, rounds);
  }
  return combine_symmetric(h_i, h_j);
}

}  // namespace meso
