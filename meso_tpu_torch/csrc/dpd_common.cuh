// Device helpers shared by the pair kernels of meso_tpu_torch (sm_90a):
// the counter RNG (bitwise equal to meso_tpu/core/rng.py and to the plain
// torch versions in meso_tpu_torch/core/rng.py) and the stencil walk over
// bucket rows.
//
// Bucket layout: row = ((cy * ncz + cz) * K + slot) * ncx + cx
// (meso_tpu/neighbor/bucket_layout.py:6-9); valid is the (nr,) bool mask,
// one byte per row.

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

// Periodic stencil index: wraps c into [0, n) and returns the coordinate
// shift the source needs when the index wrapped (no-min-image mode).
__device__ __forceinline__ int wrap_index(int c, int n, float len,
                                          float* shift) {
  if (c < 0) {
    *shift = -len;
    return c + n;
  }
  if (c >= n) {
    *shift = len;
    return c - n;
  }
  *shift = 0.0f;
  return c;
}

// Calls visit(j, drx, dry, drz, r2) for every valid source row j in the
// slot-cell stencil of target row `row` (dy, dz in {-1, 0, 1}, dx in
// {-xr .. xr}, all K slots) with 0 < r2 < rc2, where dr = x_row - x_j.
//
// Periodicity: with kMinImage = false (System.wrap_mode = "rebuild")
// positions are wrapped only at rebuild time, so no minimum image is
// taken: when the stencil's cell index wraps on an axis the source gets
// -L (below 0) or +L (above n-1) on that axis, exactly the pre-shifted pad
// copies of meso_tpu/kernels/pair_dpd_v3.py:681-722. dr = (xi - xj) - shift,
// so that the two rows of a pair get exactly opposite dr. Wrap-relief rows
// of cell ncx-1 sit pre-shifted in cell 0 (bucket_layout.py:392-406) and
// need nothing more. With kMinImage = true every axis takes
// dr - rint(dr / L) * L.
template <bool kMinImage, typename Visit>
__device__ __forceinline__ void for_each_pair(
    const float* __restrict__ x, const uint8_t* __restrict__ valid,
    const float* __restrict__ box_lo, const float* __restrict__ box_hi,
    int row, int nx, int ny, int nz, int k, int xr, float rc2, Visit&& visit) {
  int t = row;
  const int cx = t % nx;
  t /= nx;
  t /= k;  // slot
  const int cz = t % nz;
  const int cy = t / nz;
  const float lx = box_hi[0] - box_lo[0];
  const float ly = box_hi[1] - box_lo[1];
  const float lz = box_hi[2] - box_lo[2];
  const float inv_lx = 1.0f / lx, inv_ly = 1.0f / ly, inv_lz = 1.0f / lz;
  const float xi = x[3 * row], yi = x[3 * row + 1], zi = x[3 * row + 2];

  for (int dy = -1; dy <= 1; ++dy) {
    float shy;
    const int sy = wrap_index(cy + dy, ny, ly, &shy);
    for (int dz = -1; dz <= 1; ++dz) {
      float shz;
      const int sz = wrap_index(cz + dz, nz, lz, &shz);
      const int yz_base = (sy * nz + sz) * k;
      for (int dx = -xr; dx <= xr; ++dx) {
        float shx;
        const int sx = wrap_index(cx + dx, nx, lx, &shx);
        for (int sl = 0; sl < k; ++sl) {
          const int j = (yz_base + sl) * nx + sx;
          if (!valid[j]) continue;
          float drx = xi - x[3 * j];
          float dry = yi - x[3 * j + 1];
          float drz = zi - x[3 * j + 2];
          if (kMinImage) {
            drx -= rintf(drx * inv_lx) * lx;
            dry -= rintf(dry * inv_ly) * ly;
            drz -= rintf(drz * inv_lz) * lz;
          } else {
            drx -= shx;
            dry -= shy;
            drz -= shz;
          }
          const float r2 = drx * drx + dry * dry + drz * drz;
          if (!(r2 < rc2) || !(r2 > 0.0f)) continue;
          visit(j, drx, dry, drz, r2);
        }
      }
    }
  }
}

}  // namespace meso
