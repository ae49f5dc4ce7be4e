// Classic-DPD pair forces on bucket rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel meso_tpu/kernels/pair_dpd_v3.py::_v3_kernel
// (classic model, one particle type, s_exp = 1, no exclusions), and its
// in-kernel per-particle hash (hash_of, pair_dpd_v3.py:161-167).
//
// Layout: row = ((cy * ncz + cz) * K + slot) * ncx + cx
// (meso_tpu/neighbor/bucket_layout.py:6-9). x and v are (nr, 3) float32,
// tag is (nr,) int32, valid is the (nr,) bool mask (one byte per row).
//
// Design: one thread per target row. The thread decodes (cy, cz, slot, cx)
// from its row and walks the stencil of slot-cells, dy and dz in {-1, 0, 1}
// and dx in {-xr .. xr} (xr = 2 for spill layouts, 1 for strict ones),
// taking all K slots of each cell. It sums fx, fy, fz and, when asked,
// 0.5 * fmag * r in registers and writes its row once. Every pair is thus
// computed by both of its rows (a full traversal, as the reference's own
// GPU design): no atomics, and a deterministic per-row sum. Newton folding
// is left to a later change.
//
// Periodicity: with min_image = 0 (System.wrap_mode = "rebuild", the main
// path) positions are wrapped only at rebuild time, so the thread computes
// no minimum image: when the stencil's cell index wraps on an axis it adds
// -L (below 0) or +L (above n-1) on that axis to the source coordinate,
// exactly the pre-shifted pad copies of pair_dpd_v3.py:681-722. It takes
// dr = (xi - xj) - shift, so that the two rows of a pair get exactly
// opposite dr and the pair forces cancel up to the rounding of the row
// sums. Wrap-relief rows of cell ncx-1 sit pre-shifted in cell 0
// (bucket_layout.py:392-406) and need nothing more. With min_image = 1 the
// thread applies dr - rint(dr / L) * L on every axis.
//
// RNG: the fast tier reads h[j] = TEA-8(tag, tag ^ 0xDEADBEEF, step, seed)
// from particle_hash_kernel (one launch per step) and mixes it with
// combine_symmetric (meso_tpu/core/rng.py:103-117); the TEA tier runs
// TEA-rounds on (min tag, max tag, step, seed) per pair. Both feed the top
// 23 bits into a zero-mean unit-variance uniform (rng.py:67-75).
//
// What bounds it: at the 1M-particle main path (ncell 50^3, K = 16,
// nr = 2,000,000, spill) a row sees 45 slot-cells x 16 slots = 720
// candidates, so a step makes ~1.4e9 candidate tests of ~8 loaded words
// (valid, x, and for the ~2% inside rc also v, h) and ~40 fp32 operations
// for the pairs inside rc. Threads of one warp take neighbouring cx of one
// slot, so their candidate loads are neighbouring addresses, and the same
// cells are read again by the rows of the next slots: L1 and L2 serve most
// of the traffic. Shared-memory cell tiles and Newton folding would cut it
// further and are left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void particle_hash_kernel(const int32_t* __restrict__ tag,
                                     uint32_t* __restrict__ h, int n,
                                     uint32_t step, uint32_t seed,
                                     int rounds) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t t = static_cast<uint32_t>(tag[i]);
  h[i] = tea_v0(t, t ^ 0xDEADBEEFu, step, seed, rounds);
}

template <bool kMinImage, bool kTea, bool kVirial>
__global__ void __launch_bounds__(kThreads)
pair_dpd_v3_kernel(const float* __restrict__ x, const float* __restrict__ v,
                   const int32_t* __restrict__ tag,
                   const uint8_t* __restrict__ valid,
                   const uint32_t* __restrict__ h,
                   const float* __restrict__ a_tab,
                   const float* __restrict__ gamma_tab,
                   const float* __restrict__ sigma_tab,
                   const float* __restrict__ rc_tab,
                   const float* __restrict__ box_lo,
                   const float* __restrict__ box_hi,
                   float* __restrict__ f, float* __restrict__ vir,
                   int nx, int ny, int nz, int k, int xr,
                   float dt_inv_sqrt, uint32_t step, uint32_t seed,
                   int rounds) {
  const int nr = nx * ny * nz * k;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nr) return;

  float fx = 0.0f, fy = 0.0f, fz = 0.0f, vsum = 0.0f;
  if (valid[row]) {
    int t = row;
    const int cx = t % nx;
    t /= nx;
    t /= k;  // slot
    const int cz = t % nz;
    const int cy = t / nz;

    const float a = a_tab[0];
    const float gamma = gamma_tab[0];
    const float s = sigma_tab[0] * dt_inv_sqrt;
    const float rc = rc_tab[0];
    const float rc2 = rc * rc;
    const float inv_rc = 1.0f / rc;
    const float lx = box_hi[0] - box_lo[0];
    const float ly = box_hi[1] - box_lo[1];
    const float lz = box_hi[2] - box_lo[2];
    const float inv_lx = 1.0f / lx, inv_ly = 1.0f / ly, inv_lz = 1.0f / lz;

    const float xi = x[3 * row], yi = x[3 * row + 1], zi = x[3 * row + 2];
    const float vxi = v[3 * row], vyi = v[3 * row + 1], vzi = v[3 * row + 2];
    const int32_t tag_i = tag[row];
    const uint32_t h_i = kTea ? 0u : h[row];

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
              // (xi - xj) - shift, not xi - (xj + shift): the pair's two
              // rows then get exactly opposite dr, and forces
              drx -= shx;
              dry -= shy;
              drz -= shz;
            }
            const float r2 = drx * drx + dry * dry + drz * drz;
            if (!(r2 < rc2) || !(r2 > 0.0f)) continue;
            const float rinv = rsqrtf(r2);
            const float rr = r2 * rinv;
            const float w = 1.0f - rr * inv_rc;
            const float ev = (drx * (vxi - v[3 * j]) +
                              dry * (vyi - v[3 * j + 1]) +
                              drz * (vzi - v[3 * j + 2])) * rinv;
            uint32_t hp;
            if (kTea) {
              const int32_t tag_j = tag[j];
              const int32_t lo = tag_i < tag_j ? tag_i : tag_j;
              const int32_t hi = tag_i < tag_j ? tag_j : tag_i;
              hp = tea_v0(static_cast<uint32_t>(lo), static_cast<uint32_t>(hi),
                          step, seed, rounds);
            } else {
              hp = combine_symmetric(h_i, h[j]);
            }
            const float theta = u32_to_symmetric_uniform(hp);
            const float fmag = w * (a - (gamma * w) * ev + s * theta);
            const float fr = fmag * rinv;
            fx += fr * drx;
            fy += fr * dry;
            fz += fr * drz;
            if (kVirial) vsum += 0.5f * fmag * rr;
          }
        }
      }
    }
  }
  f[3 * row] = fx;
  f[3 * row + 1] = fy;
  f[3 * row + 2] = fz;
  if (kVirial) vir[row] = vsum;
}

template <bool kMinImage, bool kTea, bool kVirial>
void launch_pair(dim3 grid, cudaStream_t stream, const float* x,
                 const float* v, const int32_t* tag, const uint8_t* valid,
                 const uint32_t* h, const float* a_tab,
                 const float* gamma_tab, const float* sigma_tab,
                 const float* rc_tab, const float* box_lo,
                 const float* box_hi, float* f, float* vir, int nx, int ny,
                 int nz, int k, int xr, float dt_inv_sqrt, uint32_t step,
                 uint32_t seed, int rounds) {
  pair_dpd_v3_kernel<kMinImage, kTea, kVirial>
      <<<grid, kThreads, 0, stream>>>(x, v, tag, valid, h, a_tab, gamma_tab,
                                      sigma_tab, rc_tab, box_lo, box_hi, f,
                                      vir, nx, ny, nz, k, xr, dt_inv_sqrt,
                                      step, seed, rounds);
}

}  // namespace

extern "C" int meso_particle_hash(const void* tag, void* h, int n,
                                  uint32_t step, uint32_t seed, int rounds,
                                  void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    particle_hash_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tag), static_cast<uint32_t*>(h), n, step,
        seed, rounds);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meso_pair_dpd_v3(const void* x, const void* v, const void* tag,
                                const void* valid, const void* h,
                                const void* a_tab, const void* gamma_tab,
                                const void* sigma_tab, const void* rc_tab,
                                const void* box_lo, const void* box_hi,
                                void* f, void* vir, int nx, int ny, int nz,
                                int k, int xr, int min_image, int tea,
                                int need_virial, float dt_inv_sqrt,
                                uint32_t step, uint32_t seed, int rounds,
                                void* stream) {
  const int nr = nx * ny * nz * k;
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((nr + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* vp = static_cast<const float*>(v);
  const auto* tp = static_cast<const int32_t*>(tag);
  const auto* mp = static_cast<const uint8_t*>(valid);
  const auto* hp = static_cast<const uint32_t*>(h);
  const auto* ap = static_cast<const float*>(a_tab);
  const auto* gp = static_cast<const float*>(gamma_tab);
  const auto* sp = static_cast<const float*>(sigma_tab);
  const auto* rp = static_cast<const float*>(rc_tab);
  const auto* lo = static_cast<const float*>(box_lo);
  const auto* hi = static_cast<const float*>(box_hi);
  auto* fp = static_cast<float*>(f);
  auto* wp = static_cast<float*>(vir);
#define MESO_PAIR_ARGS                                                     \
  grid, st, xp, vp, tp, mp, hp, ap, gp, sp, rp, lo, hi, fp, wp, nx, ny, nz, \
      k, xr, dt_inv_sqrt, step, seed, rounds
  const int sel = (min_image ? 4 : 0) | (tea ? 2 : 0) | (need_virial ? 1 : 0);
  switch (sel) {
    case 0: launch_pair<false, false, false>(MESO_PAIR_ARGS); break;
    case 1: launch_pair<false, false, true>(MESO_PAIR_ARGS); break;
    case 2: launch_pair<false, true, false>(MESO_PAIR_ARGS); break;
    case 3: launch_pair<false, true, true>(MESO_PAIR_ARGS); break;
    case 4: launch_pair<true, false, false>(MESO_PAIR_ARGS); break;
    case 5: launch_pair<true, false, true>(MESO_PAIR_ARGS); break;
    case 6: launch_pair<true, true, false>(MESO_PAIR_ARGS); break;
    default: launch_pair<true, true, true>(MESO_PAIR_ARGS); break;
  }
#undef MESO_PAIR_ARGS
  return static_cast<int>(cudaGetLastError());
}
