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
// Periodicity and the stencil walk: for_each_pair in dpd_common.cuh.
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

#include "dpd_common.cuh"

namespace {

using namespace meso;

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
    const float a = a_tab[0];
    const float gamma = gamma_tab[0];
    const float s = sigma_tab[0] * dt_inv_sqrt;
    const float rc = rc_tab[0];
    const float inv_rc = 1.0f / rc;
    const float vxi = v[3 * row], vyi = v[3 * row + 1], vzi = v[3 * row + 2];
    const int32_t tag_i = tag[row];
    const uint32_t h_i = kTea ? 0u : h[row];
    for_each_pair<kMinImage>(
        x, valid, box_lo, box_hi, row, nx, ny, nz, k, xr, rc * rc,
        [&](int j, float drx, float dry, float drz, float r2) {
          const float rinv = rsqrtf(r2);
          const float rr = r2 * rinv;
          const float w = 1.0f - rr * inv_rc;
          const float ev = (drx * (vxi - v[3 * j]) +
                            dry * (vyi - v[3 * j + 1]) +
                            drz * (vzi - v[3 * j + 2])) * rinv;
          const uint32_t hp = pair_hash<kTea>(tag_i, kTea ? tag[j] : 0,
                                              h_i, kTea ? 0u : h[j], step,
                                              seed, rounds);
          const float theta = u32_to_symmetric_uniform(hp);
          const float fmag = w * (a - (gamma * w) * ev + s * theta);
          const float fr = fmag * rinv;
          fx += fr * drx;
          fy += fr * dry;
          fz += fr * drz;
          if (kVirial) vsum += 0.5f * fmag * rr;
        });
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
