// Classic-DPD pair forces on bucket rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel meso_tpu/kernels/pair_dpd_v3.py::_v3_kernel
// (classic model) and its in-kernel per-particle hash (hash_of,
// pair_dpd_v3.py:161-167). Two kernels cover its cases:
// pair_dpd_v3_kernel the main path's (one particle type, s_exp = 1, no
// exclusions), pair_dpd_v3_general_kernel every case (per-type-pair tables,
// s_exp != 1, special-bonds exclusions, debug_pairs accounting).
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

// The general case of _v3_kernel (pair_dpd_v3.py:197-212, 227-228,
// 245-248, 324-356), the same full traversal as pair_dpd_v3_kernel:
// - per-type-pair tables (T x T, row-major, indexed typ_i * T + typ_j):
//   a, gamma, sigma / sqrt(dt), rc and 1/rc per pair; the walk tests the
//   table's largest rc^2 (the cells are sized on it), the visitor the
//   pair's own rc^2;
// - s_exp != 1: wr = max(w, 0)^s_exp and fmag = a w - gamma wr^2 ev +
//   s wr theta (the conservative part keeps w); s_exp = 1 takes
//   pair_dpd_v3_kernel's factored form;
// - exclusions: fmag (and so the virial) times excl_w when tag_j is one of
//   the n_excl tags of excl[tag_i]; excl has excl_rows rows;
// - debug: fx = the in-range partners, fy = the sum of their keys
//   h_j >> 18 (14 bits, exact in fp32), fz = 0, no virial. h is the
//   per-particle hash in both RNG tiers in this mode.
// The visitor recomputes r^2 without fused multiply-adds (__fmul_rn,
// __fadd_rn), as the plain version sums it, and the walk's test has a
// 1e-4 margin on the largest rc^2: both then take exactly the same pairs,
// which the bitwise debug counts need.
// Run-time flags (s_exp, n_excl, debug, need_virial) keep it to four
// instantiations; the main path's kernel above stays as it was.
// What bounds it: as pair_dpd_v3_kernel, the walk's candidate loads, whose
// latency resident warps hide; and a warp runs the in-range visitor
// whenever one of its 32 lanes has an in-range candidate (~1 in 4
// candidate steps at rho 3), so the visitor's extra table, type and
// exclusion loads cost it 1.3-1.4x K1's time on the same rows (H100).
// Occupancy decides the rest: unbounded, ptxas gives it 55-61 registers (4
// blocks of kThreads per SM); holding the row's tables and exclusions in
// registers took it to 76 (3 blocks) and 1.2x slower; asking for 5 blocks
// caps it at 48 with 20-48 bytes of spills and runs ~2% faster.
constexpr int kGeneralMinBlocks = 5;

template <bool kMinImage, bool kTea>
__global__ void __launch_bounds__(kThreads, kGeneralMinBlocks)
pair_dpd_v3_general_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const int32_t* __restrict__ tag, const int32_t* __restrict__ typ,
    const uint8_t* __restrict__ valid, const uint32_t* __restrict__ h,
    const float* __restrict__ a_tab, const float* __restrict__ gamma_tab,
    const float* __restrict__ sigma_tab, const float* __restrict__ rc_tab,
    int n_types, const int32_t* __restrict__ excl, int excl_rows,
    int n_excl, const float* __restrict__ excl_w,
    const float* __restrict__ box_lo, const float* __restrict__ box_hi,
    float* __restrict__ f, float* __restrict__ vir, int nx, int ny, int nz,
    int k, int xr, float dt_inv_sqrt, float s_exp, int debug,
    int need_virial, uint32_t step, uint32_t seed, int rounds) {
  const int nr = nx * ny * nz * k;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nr) return;

  float fx = 0.0f, fy = 0.0f, fz = 0.0f, vsum = 0.0f;
  if (valid[row]) {
    float rc2_max = 0.0f;
    for (int p = 0; p < n_types * n_types; ++p) {
      rc2_max = fmaxf(rc2_max, rc_tab[p] * rc_tab[p]);
    }
    const int t_row = typ[row] * n_types;
    const float vxi = v[3 * row], vyi = v[3 * row + 1], vzi = v[3 * row + 2];
    const int32_t tag_i = tag[row];
    const uint32_t h_i = (kTea && !debug) ? 0u : h[row];
    const bool has_excl = n_excl > 0 && tag_i >= 0 && tag_i < excl_rows;
    const int32_t* ex_i = excl + static_cast<size_t>(has_excl ? tag_i : 0) *
                                     static_cast<size_t>(n_excl);
    const float w_excl = n_excl > 0 ? excl_w[0] : 1.0f;
    for_each_pair<kMinImage>(
        x, valid, box_lo, box_hi, row, nx, ny, nz, k, xr,
        rc2_max * 1.0001f,
        [&](int j, float drx, float dry, float drz, float) {
          const float r2 = __fadd_rn(
              __fadd_rn(__fmul_rn(drx, drx), __fmul_rn(dry, dry)),
              __fmul_rn(drz, drz));
          const int p = n_types == 1 ? 0 : t_row + typ[j];
          const float rc = rc_tab[p];
          if (!(r2 < rc * rc)) return;
          if (debug) {
            fx += 1.0f;
            fy += static_cast<float>(h[j] >> 18);
            return;
          }
          const float a = a_tab[p];
          const float gamma = gamma_tab[p];
          const float s = sigma_tab[p] * dt_inv_sqrt;
          const float rinv = rsqrtf(r2);
          const float rr = r2 * rinv;
          const float w = 1.0f - rr * (1.0f / rc);
          const float ev = (drx * (vxi - v[3 * j]) +
                            dry * (vyi - v[3 * j + 1]) +
                            drz * (vzi - v[3 * j + 2])) * rinv;
          const uint32_t hp = pair_hash<kTea>(tag_i, kTea ? tag[j] : 0,
                                              h_i, kTea ? 0u : h[j], step,
                                              seed, rounds);
          const float theta = u32_to_symmetric_uniform(hp);
          float fmag;
          if (s_exp == 1.0f) {
            fmag = w * (a - (gamma * w) * ev + s * theta);
          } else {
            const float wr = powf(fmaxf(w, 0.0f), s_exp);
            fmag = a * w - gamma * (wr * wr) * ev + s * wr * theta;
          }
          if (has_excl) {
            const int32_t tag_j = tag[j];
            for (int e = 0; e < n_excl; ++e) {
              if (ex_i[e] == tag_j) {
                fmag *= w_excl;
                break;
              }
            }
          }
          const float fr = fmag * rinv;
          fx += fr * drx;
          fy += fr * dry;
          fz += fr * drz;
          if (need_virial) vsum += 0.5f * fmag * rr;
        });
  }
  f[3 * row] = fx;
  f[3 * row + 1] = fy;
  f[3 * row + 2] = fz;
  if (vir != nullptr) vir[row] = vsum;
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

template <bool kMinImage, bool kTea>
void launch_general(dim3 grid, cudaStream_t stream, const float* x,
                    const float* v, const int32_t* tag, const int32_t* typ,
                    const uint8_t* valid, const uint32_t* h,
                    const float* a_tab, const float* gamma_tab,
                    const float* sigma_tab, const float* rc_tab, int n_types,
                    const int32_t* excl, int excl_rows, int n_excl,
                    const float* excl_w, const float* box_lo,
                    const float* box_hi, float* f, float* vir, int nx,
                    int ny, int nz, int k, int xr, float dt_inv_sqrt,
                    float s_exp, int debug, int need_virial, uint32_t step,
                    uint32_t seed, int rounds) {
  pair_dpd_v3_general_kernel<kMinImage, kTea><<<grid, kThreads, 0, stream>>>(
      x, v, tag, typ, valid, h, a_tab, gamma_tab, sigma_tab, rc_tab, n_types,
      excl, excl_rows, n_excl, excl_w, box_lo, box_hi, f, vir, nx, ny, nz, k,
      xr, dt_inv_sqrt, s_exp, debug, need_virial, step, seed, rounds);
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

extern "C" int meso_pair_dpd_v3_general(
    const void* x, const void* v, const void* tag, const void* typ,
    const void* valid, const void* h, const void* a_tab,
    const void* gamma_tab, const void* sigma_tab, const void* rc_tab,
    int n_types, const void* excl, int excl_rows, int n_excl,
    const void* excl_w, const void* box_lo, const void* box_hi, void* f,
    void* vir, int nx, int ny, int nz, int k, int xr, int min_image, int tea,
    int debug, int need_virial, float dt_inv_sqrt, float s_exp,
    uint32_t step, uint32_t seed, int rounds, void* stream) {
  const int nr = nx * ny * nz * k;
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((nr + kThreads - 1) / kThreads);
#define MESO_GENERAL_ARGS                                                    \
  grid, static_cast<cudaStream_t>(stream), static_cast<const float*>(x),    \
      static_cast<const float*>(v), static_cast<const int32_t*>(tag),       \
      static_cast<const int32_t*>(typ), static_cast<const uint8_t*>(valid), \
      static_cast<const uint32_t*>(h), static_cast<const float*>(a_tab),    \
      static_cast<const float*>(gamma_tab),                                 \
      static_cast<const float*>(sigma_tab),                                 \
      static_cast<const float*>(rc_tab), n_types,                           \
      static_cast<const int32_t*>(excl), excl_rows, n_excl,                 \
      static_cast<const float*>(excl_w), static_cast<const float*>(box_lo), \
      static_cast<const float*>(box_hi), static_cast<float*>(f),            \
      static_cast<float*>(vir), nx, ny, nz, k, xr, dt_inv_sqrt, s_exp,      \
      debug, need_virial, step, seed, rounds
  if (min_image) {
    if (tea) {
      launch_general<true, true>(MESO_GENERAL_ARGS);
    } else {
      launch_general<true, false>(MESO_GENERAL_ARGS);
    }
  } else if (tea) {
    launch_general<false, true>(MESO_GENERAL_ARGS);
  } else {
    launch_general<false, false>(MESO_GENERAL_ARGS);
  }
#undef MESO_GENERAL_ARGS
  return static_cast<int>(cudaGetLastError());
}
