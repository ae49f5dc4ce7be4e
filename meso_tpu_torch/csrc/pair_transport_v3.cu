// eDPD and tDPD pair forces and transport fluxes on bucket rows, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel meso_tpu/kernels/pair_dpd_v3.py::_v3_kernel
// (line 75) with model="edpd" (K2, bucket_forces_pallas_v3_edpd, :871) and
// model="tdpd" (K3, bucket_forces_pallas_v3_tdpd, :896).
//
// Design: K1's (pair_dpd_v3.cu). One thread per target row walks the 27
// (strict) or 45 (spill) slot-cell stencil with for_each_pair
// (dpd_common.cuh) and sums its own force, virial and flux in registers: a
// full traversal. The TPU kernel visits each pair once (Newton folding)
// and so has to split eDPD's heat into a part both sides gain (q^V) and a
// part they exchange (q^C + q^R), returned through a reaction plane. Here
// row i computes q(i <- j) directly, as the dense oracles do
// (meso_tpu/ops/edpd.py:68-99, ops/tdpd.py:72-86): no atomics and no split.
//
// eDPD, per pair (w = 1 - r/rc, sign = +1 if tag_i < tag_j else -1):
//   sigma^2 = 4 gamma T_i T_j / (T_i + T_j),  theta = uniform_stream(hp, 0)
//   F   = a w - gamma w^2 (e.v) + sigma w theta / sqrt(dt)
//   k   = kappa (T_i + T_j)^2 / 4
//   q_C = k w^2 (1/T_i - 1/T_j)
//   q_V = 1/2 [w^2 (gamma (e.v)^2 - sigma^2/m) - sigma w (e.v) theta/sqrt(dt)]
//   q_R = sqrt(2k) w sign uniform_stream(hp, 1) / sqrt(dt)
//   dT_i/dt = sum_j (q_C + q_V + q_R) / cv.
// tDPD: the classic force, and for each species s inside r < rcc, with
// w_dc = (1 - r/rcc)^s1,
//   dC_i,s/dt = sum_j -kappa_s w_dc (C_i,s - C_j,s)
//               + eps_s sqrt(w_dc) sign uniform_stream(hp, 2 + s) / sqrt(dt).
// The species ride in blocks of kSpeciesBlock: the per-row sums of one
// block stay in registers (unrolled loops guarded by S), grid.y walks the
// blocks, and only block 0 writes f and the virial, so any S takes one
// launch. Up to kSpeciesBlock species take an instantiation whose block
// offset is the constant 0 (kBlocks false), so the species streams' salts
// fold into constants as they did before the blocks. rcc <= rc_ij for
// every type pair is required (the visitor sees a pair only inside its own
// rc_ij; ROADMAP Queue 3, R9); the wrapper checks it.
// Per-type-pair tables (T x T, row-major, typ_i * T + typ_j), as
// pair_dpd_v3_general_kernel takes them: with T > 1 the walk tests the
// table's largest rc^2 with a 1e-4 margin and the visitor the pair's own
// rc_ij on r^2 summed without fused multiply-adds (the plain version's
// order); a, gamma and kappa (eDPD) or sigma (tDPD) are read per pair. A
// template flag (kTypes) keeps the one-type instantiations as they were,
// coefficients in registers (a run-time test alone took K2 from 64 to 108
// registers).
//
// What bounds it: at the 1M-particle shape (ncell 50^3, K = 16,
// nr = 2,000,000, spill) a row sees 720 candidates, ~1.4e9 candidate tests
// per call, as in K1; ~12.9M ordered pairs are inside rc (N rho 4 pi / 3).
// The distinct bytes (x, v, T or C, tag, mask, h in; f, dT/dt or dC/dt and
// the per-row virial out) are 114 MB for eDPD and 130 MB for two tDPD
// species, 34-39 us at 3.35 TB/s; the in-range arithmetic (eDPD: 74 fp32
// operations a pair, three of them divisions and two sqrt, and 33 integer
// ones for the hash streams) is ~1.4e9 operations, ~21 us at 67 TFLOP/s.
// Neither bounds it: the candidate loads and compares do, served by L1 and
// L2 since the threads of a warp read neighbouring rows. Shared-memory
// cell tiles and Newton folding (half the candidates) are left to later
// work.

#include "dpd_common.cuh"

namespace {

using namespace meso;

constexpr int kSpeciesBlock = 8;

__global__ void uniform_stream_kernel(const uint32_t* __restrict__ h,
                                      float* __restrict__ out, int n,
                                      uint32_t salt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = uniform_stream(h[i], salt);
}

// The walk's cutoff: rc^2 for one type; the table's largest rc^2 with a
// 1e-4 margin for several (the visitor then tests the pair's own rc_ij).
__device__ __forceinline__ float walk_rc2(const float* __restrict__ rc_tab,
                                          int n_types) {
  if (n_types == 1) return rc_tab[0] * rc_tab[0];
  float rc2 = 0.0f;
  for (int p = 0; p < n_types * n_types; ++p) {
    rc2 = fmaxf(rc2, rc_tab[p] * rc_tab[p]);
  }
  return rc2 * 1.0001f;
}

// r^2 summed in x, y, z order without fused multiply-adds, as the plain
// versions sum it.
__device__ __forceinline__ float unfused_r2(float drx, float dry, float drz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(drx, drx), __fmul_rn(dry, dry)),
                   __fmul_rn(drz, drz));
}

template <bool kMinImage, bool kTea, bool kTypes>
__global__ void __launch_bounds__(kThreads)
pair_edpd_v3_kernel(const float* __restrict__ x, const float* __restrict__ v,
                    const float* __restrict__ temp,
                    const int32_t* __restrict__ tag,
                    const int32_t* __restrict__ typ,
                    const uint8_t* __restrict__ valid,
                    const uint32_t* __restrict__ h,
                    const float* __restrict__ a_tab,
                    const float* __restrict__ gamma_tab,
                    const float* __restrict__ kappa_tab,
                    const float* __restrict__ rc_tab, int n_types,
                    const float* __restrict__ box_lo,
                    const float* __restrict__ box_hi,
                    float* __restrict__ f, float* __restrict__ dtdt,
                    float* __restrict__ vir, int nx, int ny, int nz, int k,
                    int xr, float dt_inv_sqrt, float mass, float cv,
                    uint32_t step, uint32_t seed, int rounds) {
  const int nr = nx * ny * nz * k;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nr) return;

  float fx = 0.0f, fy = 0.0f, fz = 0.0f, q = 0.0f, vsum = 0.0f;
  if (valid[row]) {
    // one type: the coefficients stay in registers
    const float a0 = a_tab[0], gamma0 = gamma_tab[0], kappa0 = kappa_tab[0];
    const float inv_rc0 = 1.0f / rc_tab[0];
    const int t_row = kTypes ? typ[row] * n_types : 0;
    const float vxi = v[3 * row], vyi = v[3 * row + 1], vzi = v[3 * row + 2];
    const float ti = temp[row];
    const float inv_ti = 1.0f / fmaxf(ti, 1e-12f);
    const int32_t tag_i = tag[row];
    const uint32_t h_i = kTea ? 0u : h[row];
    for_each_pair<kMinImage>(
        x, valid, box_lo, box_hi, row, nx, ny, nz, k, xr,
        walk_rc2(rc_tab, n_types),
        [&](int j, float drx, float dry, float drz, float r2) {
          float a = a0, gamma = gamma0, kappa = kappa0, inv_rc = inv_rc0;
          if (kTypes) {
            const int p = t_row + typ[j];
            r2 = unfused_r2(drx, dry, drz);
            if (!(r2 < rc_tab[p] * rc_tab[p])) return;
            a = a_tab[p];
            gamma = gamma_tab[p];
            kappa = kappa_tab[p];
            inv_rc = 1.0f / rc_tab[p];
          }
          const float rinv = rsqrtf(r2);
          const float rr = r2 * rinv;
          const float w = 1.0f - rr * inv_rc;
          const float w2 = w * w;
          const float ev = (drx * (vxi - v[3 * j]) +
                            dry * (vyi - v[3 * j + 1]) +
                            drz * (vzi - v[3 * j + 2])) * rinv;
          const int32_t tag_j = tag[j];
          const uint32_t hp = pair_hash<kTea>(tag_i, tag_j, h_i,
                                              kTea ? 0u : h[j], step, seed,
                                              rounds);
          const float theta = uniform_stream(hp, 0u);
          const float tj = temp[j];
          const float tsum = ti + tj;
          const float sigma2 = 4.0f * gamma * ti * tj / fmaxf(tsum, 1e-12f);
          const float sigma = sqrtf(fmaxf(sigma2, 0.0f));
          const float noise = sigma * w * theta * dt_inv_sqrt;
          const float fmag = a * w - gamma * w2 * ev + noise;
          const float k_ij = kappa * 0.25f * (tsum * tsum);
          const float q_c = k_ij * w2 * (inv_ti - 1.0f / fmaxf(tj, 1e-12f));
          const float q_v =
              0.5f * (w2 * (gamma * ev * ev - sigma2 / mass) - noise * ev);
          const float zeta =
              (tag_i < tag_j ? 1.0f : -1.0f) * uniform_stream(hp, 1u);
          const float q_r =
              sqrtf(fmaxf(2.0f * k_ij, 0.0f)) * w * zeta * dt_inv_sqrt;
          q += q_c + q_v + q_r;
          const float fr = fmag * rinv;
          fx += fr * drx;
          fy += fr * dry;
          fz += fr * drz;
          vsum += 0.5f * fmag * rr;
        });
  }
  f[3 * row] = fx;
  f[3 * row + 1] = fy;
  f[3 * row + 2] = fz;
  dtdt[row] = q / cv;
  vir[row] = vsum;
}

template <bool kMinImage, bool kTea, bool kTypes, bool kBlocks>
__global__ void __launch_bounds__(kThreads)
pair_tdpd_v3_kernel(const float* __restrict__ x, const float* __restrict__ v,
                    const float* __restrict__ c,
                    const int32_t* __restrict__ tag,
                    const int32_t* __restrict__ typ,
                    const uint8_t* __restrict__ valid,
                    const uint32_t* __restrict__ h,
                    const float* __restrict__ a_tab,
                    const float* __restrict__ gamma_tab,
                    const float* __restrict__ sigma_tab,
                    const float* __restrict__ rc_tab, int n_types,
                    const float* __restrict__ kappa_c,
                    const float* __restrict__ eps_c,
                    const float* __restrict__ box_lo,
                    const float* __restrict__ box_hi,
                    float* __restrict__ f, float* __restrict__ dcdt,
                    float* __restrict__ vir, int nx, int ny, int nz, int k,
                    int xr, int ns, float dt_inv_sqrt, float rcc, float s1,
                    uint32_t step, uint32_t seed, int rounds) {
  const int nr = nx * ny * nz * k;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nr) return;
  const int s0 = kBlocks ? static_cast<int>(blockIdx.y) * kSpeciesBlock : 0;

  float fx = 0.0f, fy = 0.0f, fz = 0.0f, vsum = 0.0f;
  float qs[kSpeciesBlock];
#pragma unroll
  for (int s = 0; s < kSpeciesBlock; ++s) qs[s] = 0.0f;
  if (valid[row]) {
    // one type: the coefficients stay in registers
    const float a0 = a_tab[0], gamma0 = gamma_tab[0];
    const float sdt0 = sigma_tab[0] * dt_inv_sqrt;
    const float inv_rc0 = 1.0f / rc_tab[0];
    const int t_row = kTypes ? typ[row] * n_types : 0;
    const float rcc2 = rcc * rcc;
    const float vxi = v[3 * row], vyi = v[3 * row + 1], vzi = v[3 * row + 2];
    const int32_t tag_i = tag[row];
    const uint32_t h_i = kTea ? 0u : h[row];
    float kap[kSpeciesBlock], eps[kSpeciesBlock], ci[kSpeciesBlock];
#pragma unroll
    for (int s = 0; s < kSpeciesBlock; ++s) {
      const bool on = s0 + s < ns;
      kap[s] = on ? kappa_c[s0 + s] : 0.0f;
      eps[s] = on ? eps_c[s0 + s] : 0.0f;
      ci[s] = on ? c[row * ns + s0 + s] : 0.0f;
    }
    for_each_pair<kMinImage>(
        x, valid, box_lo, box_hi, row, nx, ny, nz, k, xr,
        walk_rc2(rc_tab, n_types),
        [&](int j, float drx, float dry, float drz, float r2) {
          float a = a0, gamma = gamma0, sdt = sdt0, inv_rc = inv_rc0;
          if (kTypes) {
            const int p = t_row + typ[j];
            r2 = unfused_r2(drx, dry, drz);
            if (!(r2 < rc_tab[p] * rc_tab[p])) return;
            a = a_tab[p];
            gamma = gamma_tab[p];
            sdt = sigma_tab[p] * dt_inv_sqrt;
            inv_rc = 1.0f / rc_tab[p];
          }
          const float rinv = rsqrtf(r2);
          const float rr = r2 * rinv;
          const float w = 1.0f - rr * inv_rc;
          const float ev = (drx * (vxi - v[3 * j]) +
                            dry * (vyi - v[3 * j + 1]) +
                            drz * (vzi - v[3 * j + 2])) * rinv;
          const int32_t tag_j = tag[j];
          const uint32_t hp = pair_hash<kTea>(tag_i, tag_j, h_i,
                                              kTea ? 0u : h[j], step, seed,
                                              rounds);
          const float theta = uniform_stream(hp, 0u);
          const float fmag = a * w - gamma * (w * w) * ev + sdt * w * theta;
          const float fr = fmag * rinv;
          fx += fr * drx;
          fy += fr * dry;
          fz += fr * drz;
          vsum += 0.5f * fmag * rr;
          if (r2 < rcc2) {
            // r as the plain version takes it: r2 summed without fused
            // multiply-adds, then a correctly rounded root. Near rcc,
            // sqrt(w_dc) (s1 = 1) turns an ulp of r into a flux error of
            // ~1e-5 of the largest flux (measured at L=70 with r2 * rsqrtf)
            const float r2n = unfused_r2(drx, dry, drz);
            const float base = fmaxf(1.0f - sqrtf(r2n) / rcc, 0.0f);
            const float wdc = s1 == 1.0f ? base : powf(base, s1);
            const float wrc = sqrtf(wdc);
            const float sign = tag_i < tag_j ? 1.0f : -1.0f;
#pragma unroll
            for (int s = 0; s < kSpeciesBlock; ++s) {
              if (s0 + s < ns) {
                const float xi = sign * uniform_stream(
                    hp, 2u + static_cast<uint32_t>(s0 + s));
                qs[s] += -kap[s] * wdc * (ci[s] - c[j * ns + s0 + s]) +
                         eps[s] * wrc * xi * dt_inv_sqrt;
              }
            }
          }
        });
  }
  if (s0 == 0) {
    f[3 * row] = fx;
    f[3 * row + 1] = fy;
    f[3 * row + 2] = fz;
    vir[row] = vsum;
  }
#pragma unroll
  for (int s = 0; s < kSpeciesBlock; ++s) {
    if (s0 + s < ns) dcdt[row * ns + s0 + s] = qs[s];
  }
}

template <bool kMinImage, bool kTea, bool kTypes, typename... Args>
void launch_edpd(dim3 grid, cudaStream_t stream, Args... args) {
  pair_edpd_v3_kernel<kMinImage, kTea, kTypes>
      <<<grid, kThreads, 0, stream>>>(args...);
}

template <bool kMinImage, bool kTea, bool kTypes, typename... Args>
void launch_tdpd(dim3 grid, cudaStream_t stream, Args... args) {
  if (grid.y > 1) {
    pair_tdpd_v3_kernel<kMinImage, kTea, kTypes, true>
        <<<grid, kThreads, 0, stream>>>(args...);
  } else {
    pair_tdpd_v3_kernel<kMinImage, kTea, kTypes, false>
        <<<grid, kThreads, 0, stream>>>(args...);
  }
}

}  // namespace

extern "C" int meso_uniform_stream(const void* h, void* out, int n,
                                   uint32_t salt, void* stream) {
  if (n > 0) {
    uniform_stream_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(h), static_cast<float*>(out), n, salt);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meso_pair_edpd_v3(
    const void* x, const void* v, const void* t, const void* tag,
    const void* typ, const void* valid, const void* h, const void* a_tab,
    const void* gamma_tab, const void* kappa_tab, const void* rc_tab,
    int n_types, const void* box_lo, const void* box_hi, void* f,
    void* dtdt, void* vir, int nx, int ny, int nz, int k, int xr,
    int min_image, int tea, float dt_inv_sqrt, float mass, float cv,
    uint32_t step, uint32_t seed, int rounds, void* stream) {
  const int nr = nx * ny * nz * k;
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((nr + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MESO_EDPD_ARGS                                                       \
  grid, st, static_cast<const float*>(x), static_cast<const float*>(v),      \
      static_cast<const float*>(t), static_cast<const int32_t*>(tag),        \
      static_cast<const int32_t*>(typ),                                      \
      static_cast<const uint8_t*>(valid), static_cast<const uint32_t*>(h),   \
      static_cast<const float*>(a_tab), static_cast<const float*>(gamma_tab), \
      static_cast<const float*>(kappa_tab),                                  \
      static_cast<const float*>(rc_tab), n_types,                            \
      static_cast<const float*>(box_lo),                                     \
      static_cast<const float*>(box_hi), static_cast<float*>(f),             \
      static_cast<float*>(dtdt), static_cast<float*>(vir), nx, ny, nz, k,    \
      xr, dt_inv_sqrt, mass, cv, step, seed, rounds
  switch ((min_image ? 4 : 0) | (tea ? 2 : 0) | (n_types > 1 ? 1 : 0)) {
    case 0: launch_edpd<false, false, false>(MESO_EDPD_ARGS); break;
    case 1: launch_edpd<false, false, true>(MESO_EDPD_ARGS); break;
    case 2: launch_edpd<false, true, false>(MESO_EDPD_ARGS); break;
    case 3: launch_edpd<false, true, true>(MESO_EDPD_ARGS); break;
    case 4: launch_edpd<true, false, false>(MESO_EDPD_ARGS); break;
    case 5: launch_edpd<true, false, true>(MESO_EDPD_ARGS); break;
    case 6: launch_edpd<true, true, false>(MESO_EDPD_ARGS); break;
    default: launch_edpd<true, true, true>(MESO_EDPD_ARGS); break;
  }
#undef MESO_EDPD_ARGS
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meso_pair_tdpd_v3(
    const void* x, const void* v, const void* c, const void* tag,
    const void* typ, const void* valid, const void* h, const void* a_tab,
    const void* gamma_tab, const void* sigma_tab, const void* rc_tab,
    int n_types, const void* kappa_c, const void* eps_c,
    const void* box_lo, const void* box_hi, void* f, void* dcdt, void* vir,
    int nx, int ny, int nz, int k, int xr, int ns, int min_image, int tea,
    float dt_inv_sqrt,
    float rcc, float s1, uint32_t step, uint32_t seed, int rounds,
    void* stream) {
  const int nr = nx * ny * nz * k;
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  if (ns < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nr + kThreads - 1) / kThreads,
                  (ns + kSpeciesBlock - 1) / kSpeciesBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MESO_TDPD_ARGS                                                       \
  grid, st, static_cast<const float*>(x), static_cast<const float*>(v),      \
      static_cast<const float*>(c), static_cast<const int32_t*>(tag),        \
      static_cast<const int32_t*>(typ),                                      \
      static_cast<const uint8_t*>(valid), static_cast<const uint32_t*>(h),   \
      static_cast<const float*>(a_tab), static_cast<const float*>(gamma_tab), \
      static_cast<const float*>(sigma_tab),                                  \
      static_cast<const float*>(rc_tab), n_types,                            \
      static_cast<const float*>(kappa_c),                                    \
      static_cast<const float*>(eps_c), static_cast<const float*>(box_lo),   \
      static_cast<const float*>(box_hi), static_cast<float*>(f),             \
      static_cast<float*>(dcdt), static_cast<float*>(vir), nx, ny, nz, k,    \
      xr, ns, dt_inv_sqrt, rcc, s1, step, seed, rounds
  switch ((min_image ? 4 : 0) | (tea ? 2 : 0) | (n_types > 1 ? 1 : 0)) {
    case 0: launch_tdpd<false, false, false>(MESO_TDPD_ARGS); break;
    case 1: launch_tdpd<false, false, true>(MESO_TDPD_ARGS); break;
    case 2: launch_tdpd<false, true, false>(MESO_TDPD_ARGS); break;
    case 3: launch_tdpd<false, true, true>(MESO_TDPD_ARGS); break;
    case 4: launch_tdpd<true, false, false>(MESO_TDPD_ARGS); break;
    case 5: launch_tdpd<true, false, true>(MESO_TDPD_ARGS); break;
    case 6: launch_tdpd<true, true, false>(MESO_TDPD_ARGS); break;
    default: launch_tdpd<true, true, true>(MESO_TDPD_ARGS); break;
  }
#undef MESO_TDPD_ARGS
  return static_cast<int>(cudaGetLastError());
}
