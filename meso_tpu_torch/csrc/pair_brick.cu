// Classic, eDPD and tDPD pair forces over a padded brick of channel planes,
// for Hopper (sm_90a).
//
// Replaces the single-chip Pallas TPU kernels that walk the full 27-cell
// stencil without Newton folding:
// - K5, meso_tpu/kernels/pair_dpd_fused.py::_fused_kernel (line 63) through
//   bucket_forces_pallas_fused (:301) and _model_call (:702), which backs
//   bucket_forces_pallas_edpd_fused (:817) and _tdpd_fused (:857);
// - K6, meso_tpu/kernels/pair_dpd.py::_kernel (line 60) through
//   bucket_forces_pallas (:233);
// - K7, meso_tpu/kernels/pair_multiphysics.py::_kernel (line 40) through
//   _call (:274), which backs bucket_forces_pallas_edpd (:213) and _tdpd
//   (:241);
// and their halo forms on the 1-D domain decomposition:
// - K4, pair_dpd_fused.py::_fused_kernel through _halo_call (:457), which
//   backs halo_forces_pallas_fused (:567) and _model_fused (:628);
// - K6-halo, pair_dpd.py::_kernel through halo_forces_pallas_1d (:370).
// All compute one function (the per-pair math of ops/dpd.pair_force,
// ops/edpd.py and ops/tdpd.py, min-image on every axis, per-type-pair
// tables); K5 and K4 take the spill layout's +-2 x-window, and K6, K6-halo
// and K7 are strict only (the wrappers refuse spill for them).
//
// Input: the brick. Every per-row quantity rides as a channel plane
// (ny, nz, K, nx) of the bucket layout, padded by one cell on each side in
// y and z and by xr cells on each side in x (xr = 2 spill, 1 strict):
//   fb (nf, ny + 2, nz + 2, K, nx + 2 xr) float32: x, y, z, vx, vy, vz,
//      then T (eDPD) or C_0 .. C_{S-1} (tDPD);
//   ib (ni, ny + 2, nz + 2, K, nx + 2 xr) int32: tag, valid, then, where
//      present, h (the per-particle hash, fast RNG tier), typ (more than
//      one type) and the E exclusion tags of the row's particle.
// Target row ((cy * nz + cz) * K + slot) * nx + cx sits in the brick at
// (cy + 1, cz + 1, slot, cx + xr); its stencil is the brick box
// [cy, cy + 2] x [cz, cz + 2] x [cx, cx + 2 xr] with all K slots, so the
// kernel never wraps an index. On one card the wrapper builds the pads as
// the periodic copy (kernels/_brick.py); on the distributed path (K4,
// K6-halo) the pads of the decomposed axes are the halo layers received
// from the neighbouring ranks (_brick.halo_brick), and nx counts the target
// columns only: the interior call of the border/inner split passes the
// local planes with nx - 2 xr targets, the edge calls xr, so nx may be
// smaller than the 2 xr + 1 columns of the window. Nothing in the kernel
// changed for that. Pad coordinates may be raw or
// pre-shifted by a box length: the minimum image on every axis gives the
// same dr either way, as in all three TPU kernels
// (pair_dpd_fused.py:163-171, pair_dpd.py:158-166,
// pair_multiphysics.py:119-125).
//
// Design: one thread per target row, a full traversal of 3 x 3 x (2 xr + 1)
// cells x K slots, no Newton folding and no atomics: each row has one
// writer and a deterministic sum. The walk tests the table's largest rc^2
// with a 1e-4 margin; the visitor recomputes r^2 without fused
// multiply-adds (the plain version's order) and tests the pair's own rc_ij
// (and rcc for the tDPD flux, which the wrapper holds to rcc <= every
// rc_ij, R9), so kernel and plain version take the same pairs. tDPD species ride in blocks of kSpeciesBlock registers (one
// register for one species): grid.y walks the species blocks, and only
// block 0 writes f and the virial. The
// eDPD heat is q(i <- j), computed by row i, with the antisymmetric noises
// signed by tag order, as K2 (pair_transport_v3.cu).
//
// What bounds it: at the 1M-particle spill shape (ncell 50^3, K = 16,
// 2,000,000 rows) a row sees 45 x 16 = 720 candidates, as K1; at the strict
// shape (K = 28, 3,500,000 rows) 27 x 28 = 756, 1.8x K1's candidate tests.
// The bytes (the brick once, the outputs once; ~100-200 MB) take 30-60 us
// at 3.35 TB/s and the in-range pairs' arithmetic about as long at 67
// TFLOP/s: neither. The candidate loads and compares bound it, served by L1
// and L2 since the threads of a warp read neighbouring columns. Shared-
// memory cell tiles and Newton folding are left to later work.

#include "dpd_common.cuh"

namespace {

using namespace meso;

constexpr int kSpeciesBlock = 8;
constexpr int kDpd = 0, kEdpd = 1, kTdpd = 2;

struct BrickArgs {
  const float* fb;
  const int32_t* ib;
  const float* box_lo;
  const float* box_hi;
  const float* a_tab;
  const float* gamma_tab;
  const float* x3_tab;  // sigma (dpd, tdpd) or kappa (edpd), (T, T)
  const float* rc_tab;
  int n_types, ch_h, ch_typ, ch_ex, n_excl;
  const float* excl_w;
  int ns;
  const float* kappa_c;
  const float* eps_c;
  float* f;
  float* extra;  // dT/dt (nr,) or dC/dt (nr, S)
  float* vir;
  int nx, ny, nz, k, xr;
  float dt_inv_sqrt, s_exp, mass, cv, rcc, s1;
  uint32_t step, seed;
  int rounds;
};

// kTypes: per-type-pair tables (else the row keeps one type's coefficients
// in registers); kSb: tDPD species per register block (grid.y walks the
// blocks).
template <int kModel, bool kTea, bool kTypes, int kSb>
__global__ void __launch_bounds__(kThreads) pair_brick_kernel(BrickArgs p) {
  const int nr = p.nx * p.ny * p.nz * p.k;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nr) return;
  const int s0 = static_cast<int>(blockIdx.y) * kSb;

  int t = row;
  const int cx = t % p.nx;
  t /= p.nx;
  const int slot = t % p.k;
  t /= p.k;
  const int cz = t % p.nz;
  const int cy = t / p.nz;
  // in-plane offsets are 32-bit (the launcher refuses a plane of 2^31 or
  // more elements); channel offsets are not
  const int px = p.nx + 2 * p.xr, pz = p.nz + 2;
  const int plane = (p.ny + 2) * pz * p.k * px;
  const size_t chan = static_cast<size_t>(plane);
  const int self = (((cy + 1) * pz + cz + 1) * p.k + slot) * px + cx + p.xr;
  const float* xb = p.fb;
  const float* yb = p.fb + chan;
  const float* zb = p.fb + 2 * chan;
  const float* vxb = p.fb + 3 * chan;
  const float* vyb = p.fb + 4 * chan;
  const float* vzb = p.fb + 5 * chan;
  const float* mb = p.fb + 6 * chan;  // T or C_0
  const int32_t* tagb = p.ib;
  const int32_t* validb = p.ib + chan;
  const int32_t* typb = p.ib + (kTypes ? p.ch_typ * chan : 0);
  const int32_t* hb = p.ib + (kTea ? 0 : p.ch_h * chan);

  float fx = 0.0f, fy = 0.0f, fz = 0.0f, vsum = 0.0f, q = 0.0f;
  float qs[kSb];
#pragma unroll
  for (int s = 0; s < kSb; ++s) qs[s] = 0.0f;

  if (validb[self]) {
    const float lx = p.box_hi[0] - p.box_lo[0];
    const float ly = p.box_hi[1] - p.box_lo[1];
    const float lz = p.box_hi[2] - p.box_lo[2];
    const float inv_lx = 1.0f / lx, inv_ly = 1.0f / ly, inv_lz = 1.0f / lz;
    float rc2_max = 0.0f;
    for (int q2 = 0; q2 < p.n_types * p.n_types; ++q2) {
      rc2_max = fmaxf(rc2_max, p.rc_tab[q2] * p.rc_tab[q2]);
    }
    const float rc2_walk = rc2_max * 1.0001f;
    const int t_row = kTypes ? typb[self] * p.n_types : 0;
    const float a0 = p.a_tab[0], gamma0 = p.gamma_tab[0];
    const float x30 = p.x3_tab[0], rc0 = p.rc_tab[0];
    const float xi = xb[self], yi = yb[self], zi = zb[self];
    const float vxi = vxb[self], vyi = vyb[self], vzi = vzb[self];
    const int32_t tag_i = tagb[self];
    const uint32_t h_i = kTea ? 0u : static_cast<uint32_t>(hb[self]);
    const float w_excl = p.n_excl > 0 ? p.excl_w[0] : 1.0f;
    const float ti = kModel == kEdpd ? mb[self] : 0.0f;
    const float inv_ti = 1.0f / fmaxf(ti, 1e-12f);
    const float rcc2 = p.rcc * p.rcc;
    float kap[kSb], eps[kSb], ci[kSb];
#pragma unroll
    for (int s = 0; s < kSb; ++s) {
      const bool on = kModel == kTdpd && s0 + s < p.ns;
      kap[s] = on ? p.kappa_c[s0 + s] : 0.0f;
      eps[s] = on ? p.eps_c[s0 + s] : 0.0f;
      ci[s] = on ? mb[(s0 + s) * chan + self] : 0.0f;
    }

    for (int dy = 0; dy < 3; ++dy) {
      for (int dz = 0; dz < 3; ++dz) {
        const int yz = ((cy + dy) * pz + cz + dz) * p.k;
        for (int dx = 0; dx <= 2 * p.xr; ++dx) {
          for (int sl = 0; sl < p.k; ++sl) {
            const int j = (yz + sl) * px + cx + dx;
            if (j == self || !validb[j]) continue;
            float drx = xi - xb[j];
            float dry = yi - yb[j];
            float drz = zi - zb[j];
            drx -= rintf(drx * inv_lx) * lx;
            dry -= rintf(dry * inv_ly) * ly;
            drz -= rintf(drz * inv_lz) * lz;
            if (!(drx * drx + dry * dry + drz * drz < rc2_walk)) continue;
            const float r2 = __fadd_rn(
                __fadd_rn(__fmul_rn(drx, drx), __fmul_rn(dry, dry)),
                __fmul_rn(drz, drz));
            float a = a0, gamma = gamma0, x3 = x30, rc = rc0;
            if (kTypes) {
              const int pr = t_row + typb[j];
              a = p.a_tab[pr];
              gamma = p.gamma_tab[pr];
              x3 = p.x3_tab[pr];
              rc = p.rc_tab[pr];
            }
            if (!(r2 < rc * rc) || !(r2 > 0.0f)) continue;
            const float rinv = rsqrtf(r2);
            const float rr = r2 * rinv;
            const float w = 1.0f - rr * (1.0f / rc);
            const float ev = (drx * (vxi - vxb[j]) + dry * (vyi - vyb[j]) +
                              drz * (vzi - vzb[j])) * rinv;
            const int32_t tag_j = tagb[j];
            const uint32_t hp = pair_hash<kTea>(
                tag_i, tag_j, h_i,
                kTea ? 0u : static_cast<uint32_t>(hb[j]),
                p.step, p.seed, p.rounds);
            float fmag;
            if (kModel == kDpd) {
              const float theta = u32_to_symmetric_uniform(hp);
              const float s = x3 * p.dt_inv_sqrt;
              if (p.s_exp == 1.0f) {
                fmag = w * (a - (gamma * w) * ev + s * theta);
              } else {
                const float wr = powf(fmaxf(w, 0.0f), p.s_exp);
                fmag = a * w - gamma * (wr * wr) * ev + s * wr * theta;
              }
              for (int e = 0; e < p.n_excl; ++e) {
                if (p.ib[(p.ch_ex + e) * chan + self] == tag_j) {
                  fmag *= w_excl;
                  break;
                }
              }
            } else if (kModel == kEdpd) {
              const float theta = uniform_stream(hp, 0u);
              const float w2 = w * w;
              const float tj = mb[j];
              const float tsum = ti + tj;
              const float sigma2 =
                  4.0f * gamma * ti * tj / fmaxf(tsum, 1e-12f);
              const float sigma = sqrtf(fmaxf(sigma2, 0.0f));
              const float noise = sigma * w * theta * p.dt_inv_sqrt;
              fmag = a * w - gamma * w2 * ev + noise;
              const float k_ij = x3 * 0.25f * (tsum * tsum);
              const float q_c =
                  k_ij * w2 * (inv_ti - 1.0f / fmaxf(tj, 1e-12f));
              const float q_v = 0.5f * (w2 * (gamma * ev * ev -
                                              sigma2 / p.mass) - noise * ev);
              const float zeta =
                  (tag_i < tag_j ? 1.0f : -1.0f) * uniform_stream(hp, 1u);
              const float q_r =
                  sqrtf(fmaxf(2.0f * k_ij, 0.0f)) * w * zeta * p.dt_inv_sqrt;
              q += q_c + q_v + q_r;
            } else {
              const float theta = uniform_stream(hp, 0u);
              fmag = a * w - gamma * (w * w) * ev +
                     x3 * p.dt_inv_sqrt * w * theta;
              if (r2 < rcc2) {
                // a correctly rounded root of the unfused r^2 (K3's care
                // near rcc, where sqrt(w_dc) magnifies an ulp of r)
                const float base = fmaxf(1.0f - sqrtf(r2) / p.rcc, 0.0f);
                const float wdc = p.s1 == 1.0f ? base : powf(base, p.s1);
                const float wrc = sqrtf(wdc);
                const float sign = tag_i < tag_j ? 1.0f : -1.0f;
#pragma unroll
                for (int s = 0; s < kSb; ++s) {
                  if (s0 + s < p.ns) {
                    const float xi_s = sign * uniform_stream(
                        hp, 2u + static_cast<uint32_t>(s0 + s));
                    qs[s] += -kap[s] * wdc *
                                 (ci[s] - mb[(s0 + s) * chan + j]) +
                             eps[s] * wrc * xi_s * p.dt_inv_sqrt;
                  }
                }
              }
            }
            const float fr = fmag * rinv;
            fx += fr * drx;
            fy += fr * dry;
            fz += fr * drz;
            vsum += 0.5f * fmag * rr;
          }
        }
      }
    }
  }
  if (s0 == 0) {
    p.f[3 * row] = fx;
    p.f[3 * row + 1] = fy;
    p.f[3 * row + 2] = fz;
    p.vir[row] = vsum;
    if (kModel == kEdpd) p.extra[row] = q / p.cv;
  }
  if (kModel == kTdpd) {
#pragma unroll
    for (int s = 0; s < kSb; ++s) {
      if (s0 + s < p.ns) {
        p.extra[static_cast<size_t>(row) * p.ns + s0 + s] = qs[s];
      }
    }
  }
}

template <int kModel, int kSb>
void launch_brick(dim3 grid, cudaStream_t stream, bool tea, bool types,
                  const BrickArgs& args) {
  if (tea && types) {
    pair_brick_kernel<kModel, true, true, kSb>
        <<<grid, kThreads, 0, stream>>>(args);
  } else if (tea) {
    pair_brick_kernel<kModel, true, false, kSb>
        <<<grid, kThreads, 0, stream>>>(args);
  } else if (types) {
    pair_brick_kernel<kModel, false, true, kSb>
        <<<grid, kThreads, 0, stream>>>(args);
  } else {
    pair_brick_kernel<kModel, false, false, kSb>
        <<<grid, kThreads, 0, stream>>>(args);
  }
}

}  // namespace

extern "C" int meso_pair_brick(
    int model, int tea, const void* fb, const void* ib, const void* box_lo,
    const void* box_hi, const void* a_tab, const void* gamma_tab,
    const void* x3_tab, const void* rc_tab, int n_types, int ch_h, int ch_typ,
    int ch_ex, int n_excl, const void* excl_w, int ns, const void* kappa_c,
    const void* eps_c, void* f, void* extra, void* vir, int nx, int ny,
    int nz, int k, int xr, float dt_inv_sqrt, float s_exp, float mass,
    float cv, float rcc, float s1, uint32_t step, uint32_t seed, int rounds,
    void* stream) {
  const int nr = nx * ny * nz * k;
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  const long long plane = static_cast<long long>(ny + 2) * (nz + 2) * k *
                         (nx + 2 * xr);
  if (model < kDpd || model > kTdpd || (model == kTdpd && ns < 1) ||
      (n_types > 1 && ch_typ < 0) || (!tea && ch_h < 0) ||
      (n_excl > 0 && ch_ex < 0) || plane >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BrickArgs args;
  args.fb = static_cast<const float*>(fb);
  args.ib = static_cast<const int32_t*>(ib);
  args.box_lo = static_cast<const float*>(box_lo);
  args.box_hi = static_cast<const float*>(box_hi);
  args.a_tab = static_cast<const float*>(a_tab);
  args.gamma_tab = static_cast<const float*>(gamma_tab);
  args.x3_tab = static_cast<const float*>(x3_tab);
  args.rc_tab = static_cast<const float*>(rc_tab);
  args.n_types = n_types;
  args.ch_h = ch_h;
  args.ch_typ = ch_typ;
  args.ch_ex = ch_ex;
  args.n_excl = n_excl;
  args.excl_w = static_cast<const float*>(excl_w);
  args.ns = ns;
  args.kappa_c = static_cast<const float*>(kappa_c);
  args.eps_c = static_cast<const float*>(eps_c);
  args.f = static_cast<float*>(f);
  args.extra = static_cast<float*>(extra);
  args.vir = static_cast<float*>(vir);
  args.nx = nx;
  args.ny = ny;
  args.nz = nz;
  args.k = k;
  args.xr = xr;
  args.dt_inv_sqrt = dt_inv_sqrt;
  args.s_exp = s_exp;
  args.mass = mass;
  args.cv = cv;
  args.rcc = rcc;
  args.s1 = s1;
  args.step = step;
  args.seed = seed;
  args.rounds = rounds;
  // one species (the tDPD paths) keeps one register; more take blocks
  const int sb = model == kTdpd && ns > 1 ? kSpeciesBlock : 1;
  const dim3 grid((nr + kThreads - 1) / kThreads,
                  model == kTdpd ? (ns + sb - 1) / sb : 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool types = n_types > 1;
  if (model == kDpd) {
    launch_brick<kDpd, 1>(grid, st, tea, types, args);
  } else if (model == kEdpd) {
    launch_brick<kEdpd, 1>(grid, st, tea, types, args);
  } else if (sb == 1) {
    launch_brick<kTdpd, 1>(grid, st, tea, types, args);
  } else {
    launch_brick<kTdpd, kSpeciesBlock>(grid, st, tea, types, args);
  }
  return static_cast<int>(cudaGetLastError());
}
