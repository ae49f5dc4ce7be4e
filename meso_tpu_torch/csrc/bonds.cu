// Pair bonds (FENE, harmonic, WLC-POW) of ops/bonded.py, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes the bonded terms as XLA
// code (meso_tpu/ops/bonded.py), and the port ran them as a torch chain
// (ops/bonded.py::_bonded_plain): an inverse tag map and a presence map
// over the tags, gathers, the minimum image, the spring force and two
// index_add_ calls, about 30 launches a force call. On the card those adds
// are atomics in no fixed order, so the sums moved in their last bits from
// run to run.
//
// Design: two launches a force call, no atomics on f.
//   1. tag_rows_kernel: inv[tag] = row for every valid row (the tag -> row
//      map; a tag no valid row holds keeps whatever inv held), and the
//      missing-partner counter set to 0.
//   2. pair_bonds_kernel: a thread a row. A valid row (that this rank
//      owns, where an owner mask is given) reads its tag's partners from
//      the partner table (each tag's bond partners and bond types in the
//      order of the bond list, padded with partner 0; built once with the
//      topology, ops/bonded.py::partner_table), finds each partner's row
//      through inv and checks it (in range, valid, holding that tag: a
//      stale inv entry never passes), and sums the force of each bond on
//      its own bead in table order. The sum is added to its own f row (or
//      stored, with zeros on every other row), so the result is the same
//      bits from run to run. A partner no valid row holds is skipped and,
//      where counted, added to the block's count, which goes to the
//      missing counter with one atomic a block (integer sums are exact in
//      any order).
// The force on bead i of a bond (i, j) is F(min_image(x_i - x_j)): the
// styles are central, F(-d) = -F(d) bit for bit, so each end computes its
// own share and no bond is evaluated from its other end's data. The
// arithmetic follows the torch chain operation by operation, rounded at
// each (no contraction into FMA), so a bead with one or two bonds gets the
// plain chain's bits on the CPU.
//
// What bounds it: bytes. A bonded bead's x and tag read (16 B), its f read
// and written (24 B), and its bonds' two tags (8 B a bond): 48.6 MB at the
// 1,029,000-bead melt, 0.0145 ms at 3.35 TB/s. The partners' x, tag and
// mask are random reads of rows that lie within a cell or two, which the
// 50 MB L2 mostly serves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBondThreads = 256;
constexpr int kBondWarps = kBondThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// the bond styles, as ops/bonded.py::_BOND_FORCES names them
constexpr int kFene = 0;
constexpr int kHarmonic = 1;
constexpr int kWlcPow = 2;

template <bool kCount>
__global__ void __launch_bounds__(kBondThreads)
tag_rows_kernel(const int32_t* __restrict__ tag,
                const uint8_t* __restrict__ valid, int n, int n_tags,
                int32_t* __restrict__ inv, int32_t* __restrict__ missing) {
  const int i = blockIdx.x * kBondThreads + threadIdx.x;
  if (kCount && i == 0) *missing = 0;
  if (i < n && valid[i]) {
    const int t = tag[i];
    if (t >= 1 && t <= n_tags) inv[t] = i;
  }
}

// d - round(d / l) l, as Box.min_image: round half to even (rintf), each
// operation rounded
__device__ __forceinline__ float min_image(float d, float l) {
  return __fsub_rn(d, __fmul_rn(rintf(__fdiv_rn(d, l)), l));
}

// The bond's force on bead i over its displacement d = x_i - x_j, from the
// squared length r2 and the bond type's coefficients c, as
// ops/bonded.py's fene_force, harmonic_force and wlc_pow_force.
template <int kStyle>
__device__ __forceinline__ float bond_scale(float r2, float4 c) {
  if (kStyle == kFene) {
    // -K / (1 - min(r^2 / R0^2, 0.9801)); c = (K, R0, eps, sigma)
    const float x = fminf(__fdiv_rn(r2, __fmul_rn(c.y, c.y)), 0.9801f);
    return __fdiv_rn(-c.x, __fsub_rn(1.0f, x));
  }
  const float r = __fsqrt_rn(fmaxf(r2, 1e-12f));
  if (kStyle == kHarmonic) {
    // -2 K (r - r0) / r; c = (K, r0, 0, 0)
    return __fdiv_rn(__fmul_rn(__fmul_rn(-2.0f, c.x), __fsub_rn(r, c.y)), r);
  }
  // WLC-POW: (-(kBT/p) [1/(4 (1 - x)^2) - 1/4 + x] + k_p / r^m) / r,
  // x = min(r / l_max, 0.99); c = (kBT/p, l_max, k_p, m)
  const float x = fminf(__fdiv_rn(r, c.y), 0.99f);
  const float om = __fsub_rn(1.0f, x);
  const float t = __fadd_rn(__fsub_rn(__fdiv_rn(0.25f, __fmul_rn(om, om)),
                                      0.25f),
                            x);
  const float f_wlc = __fmul_rn(-c.x, t);
  const float f_pow = __fdiv_rn(c.z, powf(r, c.w));
  return __fdiv_rn(__fadd_rn(f_wlc, f_pow), r);
}

template <int kStyle, bool kStore, bool kCount>
__global__ void __launch_bounds__(kBondThreads)
pair_bonds_kernel(const float* __restrict__ x,
                  const int32_t* __restrict__ tag,
                  const uint8_t* __restrict__ valid,
                  const uint8_t* __restrict__ owner,
                  const float* __restrict__ box_lo,
                  const float* __restrict__ box_hi,
                  const int2* __restrict__ partners, int max_partners,
                  const float4* __restrict__ coeffs,
                  const int32_t* __restrict__ inv, int n, int n_tags,
                  float* __restrict__ f, int32_t* __restrict__ missing) {
  __shared__ int warp_miss[kBondWarps];
  const int i = blockIdx.x * kBondThreads + threadIdx.x;
  const float lx = __fsub_rn(box_hi[0], box_lo[0]);
  const float ly = __fsub_rn(box_hi[1], box_lo[1]);
  const float lz = __fsub_rn(box_hi[2], box_lo[2]);
  bool own = false;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  int miss = 0;
  if (i < n) {
    own = valid[i] && (owner == nullptr || owner[i]);
    const int t = own ? tag[i] : 0;
    if (t >= 1 && t <= n_tags) {
      const float xi = x[3 * i], yi = x[3 * i + 1], zi = x[3 * i + 2];
      const int2* row = partners + static_cast<long long>(t) * max_partners;
      for (int k = 0; k < max_partners; ++k) {
        const int2 e = row[k];
        if (e.x == 0) break;
        const int r = inv[e.x];
        if (r < 0 || r >= n || !valid[r] || tag[r] != e.x) {
          ++miss;
          continue;
        }
        const float dx = min_image(__fsub_rn(xi, x[3 * r]), lx);
        const float dy = min_image(__fsub_rn(yi, x[3 * r + 1]), ly);
        const float dz = min_image(__fsub_rn(zi, x[3 * r + 2]), lz);
        const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        const float g = bond_scale<kStyle>(r2, coeffs[e.y]);
        sx = __fadd_rn(sx, __fmul_rn(g, dx));
        sy = __fadd_rn(sy, __fmul_rn(g, dy));
        sz = __fadd_rn(sz, __fmul_rn(g, dz));
      }
    }
    if (kStore) {
      f[3 * i] = own ? sx : 0.0f;
      f[3 * i + 1] = own ? sy : 0.0f;
      f[3 * i + 2] = own ? sz : 0.0f;
    } else if (own) {
      f[3 * i] = __fadd_rn(f[3 * i], sx);
      f[3 * i + 1] = __fadd_rn(f[3 * i + 1], sy);
      f[3 * i + 2] = __fadd_rn(f[3 * i + 2], sz);
    }
  }
  if (kCount) {
    // the block's partners no valid row holds, in one atomic
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) miss += __shfl_down_sync(kFull, miss, d);
    if (lane == 0) warp_miss[warp] = miss;
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int w = 0; w < kBondWarps; ++w) sum += warp_miss[w];
      if (sum) atomicAdd(missing, sum);
    }
  }
}

template <int kStyle, bool kStore, bool kCount>
cudaError_t launch_bonds(const void* x, const void* tag, const void* valid,
                         const void* owner, const void* box_lo,
                         const void* box_hi, const void* partners,
                         int max_partners, const void* coeffs, void* inv,
                         void* f, void* missing, int n, int n_tags,
                         cudaStream_t st) {
  const int blocks = n > 0 ? (n + kBondThreads - 1) / kBondThreads : 1;
  tag_rows_kernel<kCount><<<blocks, kBondThreads, 0, st>>>(
      static_cast<const int32_t*>(tag), static_cast<const uint8_t*>(valid),
      n, n_tags, static_cast<int32_t*>(inv),
      static_cast<int32_t*>(missing));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  pair_bonds_kernel<kStyle, kStore, kCount><<<blocks, kBondThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(tag),
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(owner),
      static_cast<const float*>(box_lo), static_cast<const float*>(box_hi),
      static_cast<const int2*>(partners), max_partners,
      static_cast<const float4*>(coeffs), static_cast<const int32_t*>(inv),
      n, n_tags, static_cast<float*>(f), static_cast<int32_t*>(missing));
  return cudaGetLastError();
}

template <int kStyle>
cudaError_t launch_style(const void* x, const void* tag, const void* valid,
                         const void* owner, const void* box_lo,
                         const void* box_hi, const void* partners,
                         int max_partners, const void* coeffs, void* inv,
                         void* f, void* missing, int n, int n_tags, int store,
                         cudaStream_t st) {
  if (store && missing)
    return launch_bonds<kStyle, true, true>(x, tag, valid, owner, box_lo,
                                            box_hi, partners, max_partners,
                                            coeffs, inv, f, missing, n,
                                            n_tags, st);
  if (store)
    return launch_bonds<kStyle, true, false>(x, tag, valid, owner, box_lo,
                                             box_hi, partners, max_partners,
                                             coeffs, inv, f, missing, n,
                                             n_tags, st);
  if (missing)
    return launch_bonds<kStyle, false, true>(x, tag, valid, owner, box_lo,
                                             box_hi, partners, max_partners,
                                             coeffs, inv, f, missing, n,
                                             n_tags, st);
  return launch_bonds<kStyle, false, false>(x, tag, valid, owner, box_lo,
                                            box_hi, partners, max_partners,
                                            coeffs, inv, f, missing, n,
                                            n_tags, st);
}

}  // namespace

// The pair bonds of n rows on ``stream``: x float32 (n, 3), tag int32,
// valid and owner (null: every valid row) one byte a row, box_lo and box_hi
// float32 (3,), partners int32 (n_tags + 1, max_partners, 2) (partner tag,
// bond type), coeffs float32 (bond types, 4), inv int32 (n_tags + 1)
// scratch. style 0 FENE, 1 harmonic, 2 WLC-POW. store 0 adds each owned
// row's bonded force to f; store 1 writes f on every row (0 where not
// owned). missing: null, or one int32 set to the partners no valid row
// holds. Two launches; returns 1 (cudaErrorInvalidValue) for an unknown
// style.
extern "C" int meso_pair_bonds(const void* x, const void* tag,
                               const void* valid, const void* owner,
                               const void* box_lo, const void* box_hi,
                               const void* partners, int max_partners,
                               const void* coeffs, void* inv, void* f,
                               void* missing, int n, int n_tags, int style,
                               int store, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (style) {
    case kFene:
      return static_cast<int>(launch_style<kFene>(
          x, tag, valid, owner, box_lo, box_hi, partners, max_partners,
          coeffs, inv, f, missing, n, n_tags, store, st));
    case kHarmonic:
      return static_cast<int>(launch_style<kHarmonic>(
          x, tag, valid, owner, box_lo, box_hi, partners, max_partners,
          coeffs, inv, f, missing, n, n_tags, store, st));
    case kWlcPow:
      return static_cast<int>(launch_style<kWlcPow>(
          x, tag, valid, owner, box_lo, box_hi, partners, max_partners,
          coeffs, inv, f, missing, n, n_tags, store, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
