// Hopper counterparts of the TPU probes under tools/ (sm_90a), each with a
// plain torch version beside its wrapper in meso_tpu_torch/probes/:
//
//   T1a probe_dynroll    tools/toy_dynroll.py:32 k_dynroll
//   T1b probe_cond       tools/toy_dynroll.py:58 k_cond
//   T2a,b,d probe_gemm   tools/toy_mxu_tile.py:43,57,97 k_dot_a/_b/_c
//   T2c probe_tile       tools/toy_mxu_tile.py:71 k_tile
//   T3  probe_tea_roll   tools/toy_tea_roll.py:64,158 _kernel(_scratch)
//   T4  probe_null_stage tools/r5a_stage.py:74 null_pallas
//
// Each computes what its TPU kernel computes, not how Mosaic lowered it.
// T2's products run on the tensor cores: mma.sync m16n8k8 in TF32 with
// the 3xTF32 split (a = a_hi + a_lo, each a TF32 value; a.b ~ a_hi b_hi +
// a_hi b_lo + a_lo b_hi), which keeps ~2^-21 of each product where plain
// TF32 keeps ~3 digits. T2's pair tile runs on the CUDA cores as an n-body
// tile: as two tensor-core products (r^2 = |xi|^2 + |xj|^2 - 2 xi.xj, F =
// xi sum g - sum g xj, each split into three TF32 pieces to survive the
// cancellation) it used a sixteenth of the tensor cores' products (K = 3
// of 8, N = 5 of 8) and spent the CUDA cores on the splits and on a shared
// round trip of g, 7.4x its bound on an H100 (PERF.md). The probes are
// launch-bound at their own shapes; T2 is timed at 8,192 tiles and T4 at
// K1's 1M view (bound by bytes: it measures the card's streaming rate).
//
// T2c at 8,192 tiles, 134M pairs: per pair ~12 fp32-pipe instructions
// (three differences, r^2, the cutoff test and select, rsqrt - 1, three
// force FMAs) and one MUFU rsqrt, bound by the fp32 pipes (128 lanes a
// clock an SM) before the MUFU (16 a clock an SM); each input byte is read
// once and each output written once.
//
// T2's products (gemm_kernel) at 8,192 tiles are bound by bytes: T2a and
// T2d by their 537 MB of output (128 x 128 a tile, from 8 KB of input),
// T2b by its 537 MB of input G (64 KB a tile). Each block stages its A and
// B once with 16-byte cp.async copies into padded shared tiles (no bank
// conflicts on the fragment reads) and writes its output through a
// per-warp shared slab as 16-byte row segments, so that every byte moves
// once in whole sectors (PERF.md: the former kernel reread A and B per
// 16 x 8 tile and stored each accumulator with its own 4-byte store).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dpd_common.cuh"

namespace {

using meso::combine_symmetric;
using meso::tea_v0;
using meso::u32_to_symmetric_uniform;

// ---------------------------------------------------------------- T1a
// out[r, c] = sum_i x[r, (c + offs[i]) mod L], the offsets read from
// device memory at run time and added in their order. One block per row;
// the row is staged in shared memory (a row of 256 is wider than a warp).
__global__ void dynroll_kernel(const float* __restrict__ x,
                               const int32_t* __restrict__ offs, int n_offs,
                               float* __restrict__ out, int len) {
  extern __shared__ float row[];
  const float* xr = x + static_cast<size_t>(blockIdx.x) * len;
  for (int c = threadIdx.x; c < len; c += blockDim.x) row[c] = xr[c];
  __syncthreads();
  for (int c = threadIdx.x; c < len; c += blockDim.x) {
    float acc = 0.0f;
    for (int i = 0; i < n_offs; ++i) {
      int src = (c + offs[i]) % len;
      if (src < 0) src += len;
      acc = acc + row[src];
    }
    out[static_cast<size_t>(blockIdx.x) * len + c] = acc;
  }
}

// ---------------------------------------------------------------- T1b
// Seven carries start at zero; each of the two branches, taken when its
// device-read scalar exceeds 4, sets carry i to 0 + x (i + 1) from the
// zero carries (the TPU kernel's branch binds the initial tuple, so a
// second taken branch does not accumulate). out = carry0 + carry6.
__global__ void cond_kernel(const float* __restrict__ x,
                            const int32_t* __restrict__ jm,
                            float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float c[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) c[k] = 0.0f;
  const int j0 = jm[0], j1 = jm[1];
  if (j0 > 4) {
#pragma unroll
    for (int k = 0; k < 7; ++k) c[k] = 0.0f + xi * static_cast<float>(k + 1);
  }
  if (j1 > 4) {
#pragma unroll
    for (int k = 0; k < 7; ++k) c[k] = 0.0f + xi * static_cast<float>(k + 1);
  }
  out[i] = c[0] + c[6];
}

// ---------------------------------------------------------------- T2
__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// hi and lo TF32 parts of a float32
__device__ __forceinline__ void split_tf32(float f, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(f);
  lo = to_tf32(f - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of a warp's 16x8 tile, 3xTF32: a[0..3] are A(g, t), A(g+8, t),
// A(g, t+4), A(g+8, t+4) and b[0..1] B(t, g), B(t+4, g) of the 16x8x8 step
// (g = lane / 4, t = lane % 4), as float32; c the tile's accumulators
// (c0, c1: row g, columns 2t, 2t+1; c2, c3: row g+8).
__device__ __forceinline__ void mma_3xtf32(float c[4], const float a[4],
                                           const float b[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// 16-byte copy from device to shared memory that bypasses the registers
// (cp.async, sm_80 and later), and the wait for all of a thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Row strides (in floats) of the staged tiles, padded so that a warp's
// fragment reads hit 32 distinct banks: an operand read at (row g, column
// t) (g < 8, t < 4), A stored M x K, needs a stride of 4 mod 8; one read at
// (row t, column g), B stored K x N, A stored K x M and the output slab,
// 8 or 24 mod 32.
__host__ __device__ inline int ld_gt(int cols) { return cols + 4; }
__host__ __device__ inline int ld_tg(int cols) {
  return cols + (cols % 16 == 0 ? 8 : 16);
}

// The output columns a warp stages and writes at once, and the block's
// dynamic shared memory: A, B, then one 16-row slab a warp.
__host__ __device__ inline int gemm_chunk(int n) { return n < 32 ? n : 32; }

__host__ __device__ inline int gemm_smem_bytes(int m, int n, int k,
                                               int a_trans) {
  const int a_floats = a_trans ? k * ld_tg(m) : m * ld_gt(k);
  return 4 * (a_floats + k * ld_tg(n) + m * ld_tg(gemm_chunk(n)));
}

// C[b] (M x N) = A[b] . B[b] for each batch entry b, A stored M x K
// (a_trans = 0: T2a, T2b) or K x M (a_trans = 1: A^T . B, T2d), B K x N,
// all contiguous. One block a batch entry, M / 16 warps. The block copies
// A and B into padded shared tiles with 16-byte cp.async (each input byte
// read once), then each warp runs its 16-row slab: m16n8k8 3xTF32 steps
// (mma_3xtf32) over 8-column tiles, their accumulators staged a chunk of
// up to 32 columns at a time in the warp's shared slab and written as
// 16-byte row segments (a 16 x 32 chunk: four 512-byte stores a warp).
// M % 16 == 0, N % 8 == 0 (N % 32 == 0 above 32), K % 8 == 0.
__global__ void __launch_bounds__(512)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ bm,
            float* __restrict__ c, int m_dim, int n_dim, int k_dim,
            int a_trans) {
  extern __shared__ __align__(16) float gsm[];
  const int a_rows = a_trans ? k_dim : m_dim;
  const int a_cols = a_trans ? m_dim : k_dim;
  const int lda = a_trans ? ld_tg(m_dim) : ld_gt(k_dim);
  const int ldb = ld_tg(n_dim);
  const int cw = gemm_chunk(n_dim), ldc = ld_tg(cw);
  float* as = gsm;
  float* bs = as + a_rows * lda;
  float* cs = bs + k_dim * ldb;
  const size_t bat = blockIdx.x;
  const float* ab = a + bat * m_dim * k_dim;
  const float* bb = bm + bat * k_dim * n_dim;
  float* cb = c + bat * m_dim * n_dim;
  const int ach = a_cols / 4, bch = n_dim / 4;
  for (int i = threadIdx.x; i < a_rows * ach; i += blockDim.x) {
    const int r = i / ach, q = i - r * ach;
    cp_async16(as + r * lda + 4 * q, ab + r * a_cols + 4 * q);
  }
  for (int i = threadIdx.x; i < k_dim * bch; i += blockDim.x) {
    const int r = i / bch, q = i - r * bch;
    cp_async16(bs + r * ldb + 4 * q, bb + r * n_dim + 4 * q);
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;
  float* slab = cs + m0 * ldc;
  const int q4 = cw / 4;
  for (int c0 = 0; c0 < n_dim; c0 += cw) {
    for (int nt = 0; nt < cw; nt += 8) {
      const int n0 = c0 + nt;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k0 = 0; k0 < k_dim; k0 += 8) {
        float av[4], bv[2];
        if (a_trans) {
          av[0] = as[(k0 + t) * lda + m0 + g];
          av[1] = as[(k0 + t) * lda + m0 + g + 8];
          av[2] = as[(k0 + t + 4) * lda + m0 + g];
          av[3] = as[(k0 + t + 4) * lda + m0 + g + 8];
        } else {
          av[0] = as[(m0 + g) * lda + k0 + t];
          av[1] = as[(m0 + g + 8) * lda + k0 + t];
          av[2] = as[(m0 + g) * lda + k0 + t + 4];
          av[3] = as[(m0 + g + 8) * lda + k0 + t + 4];
        }
        bv[0] = bs[(k0 + t) * ldb + n0 + g];
        bv[1] = bs[(k0 + t + 4) * ldb + n0 + g];
        mma_3xtf32(acc, av, bv);
      }
      *reinterpret_cast<float2*>(slab + g * ldc + nt + 2 * t) =
          make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(slab + (g + 8) * ldc + nt + 2 * t) =
          make_float2(acc[2], acc[3]);
    }
    __syncwarp();
    for (int i = lane; i < 16 * q4; i += 32) {
      const int r = i / q4, q = i - r * q4;
      *reinterpret_cast<float4*>(cb + static_cast<size_t>(m0 + r) * n_dim +
                                 c0 + 4 * q) =
          *reinterpret_cast<const float4*>(slab + r * ldc + 4 * q);
    }
    __syncwarp();
  }
}

// T2c, an n-body tile on the CUDA cores: one warp a tile of 128 i-rows x
// 128 j, kTileWarps tiles a block. ai (128, 8) = [x, |x|^2, pad], bj (8,
// 128) = [x^T; |x|^2; ones; pad]: the tile reads x alone. The warp stages
// its tile's x_j in shared memory as float4 (read back as broadcasts: every
// lane takes the same j at once); lane l holds the rows l + 32 r (r <
// kTileLaneRows), their x and force sums in registers. Per pair, dr = x_i
// - x_j, r^2 = dr.dr as the float32 sum of squared differences (fused, z
// last), ok = 1e-12 < r^2 < 1, g / 25 = rsqrt(r^2) - 1 = (1 - r) / r where
// ok, else 0 (MUFU rsqrt), and F_i += (g / 25) dr, j in order; out = 25 F_i
// = x_i sum_j g - sum_j g x_j. No cancellation: r^2 and F are sums of
// differences, not of products.
constexpr int kTileRows = 128, kTileCols = 128, kTileWarps = 4;
constexpr int kTileLaneRows = kTileRows / 32;

__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__global__ void __launch_bounds__(32 * kTileWarps)
tile_kernel(const float* __restrict__ ai, const float* __restrict__ bj,
            float* __restrict__ out, int batch) {
  __shared__ float4 xs[kTileWarps][kTileCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kTileWarps + warp;
  if (tile >= batch) return;  // the warp's own tile: no block barrier
  const float* aib = ai + static_cast<size_t>(tile) * kTileRows * 8;
  const float* bjb = bj + static_cast<size_t>(tile) * 8 * kTileCols;
  float4* xw = xs[warp];
  for (int c = lane; c < kTileCols; c += 32)
    xw[c] = make_float4(bjb[c], bjb[kTileCols + c], bjb[2 * kTileCols + c],
                        0.0f);
  float xi[kTileLaneRows], yi[kTileLaneRows], zi[kTileLaneRows];
  float fx[kTileLaneRows], fy[kTileLaneRows], fz[kTileLaneRows];
#pragma unroll
  for (int r = 0; r < kTileLaneRows; ++r) {
    const float* a = aib + (lane + 32 * r) * 8;
    xi[r] = a[0];
    yi[r] = a[1];
    zi[r] = a[2];
    fx[r] = fy[r] = fz[r] = 0.0f;
  }
  __syncwarp();
#pragma unroll 4
  for (int c = 0; c < kTileCols; ++c) {
    const float4 q = xw[c];
#pragma unroll
    for (int r = 0; r < kTileLaneRows; ++r) {
      const float dx = xi[r] - q.x, dy = yi[r] - q.y, dz = zi[r] - q.z;
      const float r2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
      const float g =
          r2 < 1.0f && r2 > 1e-12f ? rsqrt_approx(r2) - 1.0f : 0.0f;
      fx[r] = __fmaf_rn(g, dx, fx[r]);
      fy[r] = __fmaf_rn(g, dy, fy[r]);
      fz[r] = __fmaf_rn(g, dz, fz[r]);
    }
  }
  float* ob = out + static_cast<size_t>(tile) * kTileRows * 3;
#pragma unroll
  for (int r = 0; r < kTileLaneRows; ++r) {
    float* o = ob + (lane + 32 * r) * 3;
    o[0] = 25.0f * fx[r];
    o[1] = 25.0f * fy[r];
    o[2] = 25.0f * fz[r];
  }
}

// ---------------------------------------------------------------- T3
// stack (3, K, L) f32: the mask, the tags' bits, the tags as values; one
// thread per (k, lane). For each offset o (in order), a row r of the
// offset's row set sits at lane (c + o) mod L; the pair's keys are
// (min, max) of the two tags (ordering 1) or (own tag, row tag) (0); the
// mixer gives theta: TEA of ``rounds`` rounds keyed by (step, seed)
// (mixer 0) or pair_uniform_fast of the two keys (1); where mask[k, c] *
// mask[r, c + o] > 0.5 theta joins the sum. Row set 0 is row 0; row set 1
// is every row, in groups of 8 rows, offsets inside a group.
__global__ void tea_roll_kernel(const float* __restrict__ stack,
                                const int32_t* __restrict__ iscal,
                                const int32_t* __restrict__ offs, int n_offs,
                                float* __restrict__ out, int k_dim, int len,
                                int mixer, int rounds, int ordering,
                                int all_rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k_dim * len) return;
  const int c = i % len;
  const float* mask = stack;
  const int32_t* tags = reinterpret_cast<const int32_t*>(stack + k_dim * len);
  const uint32_t step = static_cast<uint32_t>(iscal[0]);
  const uint32_t seed = static_cast<uint32_t>(iscal[1]);
  const int32_t self = tags[i];
  const float m_self = mask[i];
  float acc = 0.0f;
  const int groups = all_rows ? k_dim / 8 : 1;
  const int per_group = all_rows ? 8 : 1;
  for (int gr = 0; gr < groups; ++gr) {
    for (int o = 0; o < n_offs; ++o) {
      int src = (c + offs[o]) % len;
      if (src < 0) src += len;
      for (int r = 0; r < per_group; ++r) {
        const int row = gr * 8 + r;
        const int32_t other = tags[row * len + src];
        uint32_t lo, hi;
        if (ordering) {
          lo = static_cast<uint32_t>(self < other ? self : other);
          hi = static_cast<uint32_t>(self < other ? other : self);
        } else {
          lo = static_cast<uint32_t>(self);
          hi = static_cast<uint32_t>(other);
        }
        const float theta =
            mixer == 1 ? u32_to_symmetric_uniform(combine_symmetric(lo, hi))
                       : u32_to_symmetric_uniform(
                             tea_v0(lo, hi, step, seed, rounds));
        acc = acc + (m_self * mask[row * len + src] > 0.5f ? theta : 0.0f);
      }
    }
  }
  out[i] = acc;
}

// ---------------------------------------------------------------- T4
// view (n_chan, ny + 2, zc, plane) f32, plane = kp * l_lane; every one of
// the 4 x 2 output planes of grid cell (cy, cb) is view[0, cy + 1, cb] +
// view[1, cy + 2, cb]. Block (cell, slice) of the TPU grid's (cy, cb)
// cells: 16-byte loads of both planes, each output element written once.
__global__ void null_stage_kernel(const float4* __restrict__ view,
                                  float4* __restrict__ out, int ny, int zc,
                                  int plane4, int slice4) {
  const int cell = blockIdx.x;
  const int cy = cell / zc, cb = cell % zc;
  const size_t band = static_cast<size_t>(zc) * plane4;
  const float4* mid = view + (cy + 1) * band + static_cast<size_t>(cb) * plane4;
  const float4* down = view + static_cast<size_t>(ny + 2) * band +
                       (cy + 2) * band + static_cast<size_t>(cb) * plane4;
  const size_t out_plane = static_cast<size_t>(ny) * band;  // one (c, h)
  float4* ob = out + static_cast<size_t>(cy) * band +
               static_cast<size_t>(cb) * plane4;
  const int first = static_cast<int>(blockIdx.y) * slice4;
  const int end = min(plane4, first + slice4);
  for (int e = first + static_cast<int>(threadIdx.x); e < end;
       e += blockDim.x) {
    const float4 a = mid[e], b = down[e];
    const float4 s = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
#pragma unroll
    for (int p = 0; p < 8; ++p) ob[p * out_plane + e] = s;
  }
}

}  // namespace

extern "C" int meso_probe_dynroll(const void* x, const void* offs, int n_offs,
                                  void* out, int rows, int len,
                                  void* stream) {
  if (rows > 0 && len > 0)
    dynroll_kernel<<<rows, 256, len * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(offs),
        n_offs, static_cast<float*>(out), len);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meso_probe_cond(const void* x, const void* jm, void* out,
                               int n, void* stream) {
  if (n > 0)
    cond_kernel<<<(n + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(jm),
        static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Refused (cudaErrorInvalidValue, nothing launched): shapes gemm_kernel
// does not take, or more than 512 rows.
extern "C" int meso_probe_gemm(const void* a, const void* b, void* c,
                               int batch, int m, int n, int k, int a_trans,
                               void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  if (m <= 0 || m % 16 || m > 512 || n <= 0 || n % 8 ||
      (n > 32 && n % 32) || k <= 0 || k % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = gemm_smem_bytes(m, n, k, a_trans);
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  gemm_kernel<<<batch, 32 * (m / 16), smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), m, n, k, a_trans);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meso_probe_tile(const void* ai, const void* bj, void* out,
                               int batch, void* stream) {
  if (batch > 0)
    tile_kernel<<<(batch + kTileWarps - 1) / kTileWarps, 32 * kTileWarps, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ai), static_cast<const float*>(bj),
        static_cast<float*>(out), batch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meso_probe_tea_roll(const void* stack, const void* iscal,
                                   const void* offs, int n_offs, void* out,
                                   int k, int len, int mixer, int rounds,
                                   int ordering, int all_rows,
                                   void* stream) {
  const int n = k * len;
  if (n > 0)
    tea_roll_kernel<<<(n + 255) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(stack), static_cast<const int32_t*>(iscal),
        static_cast<const int32_t*>(offs), n_offs, static_cast<float*>(out),
        k, len, mixer, rounds, ordering, all_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meso_probe_null_stage(const void* view, void* out, int ny,
                                     int zc, int plane, void* stream) {
  const int plane4 = plane / 4;
  if (ny > 0 && zc > 0 && plane4 > 0) {
    const int threads = 256, per_block = threads * 4;
    const int slices = (plane4 + per_block - 1) / per_block;
    const dim3 grid(ny * zc, slices);
    null_stage_kernel<<<grid, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(view), static_cast<float4*>(out), ny, zc,
        plane4, per_block);
  }
  return static_cast<int>(cudaGetLastError());
}
