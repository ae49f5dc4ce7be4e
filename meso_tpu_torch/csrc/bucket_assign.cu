// Right-spill slot assignment of cell-sorted rows, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package wrote this step of the rebuild
// (meso_tpu/neighbor/bucket_layout.py::spill_assign) as XLA code, and the
// port ran it as plain torch (neighbor/bucket_layout.py::
// spill_assign_plain): 54 operations a call over every sorted row, around
// one torch.cummax that ATen scans as a single row, one block on one SM.
// At the 1M main path (nx 50, K 16, 2,500 (cy, cz) rows, 2,000,000 sorted
// rows) that scan alone took ~5.7 ms a call on an H100.
//
// The function, for sorted row i of segment b (its (cy, cz) row, base[i]),
// r_loc = i - (first row of b):
//   a     = max(cx * K - r_loc, 0)
//   am    = max of a over the rows of b up to i (the segmented cummax)
//   l     = r_loc + am (the row's linear slot in b's nx * K slots)
//   in_row  = valid & l < min((cx + 2) * K, nx * K)
//   wrap_ok = wrap & valid & !in_row & cx == nx - 1 & 0 <= m < K
//             & K - 1 - m >= c0_used    (m = l - nx * K; c0_used = the
//             rows of b in cell 0, at most K)
//   target = (b * K + slot) * nx + cell where it fits (cell 0 and slot
//            K - 1 - m for wrap_ok, else l / K and l % K), nr + i where not
//   overflow = the count of valid rows that do not fit.
//
// What bounds it: bytes. base, cx and valid read (17 B a row), target and
// fits written (9 B): 52 MB, 0.016 ms at 3.35 TB/s at the main path.
//
// Design: one block a segment b in [0, n_rows_yz). Warps 0 and 1 find the
// segment [s, e) in the sorted base at once, each by a 32-way search (a
// ballot over 32 probes narrows the range 32-fold: 5 dependent loads over
// 2,000,000 rows); with wrap, warp 0 then counts c0_used the same way over
// the segment's first K cx. The block walks the segment in chunks of
// kAssignThreads x kAssignRows rows, a thread kAssignRows consecutive ones:
// a thread's running max, the warp's inclusive max-scan by shuffles, the
// warps' maxima through shared memory, and the chunk's max carried to the
// next. Each row's target and fits are written once; the block's count of
// rows that do not fit goes to the overflow with one atomic (integer sums
// are exact in any order). Rows with base >= n_rows_yz are the padding
// tail (every caller keys masked rows nx * ny * nz, so they are exactly
// the invalid rows): blocks past the segments find where it starts and
// write fits 0 and target nr + i there, grid-stride, without a scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAssignThreads = 128;
constexpr int kAssignRows = 4;  // consecutive rows a thread takes a chunk
constexpr int kAssignChunk = kAssignThreads * kAssignRows;
constexpr int kAssignWarps = kAssignThreads / 32;
constexpr int kTailSpan = 8192;  // input rows a tail block is launched for
constexpr unsigned kFull = 0xffffffffu;

// The first index in [lo, hi) whose a[] is not below key (hi if none), for
// a[lo..hi) sorted ascending; every lane of the warp calls it and gets the
// answer. Keeps the answer in [lo, hi] while the range holds more than 32
// rows, probing it at 32 evenly spaced points.
__device__ __forceinline__ long long warp_lower_bound(const int64_t* a,
                                                      long long lo,
                                                      long long hi,
                                                      long long key) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long n = hi - lo;
    const unsigned ge = __ballot_sync(kFull, a[lo + n * lane / 32] >= key);
    const int f = __ffs(ge) - 1;
    if (f < 0) {
      lo += n * 31 / 32 + 1;
    } else {
      const long long nlo = f == 0 ? lo : lo + n * (f - 1) / 32 + 1;
      hi = lo + n * f / 32;
      lo = nlo;
    }
  }
  const unsigned ge =
      __ballot_sync(kFull, lo + lane < hi && a[lo + lane] >= key);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

template <bool kWrap>
__global__ void __launch_bounds__(kAssignThreads)
spill_assign_kernel(const int64_t* __restrict__ base,
                    const int64_t* __restrict__ cx,
                    const uint8_t* __restrict__ valid,
                    int64_t* __restrict__ target, uint8_t* __restrict__ fits,
                    unsigned long long* __restrict__ overflow, long long n_in,
                    long long nx, long long k, long long n_rows_yz) {
  __shared__ long long bounds[3];
  __shared__ long long warp_max[kAssignWarps];
  __shared__ unsigned long long warp_bad[kAssignWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long nr = n_rows_yz * k * nx;

  if (blockIdx.x >= n_rows_yz) {
    // the padding tail [t0, n_in): nothing fits there
    if (warp == 0) {
      const long long t0 = warp_lower_bound(base, 0, n_in, n_rows_yz);
      if (lane == 0) bounds[0] = t0;
    }
    __syncthreads();
    const long long stride =
        static_cast<long long>(gridDim.x - n_rows_yz) * kAssignThreads;
    for (long long i = bounds[0] +
                       (blockIdx.x - n_rows_yz) * static_cast<long long>(
                           kAssignThreads) + tid;
         i < n_in; i += stride) {
      target[i] = nr + i;
      fits[i] = 0;
    }
    return;
  }

  const long long b = blockIdx.x;
  if (warp < 2) {
    const long long at = warp_lower_bound(base, 0, n_in, b + warp);
    if (lane == 0) bounds[warp] = at;
  }
  __syncthreads();
  const long long s = bounds[0];
  const long long e = bounds[1];
  if (kWrap) {
    if (warp == 0) {
      const long long top = e < s + k ? e : s + k;
      const long long c0 = warp_lower_bound(cx, s, top, 1) - s;
      if (lane == 0) bounds[2] = c0;
    }
    __syncthreads();
  }
  const long long c0_used = kWrap ? bounds[2] : 0;

  long long carry = 0;
  unsigned long long bad = 0;
  for (long long c = s; c < e; c += kAssignChunk) {
    const long long i0 = c + static_cast<long long>(tid) * kAssignRows;
    long long cxr[kAssignRows], run[kAssignRows];
    bool vr[kAssignRows];
    long long m = 0;
#pragma unroll
    for (int r = 0; r < kAssignRows; ++r) {
      const long long i = i0 + r;
      cxr[r] = 0;
      vr[r] = false;
      if (i < e) {
        cxr[r] = cx[i];
        vr[r] = valid[i] != 0;
        const long long a = cxr[r] * k - (i - s);
        m = a > m ? a : m;
      }
      run[r] = m;
    }
    // the warp's inclusive max-scan of the threads' maxima
    long long incl = m;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d && o > incl) incl = o;
    }
    long long before = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) before = 0;
    if (lane == 31) warp_max[warp] = incl;
    __syncthreads();
    long long total = carry;
    before = before > carry ? before : carry;
    for (int w = 0; w < kAssignWarps; ++w) {
      const long long wm = warp_max[w];
      if (w < warp && wm > before) before = wm;
      if (wm > total) total = wm;
    }
    __syncthreads();  // warp_max is rewritten by the next chunk
    carry = total;
#pragma unroll
    for (int r = 0; r < kAssignRows; ++r) {
      const long long i = i0 + r;
      if (i >= e) break;
      const long long am = run[r] > before ? run[r] : before;
      const long long l = (i - s) + am;
      const long long cap = (cxr[r] + 2) * k < nx * k ? (cxr[r] + 2) * k
                                                      : nx * k;
      const bool in_row = vr[r] && l < cap;
      const long long over = l - nx * k;
      const bool wrap_ok = kWrap && vr[r] && !in_row && cxr[r] == nx - 1 &&
                           over >= 0 && over < k && k - 1 - over >= c0_used;
      const bool fit = in_row || wrap_ok;
      const long long cell = wrap_ok ? 0 : l / k;
      const long long slot = wrap_ok ? k - 1 - over : l - (l / k) * k;
      target[i] = fit ? (b * k + slot) * nx + cell : nr + i;
      fits[i] = fit;
      bad += vr[r] && !fit;
    }
  }
  // the block's rows that do not fit, to the overflow in one atomic
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) bad += __shfl_down_sync(kFull, bad, d);
  if (lane == 0) warp_bad[warp] = bad;
  __syncthreads();
  if (tid == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < kAssignWarps; ++w) sum += warp_bad[w];
    if (sum) atomicAdd(overflow, sum);
  }
}

template <bool kWrap>
cudaError_t launch_assign(const void* base, const void* cx, const void* valid,
                          void* target, void* fits, void* overflow, int n_in,
                          int nx, int k, int n_rows_yz, int blocks,
                          cudaStream_t st) {
  spill_assign_kernel<kWrap><<<blocks, kAssignThreads, 0, st>>>(
      static_cast<const int64_t*>(base), static_cast<const int64_t*>(cx),
      static_cast<const uint8_t*>(valid), static_cast<int64_t*>(target),
      static_cast<uint8_t*>(fits),
      static_cast<unsigned long long*>(overflow), n_in, nx, k, n_rows_yz);
  return cudaGetLastError();
}

}  // namespace

// The slot assignment of n_in cell-sorted rows: base and cx int64, valid
// one byte a row; target int64 and fits one byte a row written for every
// row, overflow one int64 set to 0 here and then summed into. One memset
// and one kernel on ``stream``: n_rows_yz segment blocks and a tail block
// for each kTailSpan input rows.
extern "C" int meso_spill_assign(const void* base, const void* cx,
                                 const void* valid, void* target, void* fits,
                                 void* overflow, int n_in, int nx, int k,
                                 int n_rows_yz, int wrap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(overflow, 0, sizeof(int64_t), st);
  if (e != cudaSuccess || n_in <= 0) return static_cast<int>(e);
  const int blocks = n_rows_yz + (n_in + kTailSpan - 1) / kTailSpan;
  return static_cast<int>(
      wrap ? launch_assign<true>(base, cx, valid, target, fits, overflow,
                                 n_in, nx, k, n_rows_yz, blocks, st)
           : launch_assign<false>(base, cx, valid, target, fits, overflow,
                                  n_in, nx, k, n_rows_yz, blocks, st));
}
