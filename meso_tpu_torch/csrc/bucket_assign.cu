// The sort rebuild's kernels, for Hopper (sm_90a): the right-spill slot
// assignment of cell-sorted rows (below), and the rebuild's two
// elementwise ends, the cell key of every row and the placement of every
// column into bucket order (after it).
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

#include <climits>
#include <cub/device/device_radix_sort.cuh>

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

// ---------------------------------------------------------------------------
// The cell keys and the placement.
//
// Replace no TPU kernel: the JAX package wrote both ends of the rebuild as
// XLA code, and the port ran them as plain torch chains
// (neighbor/bucket_layout.py::cell_keys_plain and place_rows_plain): about
// 30 and 50 operations a rebuild, each one launch the host issues, for
// work the card does in a few passes. They compute the same numbers bit
// for bit: every float operation is the one torch runs, rounded to nearest
// through the _rn intrinsics, which the compiler never contracts.
//
// Keys, a thread a row: with the deferred wrap, l = hi - lo, shift =
// floor((x - lo) / l), x' = x - shift * l (lo where x' >= hi), image' =
// image + shift; then c = clamp(int(((x' - lo) / l) * n), 0, n - 1) on each
// axis and key = (cy * nz + cz) * nx + cx, nx * ny * nz on masked rows.
// Bytes: 12 + 12 + 1 read, 12 + 12 + 8 written a row.
//
// Placement: the inverse of the fitting rows' targets (inv[r] = the sorted
// row i that fits with target[i] = r, -1 where none does: a memset and a
// thread a sorted row; the fitting targets are distinct), then a thread an
// output row r: with j = inv[r] >= 0 the row takes input row order[j] of
// every column, zeros where j < 0; with wrap relief, the rows that fit in
// cell 0 from cell nx - 1 (cx[j] == nx - 1, target[j] % nx == 0) move one
// box image left along x, x - L and image + 1 (every other row adds 0 to
// x, as torch does). The plain chain keys the rows that do not fit to the
// free slots and inverts that whole permutation instead: the same rows
// are empty. Bytes: every column read and written once a row, plus
// target, fits, inv and order (33 B).

namespace {

constexpr int kRowThreads = 256;
constexpr int kMaxColumns = 16;

struct Columns {
  const uint8_t* src[kMaxColumns];
  uint8_t* dst[kMaxColumns];
  int width[kMaxColumns];  // bytes a row, a multiple of 4 or less than 4
  int n;
};

__global__ void __launch_bounds__(kRowThreads)
cell_keys_kernel(const float* __restrict__ x, const int* __restrict__ image,
                 const uint8_t* __restrict__ mask,
                 const float* __restrict__ lo, const float* __restrict__ hi,
                 float* __restrict__ x_out, int* __restrict__ image_out,
                 int64_t* __restrict__ key, long long n, int nx, int ny,
                 int nz, int wrap) {
  const long long i = blockIdx.x * static_cast<long long>(kRowThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const int ncell[3] = {nx, ny, nz};
  int c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float lod = lo[d];
    const float hid = hi[d];
    const float l = __fsub_rn(hid, lod);
    float xd = x[3 * i + d];
    if (wrap) {
      const int shift =
          static_cast<int>(floorf(__fdiv_rn(__fsub_rn(xd, lod), l)));
      float xw = __fsub_rn(xd, __fmul_rn(static_cast<float>(shift), l));
      if (xw >= hid) xw = lod;
      x_out[3 * i + d] = xw;
      image_out[3 * i + d] = image[3 * i + d] + shift;
      xd = xw;
    }
    const float frac = __fdiv_rn(__fsub_rn(xd, lod), l);
    const int cd = static_cast<int>(
        __fmul_rn(frac, static_cast<float>(ncell[d])));
    c[d] = min(max(cd, 0), ncell[d] - 1);
  }
  key[i] = mask[i] ? (static_cast<int64_t>(c[1]) * nz + c[2]) * nx + c[0]
                   : static_cast<int64_t>(nx) * ny * nz;
}

__global__ void __launch_bounds__(kRowThreads)
invert_kernel(const int64_t* __restrict__ target,
              const uint8_t* __restrict__ fits, int64_t* __restrict__ inv,
              long long n_in) {
  const long long i = blockIdx.x * static_cast<long long>(kRowThreads) +
                      threadIdx.x;
  if (i < n_in && fits[i]) inv[target[i]] = i;
}

__global__ void __launch_bounds__(kRowThreads)
place_kernel(const Columns cols, const int64_t* __restrict__ order,
             const int64_t* __restrict__ inv,
             const int64_t* __restrict__ cx,
             const int64_t* __restrict__ target, int x_col, int image_col,
             const float* __restrict__ lo, const float* __restrict__ hi,
             long long nx, long long nr) {
  const long long r = blockIdx.x * static_cast<long long>(kRowThreads) +
                      threadIdx.x;
  if (r >= nr) return;
  const long long j = inv[r];
  const bool live = j >= 0;
  const long long s = live ? order[j] : 0;
  for (int c = 0; c < cols.n; ++c) {
    const int w = cols.width[c];
    if (w % 4 == 0) {
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(cols.src[c] + s * w);
      uint32_t* dst = reinterpret_cast<uint32_t*>(cols.dst[c] + r * w);
      for (int q = 0; q < w / 4; ++q) dst[q] = live ? src[q] : 0u;
    } else {
      const uint8_t* src = cols.src[c] + s * w;
      uint8_t* dst = cols.dst[c] + r * w;
      for (int q = 0; q < w; ++q) dst[q] = live ? src[q] : 0;
    }
  }
  if (cx != nullptr) {
    const bool relief = live && cx[j] == nx - 1 && target[j] % nx == 0;
    float* xr = reinterpret_cast<float*>(cols.dst[x_col] + r * 12);
    const float lx = __fsub_rn(hi[0], lo[0]);
    xr[0] = __fadd_rn(xr[0], relief ? -lx : 0.0f);
    int* ir = reinterpret_cast<int*>(cols.dst[image_col] + r * 12);
    ir[0] += relief ? 1 : 0;
  }
}

}  // namespace

// The cell key (int64) of each of n rows: x float32 (n, 3), mask one byte
// a row, lo and hi the box's (3,) float32 on the card. With wrap, image
// int32 (n, 3) is read and the wrapped x and image are written to x_out and
// image_out (n, 3) before the keys are taken from them; without, image,
// x_out and image_out are not touched (may be null). One kernel on
// ``stream``.
extern "C" int meso_bucket_keys(const void* x, const void* image,
                                const void* mask, const void* lo,
                                const void* hi, void* x_out, void* image_out,
                                void* key, int n, int nx, int ny, int nz,
                                int wrap, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kRowThreads - 1) / kRowThreads;
  cell_keys_kernel<<<blocks, kRowThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const int*>(image),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<float*>(x_out),
      static_cast<int*>(image_out), static_cast<int64_t*>(key), n, nx, ny,
      nz, wrap);
  return static_cast<int>(cudaGetLastError());
}

// The placement of n_cols columns of n_in rows into nr bucket rows: src
// and dst arrays of n_cols row-major column pointers (host memory), width
// the bytes a row of each (a multiple of 4, or 1 to 3); order, target
// (int64) and fits (one byte) of the n_in sorted rows as the sort rebuild
// gives them, the fitting targets distinct and below nr; inv (int64, nr)
// scratch, written. cx (int64, by sorted row) asks for the wrap relief on
// columns x_col (float32 (nr, 3)) and image_col (int32 (nr, 3)); null cx
// asks for none. Returns cudaErrorInvalidValue for more than 16 columns.
// A memset and two kernels on ``stream``.
extern "C" int meso_bucket_place(const void* src, const void* dst,
                                 const void* width, int n_cols,
                                 const void* order, const void* target,
                                 const void* fits, void* inv,
                                 const void* cx, int x_col, int image_col,
                                 const void* lo, const void* hi, int nx,
                                 int n_in, int nr, void* stream) {
  if (n_cols < 0 || n_cols > kMaxColumns)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nr <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(inv, 0xFF, sizeof(int64_t) * nr, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_in > 0) {
    invert_kernel<<<(n_in + kRowThreads - 1) / kRowThreads, kRowThreads, 0,
                    st>>>(static_cast<const int64_t*>(target),
                          static_cast<const uint8_t*>(fits),
                          static_cast<int64_t*>(inv), n_in);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Columns cols;
  cols.n = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    cols.src[c] = static_cast<const uint8_t* const*>(src)[c];
    cols.dst[c] = static_cast<uint8_t* const*>(dst)[c];
    cols.width[c] = static_cast<const int*>(width)[c];
  }
  const int blocks = (nr + kRowThreads - 1) / kRowThreads;
  place_kernel<<<blocks, kRowThreads, 0, st>>>(
      cols, static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(inv), static_cast<const int64_t*>(cx),
      static_cast<const int64_t*>(target),
      x_col, image_col, static_cast<const float*>(lo),
      static_cast<const float*>(hi), nx, nr);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The spill rebuild whole, one call from the host.
//
// The steps of neighbor/bucket_layout.py::rebuild_buckets_sort on the spill
// layout, each as above or as torch runs it, on one stream: the cell keys
// (with the deferred wrap), a stable radix sort of (key, row) over the key's
// low key_bits bits (cub::DeviceRadixSort, which keeps rows of equal keys in
// input order, as torch.sort(stable=True) does, so the order is the same),
// the split of each sorted key into its (cy, cz) row, cx and validity, the
// slot assignment, and the placement. The host issues one call where the
// torch chain issues about 25 operations; the card does the same work.

namespace {

__global__ void __launch_bounds__(kRowThreads)
iota_kernel(int64_t* __restrict__ a, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(kRowThreads) +
                      threadIdx.x;
  if (i < n) a[i] = i;
}

__global__ void __launch_bounds__(kRowThreads)
split_kernel(const int64_t* __restrict__ key_s, int64_t* __restrict__ base,
             int64_t* __restrict__ cx, uint8_t* __restrict__ valid,
             long long n, long long nx, long long n_cells) {
  const long long i = blockIdx.x * static_cast<long long>(kRowThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const long long key = key_s[i];
  const long long b = key / nx;
  base[i] = b;
  cx[i] = key - b * nx;
  valid[i] = key < n_cells;
}

constexpr size_t kAlign = 256;

size_t aligned(size_t b) { return (b + kAlign - 1) / kAlign * kAlign; }

// The workspace of a rebuild of n rows, in order: key, sorted key, rows,
// order, base, cx, target (int64), inv (int64, n), valid, fits (bytes),
// with the wrap x and image (12 bytes a row each), then the sort's own
// scratch. Returns the total, 0 on an error.
size_t workspace(long long n, int key_bits, int wrap, size_t* sort_at,
                 size_t* sort_bytes) {
  size_t temp = 0;
  if (cub::DeviceRadixSort::SortPairs(
          nullptr, temp, static_cast<const int64_t*>(nullptr),
          static_cast<int64_t*>(nullptr), static_cast<const int64_t*>(nullptr),
          static_cast<int64_t*>(nullptr), static_cast<int>(n), 0,
          key_bits) != cudaSuccess)
    return 0;
  size_t at = 8 * aligned(8 * n) + 2 * aligned(n);
  if (wrap) at += 2 * aligned(12 * n);
  if (sort_at) *sort_at = at;
  if (sort_bytes) *sort_bytes = temp;
  return at + aligned(temp);
}

}  // namespace

// The bytes of the workspace meso_bucket_rebuild takes for n rows (a key
// of key_bits bits, with or without the wrap); -1 where that is more than
// INT_MAX or the sort cannot say.
extern "C" int meso_bucket_rebuild_bytes(int n, int key_bits, int wrap) {
  if (n <= 0 || key_bits <= 0 || key_bits > 64) return -1;
  const size_t b = workspace(n, key_bits, wrap, nullptr, nullptr);
  return b == 0 || b > static_cast<size_t>(INT_MAX) ? -1
                                                      : static_cast<int>(b);
}

// The spill rebuild of n bucket rows into as many (n = ny * nz * k * nx):
// x float32 (n, 3), image int32 (n, 3), mask one byte a row, the box's lo
// and hi (3,) on the card; n_cols columns to place as meso_bucket_place
// takes them (src, dst, width; x and image at x_col and image_col, which
// the wrap replaces by their wrapped copies); work of
// meso_bucket_rebuild_bytes(n, key_bits, wrap) bytes, 256-byte aligned;
// overflow one int64, written. With wrap, the deferred wrap and the wrap
// relief. key_bits covers nx * ny * nz (the masked rows' key). On
// ``stream``: the keys, the sort, the split, the assignment's memset and
// kernel, the placement's memset and two kernels.
extern "C" int meso_bucket_rebuild(const void* x, const void* image,
                                   const void* mask, const void* lo,
                                   const void* hi, const void* src,
                                   const void* dst, const void* width,
                                   int n_cols, int x_col, int image_col,
                                   void* work, void* overflow, int n, int nx,
                                   int ny, int nz, int k, int key_bits,
                                   int wrap, void* stream) {
  if (n_cols < 0 || n_cols > kMaxColumns || x_col < 0 || x_col >= n_cols ||
      image_col < 0 || image_col >= n_cols || n <= 0 || nx <= 0 ||
      static_cast<long long>(ny) * nz * k * nx != n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t sort_at = 0, sort_bytes = 0;
  if (workspace(n, key_bits, wrap, &sort_at, &sort_bytes) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  uint8_t* w = static_cast<uint8_t*>(work);
  const size_t i64 = aligned(8 * static_cast<size_t>(n));
  int64_t* key = reinterpret_cast<int64_t*>(w);
  int64_t* key_s = reinterpret_cast<int64_t*>(w + i64);
  int64_t* rows = reinterpret_cast<int64_t*>(w + 2 * i64);
  int64_t* order = reinterpret_cast<int64_t*>(w + 3 * i64);
  int64_t* base = reinterpret_cast<int64_t*>(w + 4 * i64);
  int64_t* cx = reinterpret_cast<int64_t*>(w + 5 * i64);
  int64_t* target = reinterpret_cast<int64_t*>(w + 6 * i64);
  int64_t* inv = reinterpret_cast<int64_t*>(w + 7 * i64);
  uint8_t* valid = w + 8 * i64;
  uint8_t* fits = valid + aligned(n);
  float* x_w = reinterpret_cast<float*>(fits + aligned(n));
  int* image_w = reinterpret_cast<int*>(
      reinterpret_cast<uint8_t*>(x_w) + aligned(12 * static_cast<size_t>(n)));
  const int blocks = (n + kRowThreads - 1) / kRowThreads;
  const long long n_cells = static_cast<long long>(nx) * ny * nz;

  cell_keys_kernel<<<blocks, kRowThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const int*>(image),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(lo),
      static_cast<const float*>(hi), wrap ? x_w : nullptr,
      wrap ? image_w : nullptr, key, n, nx, ny, nz, wrap);
  iota_kernel<<<blocks, kRowThreads, 0, st>>>(rows, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cub::DeviceRadixSort::SortPairs(w + sort_at, sort_bytes, key, key_s,
                                      rows, order, n, 0, key_bits, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  split_kernel<<<blocks, kRowThreads, 0, st>>>(key_s, base, cx, valid, n, nx,
                                               n_cells);
  e = cudaMemsetAsync(overflow, 0, sizeof(int64_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_rows_yz = ny * nz;
  e = launch_assign<true>(base, cx, valid, target, fits, overflow, n, nx, k,
                          n_rows_yz,
                          n_rows_yz + (n + kTailSpan - 1) / kTailSpan, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(inv, 0xFF, sizeof(int64_t) * n, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  invert_kernel<<<blocks, kRowThreads, 0, st>>>(target, fits, inv, n);
  Columns cols;
  cols.n = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    cols.src[c] = static_cast<const uint8_t* const*>(src)[c];
    cols.dst[c] = static_cast<uint8_t* const*>(dst)[c];
    cols.width[c] = static_cast<const int*>(width)[c];
  }
  if (wrap) {
    cols.src[x_col] = reinterpret_cast<const uint8_t*>(x_w);
    cols.src[image_col] = reinterpret_cast<const uint8_t*>(image_w);
  }
  place_kernel<<<blocks, kRowThreads, 0, st>>>(
      cols, order, inv, wrap ? cx : nullptr, target, x_col, image_col,
      static_cast<const float*>(lo), static_cast<const float*>(hi), nx, n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The largest squared displacement since the rebuild (the skin check's
// number, neighbor/cells.py::max_displacement_sq), over the valid rows: d =
// x - x_ref, d - round(d / l) * l (round half to even, as torch.round), d2
// = (dx dx + dy dy) + dz dz, each operation rounded as torch rounds it; the
// block's maximum, then one atomic maximum a block on the float's bits
// (d2 >= 0, so the bits order as the values; a maximum is the same in any
// order). Bytes: 24 read a row and the mask.

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
max_disp_kernel(const float* __restrict__ x, const float* __restrict__ x_ref,
                const uint8_t* __restrict__ mask,
                const float* __restrict__ lo, const float* __restrict__ hi,
                unsigned int* __restrict__ out, long long n) {
  __shared__ unsigned int warp_max[kMaxThreads / 32];
  const long long i = blockIdx.x * static_cast<long long>(kMaxThreads) +
                      threadIdx.x;
  float d2 = 0.0f;
  if (i < n && mask[i]) {
    float d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float l = __fsub_rn(hi[a], lo[a]);
      const float dr = __fsub_rn(x[3 * i + a], x_ref[3 * i + a]);
      d[a] = __fsub_rn(dr, __fmul_rn(rintf(__fdiv_rn(dr, l)), l));
    }
    d2 = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                   __fmul_rn(d[2], d[2]));
  }
  unsigned int bits = __float_as_uint(d2);
  for (int o = 16; o > 0; o >>= 1)
    bits = max(bits, __shfl_down_sync(0xffffffffu, bits, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int m = 0;
    for (int w = 0; w < kMaxThreads / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(out, m);
  }
}

}  // namespace

// The largest squared displacement of the n rows' x (float32 (n, 3)) from
// x_ref over the rows where mask (one byte a row), as one float32 written
// to out; the box's lo and hi (3,) on the card. A memset and one kernel on
// ``stream``.
extern "C" int meso_max_displacement(const void* x, const void* x_ref,
                                     const void* mask, const void* lo,
                                     const void* hi, void* out, int n,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float), st);
  if (e != cudaSuccess || n <= 0) return static_cast<int>(e);
  max_disp_kernel<<<(n + kMaxThreads - 1) / kMaxThreads, kMaxThreads, 0,
                    st>>>(static_cast<const float*>(x),
                          static_cast<const float*>(x_ref),
                          static_cast<const uint8_t*>(mask),
                          static_cast<const float*>(lo),
                          static_cast<const float*>(hi),
                          static_cast<unsigned int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
