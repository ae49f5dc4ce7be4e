// The cell-tile machinery of the Hopper pair kernels (sm_90a), shared by
// K1 (pair_dpd_v3_kernel), K1's general variant (pair_dpd_v3_general_kernel),
// K2 (pair_edpd_v3_kernel) and K3 (pair_tdpd_v3_kernel) over bucket rows,
// and by the brick kernel (pair_brick_kernel: K4-K7, K6-halo) over a padded
// brick of channel planes.
//
// A block owns a tile of target cells: one (cy, cz) and a run of up to W
// consecutive cx (kernels/cell_tiles.py plans W, the threads and the
// dynamic shared memory, and builds the table row each block reads). It
// stages the sources of its 3 x 3 (dy, dz) lines x (W + 2 xr) columns in
// shared memory, each slot-cell compacted to its valid slots, then one
// thread a valid target walks only the occupied slots of its stencil,
// culls the sources inside the walk's radius into a list of list_cap
// entries and evaluates the list when it is full and at the end, so any
// density is exact. Phases, with a barrier between each:
//  A. one warp a line, lanes over its source columns: each column's slot
//     mask from its K valid flags, its count by popc, and by a warp scan
//     its first staged index (line l staged from l * line_cap on, in
//     (column, slot) order);
//  B. items (line, slot, column), column fastest (neighbouring rows or
//     brick indices, so the loads coalesce), kStageU a thread with their
//     loads in flight together: each valid source's staged record (a
//     float4, and for bucket rows its row); the target line's empty slots
//     get their outputs zeroed here;
//  C. one thread a valid target (the target line's slots in the run, in
//     staged order: lanes of a warp share cells, and read the same sources
//     as a broadcast): it walks its stencil's occupied slots only, each
//     line's 2 xr + 1 slot-cells being one contiguous range, kWalkU
//     candidates at a time, and appends the staged index of each source
//     inside the walk's radius to its uint16 list; when the list is full,
//     and after the walk, it evaluates the list, each entry's gathers
//     issued one entry ahead of its arithmetic. The visitor thus runs for
//     as many entries as the warp's longest list, not for every candidate
//     step on which one lane is in range. Each row sums its pairs in the
//     order (dy, dz, dx, slot) and is written once: a full traversal, no
//     atomics.
//
// Two things vary, as template arguments of run_tile:
// - the source policy (BucketRows, BrickPlanes): where the valid flags and
//   positions come from and what a staged record holds;
// - the visitor: what it gathers for an in-range entry, the pair it
//   evaluates, what it accumulates and writes. Its interface:
//     zero(row)            outputs of an empty target slot (phase B);
//     init()               block constants, at the start of phase C;
//     walk_rc2()           the walk's radius squared;
//     begin(row, self)     a target's fields (self: its gather index);
//     Gathered fetch(j)    an entry's fields (j: its gather index);
//     pair(g, j, dr)       one entry, dr = x_target - x_source;
//     end(row)             the target's outputs.
// and the periodic rule (Wrap):
// - kShift (wrap_mode "rebuild", no minimum image): dr = (xi - xj) - shift,
//   the shift being the wrap of the source's line (y, z; in shared memory)
//   and column (x; the record's fourth word), as the plain version shifts
//   its pads: the two rows of a pair get exactly opposite dr;
// - kImageAll: the minimum image on every candidate (K1's min-image mode);
// - kImageRaw: the walk tests the raw difference, which is the minimum
//   image unless an axis wraps, and a wrap makes r^2 exceed a quarter of
//   the box's smallest length squared: only those candidates take the
//   minimum image (raw r^2 > 0.24 L_min^2); the visitor's dr is the
//   minimum image. The target itself (r^2 = 0) enters the list and the
//   visitor drops it.
// ptxas (CUDA 12.9, -O1 and up) miscompiled K1's first tile walk, which
// carried per-line state across one loop over the nine lines (PERF.md,
// PR 7): each line's bounds and shifts are read inside that line's pass.

#pragma once

#include "dpd_common.cuh"

namespace meso {
namespace tiles {

constexpr int kLines = 9;
constexpr int kTargetLine = 4;  // (dy, dz) = (0, 0)
constexpr int kHead = 4;        // cy, cz, cx0, width
constexpr int kTileMaxThreads = 256;
constexpr int kStageU = 4;  // staged items a thread loads at once
constexpr int kWalkU = 4;   // candidates a thread tests at once

enum Wrap { kShift = 0, kImageAll = 1, kImageRaw = 2 };

// The block's dynamic shared memory, in bytes from its start; the wrappers
// compute the same (kernels/cell_tiles.py::smem_bytes, brick_smem_bytes)
// and a launch whose size differs is refused. ncols is a full-width
// block's; row_bytes, hdr_words and lsh_words are the source policy's.
struct TileLayout {
  int pos, rows, off, mask, hdr, lsh, list, total;
};

__host__ __device__ inline TileLayout tile_layout(int ncols, int k,
                                                  int threads, int list_cap,
                                                  int row_bytes,
                                                  int hdr_words,
                                                  int lsh_words) {
  const int s = kLines * ncols * k;
  const int words = (k + 31) / 32;
  TileLayout l;
  int b = 0;
  l.pos = b;
  b += 16 * s;
  l.rows = b;
  b += row_bytes * s;
  l.off = b;
  b += 4 * kLines * (ncols + 1);
  l.mask = b;
  b += 4 * kLines * ncols * words;
  l.hdr = b;
  b += 4 * hdr_words;
  l.lsh = b;
  b += 4 * lsh_words;
  l.list = b;
  b += 2 * list_cap * threads;
  l.total = (b + 15) / 16 * 16;
  return l;
}

template <class Src>
__host__ __device__ inline TileLayout layout_of(int ncols, int k, int threads,
                                                int list_cap) {
  return tile_layout(ncols, k, threads, list_cap, Src::kRowBytes,
                     Src::table_width(ncols), Src::kLshWords);
}

// A launch the kernels cannot take: a block of more than kTileMaxThreads
// threads or not whole warps, more than 32 source columns (one warp's
// lanes stage them), more staged slots than the lists' uint16 index
// reaches, or a smem_bytes that differs from the layout's.
template <class Src>
inline bool tile_launch_refused(int width, int xr, int k, int threads,
                                int list_cap, int smem_bytes) {
  const int ncols = width + 2 * xr;
  return threads <= 0 || threads > kTileMaxThreads || threads % 32 != 0 ||
         ncols > 32 || kLines * ncols * k > (1 << 16) || list_cap <= 0 ||
         layout_of<Src>(ncols, k, threads, list_cap).total != smem_bytes;
}

// Sets the kernel's dynamic shared memory and launches it.
template <class Kernel, class Args>
cudaError_t launch_tile(Kernel kernel, const Args& args, dim3 grid,
                        int threads, int smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

// Bucket rows (row = ((cy * ncz + cz) * K + slot) * ncx + cx) through K1's
// tile table (kernels/cell_tiles.py::tile_table): a table row holds the
// head, each line's first row and its y and z wrap codes, then each
// source column's sx and x wrap code. A staged record is (x, y, z, the x
// wrap shift; 0 under the minimum image) and the source's row; the lines'
// (y, z) shifts sit in shared memory. valid is one byte a row.
struct BucketRows {
  static constexpr int kLineFields = 3;
  static constexpr int kCol0 = kHead + kLineFields * kLines;
  static constexpr int kRowBytes = 4;
  static constexpr int kLshWords = 2 * kLines;
  __host__ __device__ static int table_width(int ncols) {
    return kCol0 + 2 * ncols;
  }

  const uint8_t* __restrict__ valid;
  const float* __restrict__ x;
  int nx;

  __device__ void setup(const int* hdr, float* lsh, int tid, float ly,
                        float lz) const {
    if (tid < kLines) {
      lsh[2 * tid] = static_cast<float>(hdr[kHead + 3 * tid + 1]) * ly;
      lsh[2 * tid + 1] = static_cast<float>(hdr[kHead + 3 * tid + 2]) * lz;
    }
  }
  // the valid flag of slot 0 of source column c of a line; slot j lies
  // j * stride() further on
  __device__ const uint8_t* column(const int* hdr, int line, int c) const {
    return valid + hdr[kHead + 3 * line] + hdr[kCol0 + 2 * c];
  }
  __device__ int stride() const { return nx; }
  __device__ bool valid_at(const uint8_t* vb, int i) const {
    return vb[i] != 0;
  }
  __device__ int row(const int* hdr, const int3&, int line, int c,
                     int slot) const {
    return hdr[kHead + 3 * line] + slot * nx + hdr[kCol0 + 2 * c];
  }
  template <bool kShiftRecord>
  __device__ float4 record(const int* hdr, int, int c, int, int r,
                           float lx) const {
    return make_float4(x[3 * r], x[3 * r + 1], x[3 * r + 2],
                       kShiftRecord
                           ? static_cast<float>(hdr[kCol0 + 2 * c + 1]) * lx
                           : 0.0f);
  }
  __device__ void put(float4* pos, int* rows, int at, float4 q,
                      int r) const {
    pos[at] = q;
    rows[at] = r;
  }
  // the gather index of staged entry s (its row) and a target's row
  __device__ int source(int s, const float4&, const int* rows) const {
    return rows[s];
  }
  __device__ void target(int si, const float4&, int, const int* rows,
                         const int3&, int& row, int& self) const {
    row = self = rows[si];
  }
};

// The padded brick of channel planes (kernels/_brick.py) through
// brick_table: a table row holds the head and each line's brick index of
// slot 0 at the block's first source column; nothing wraps (the pads hold
// the periodic copy or the halos). A staged record is (x, y, z, the brick
// index as the fourth word); valid is channel 1 of the int32 planes.
struct BrickPlanes {
  static constexpr int kRowBytes = 0;
  static constexpr int kLshWords = 0;
  __host__ __device__ static int table_width(int) { return kHead + kLines; }

  const int32_t* __restrict__ validb;
  const float* __restrict__ fb;
  size_t chan;
  int px, nx, nz, k, xr;

  __device__ void setup(const int*, float*, int, float, float) const {}
  __device__ const int32_t* column(const int* hdr, int line, int c) const {
    return validb + hdr[kHead + line] + c;
  }
  __device__ int stride() const { return px; }
  // the brick is read through the read-only data path (__ldg), as the
  // visitor reads it
  __device__ bool valid_at(const int32_t* vb, int i) const {
    return __ldg(vb + i) != 0;
  }
  // blk: the block's (cy, cz, cx0)
  __device__ int row(const int*, const int3& blk, int, int c,
                     int slot) const {
    return ((blk.x * nz + blk.y) * k + slot) * nx + blk.z + c - xr;
  }
  template <bool>
  __device__ float4 record(const int* hdr, int line, int c, int slot, int,
                           float) const {
    const int e = hdr[kHead + line] + slot * px + c;
    return make_float4(__ldg(fb + e), __ldg(fb + chan + e),
                       __ldg(fb + 2 * chan + e), __int_as_float(e));
  }
  __device__ void put(float4* pos, int*, int at, float4 q, int) const {
    pos[at] = q;
  }
  __device__ int source(int, const float4& q, const int*) const {
    return __float_as_int(q.w);
  }
  __device__ void target(int, const float4& pi, int tc, const int*,
                         const int3& blk, int& row, int& self) const {
    self = __float_as_int(pi.w);
    const int slot = (self / px) % k;
    row = ((blk.x * nz + blk.y) * k + slot) * nx + blk.z + tc - xr;
  }
};

// The kernel body: block blockIdx.x of the plan, its table row in
// ``table`` (Src::table_width(width + 2 xr) int32 a block).
template <int kWrap, class Src, class Vis>
__device__ __forceinline__ void run_tile(const Src& src, Vis& vis,
                                         const int32_t* __restrict__ table,
                                         int k, int xr, int width_max,
                                         int list_cap,
                                         const float* box_lo,
                                         const float* box_hi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncols_max = width_max + 2 * xr;
  const TileLayout lay = layout_of<Src>(ncols_max, k, blockDim.x, list_cap);
  float4* pos = reinterpret_cast<float4*>(smem + lay.pos);
  int* rows = reinterpret_cast<int*>(smem + lay.rows);
  int* off = reinterpret_cast<int*>(smem + lay.off);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + lay.mask);
  int* hdr = reinterpret_cast<int*>(smem + lay.hdr);
  float* lsh = reinterpret_cast<float*>(smem + lay.lsh);
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + lay.list);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int tw = Src::table_width(ncols_max);
  const int32_t* trow = table + static_cast<size_t>(blockIdx.x) * tw;
  for (int i = tid; i < tw; i += nthreads) hdr[i] = trow[i];
  __syncthreads();

  const int3 blk = make_int3(hdr[0], hdr[1], hdr[2]);  // cy, cz, cx0
  const int width = hdr[3];
  const int ncols = width + 2 * xr;
  const int words = (k + 31) >> 5;
  const float lx = box_hi[0] - box_lo[0];
  const float ly = box_hi[1] - box_lo[1];
  const float lz = box_hi[2] - box_lo[2];
  src.setup(hdr, lsh, tid, ly, lz);

  // A: masks, counts and each column's first staged index
  const int line_cap = ncols_max * k;
  const int vstride = src.stride();
  for (int line = warp; line < kLines; line += nwarps) {
    int cnt = 0;
    if (lane < ncols) {
      const int sc = line * ncols + lane;
      const auto* vb = src.column(hdr, line, lane);
      for (int w = 0; w < words; ++w) {
        const int m = min(32, k - 32 * w);
        uint32_t bits = 0u;
#pragma unroll 8
        for (int j = 0; j < m; ++j)
          bits |= static_cast<uint32_t>(
                      src.valid_at(vb, (32 * w + j) * vstride)) << j;
        mask[sc * words + w] = bits;
        cnt += __popc(bits);
      }
    }
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    const int first = line * line_cap + incl - cnt;
    if (lane < ncols) off[line * (ncols + 1) + lane] = first;
    if (lane == ncols - 1) off[line * (ncols + 1) + ncols] = first + cnt;
  }
  __syncthreads();

  // B: stage the valid sources, compacted; zero the empty target rows
  const int tcell0 = kTargetLine * (ncols + 1) + xr;
  const int tbase = off[tcell0];
  const int n_items = kLines * k * ncols;
  for (int i0 = tid; i0 < n_items; i0 += kStageU * nthreads) {
    float4 q[kStageU];
    int at[kStageU], row[kStageU];
    bool ok[kStageU], target[kStageU];
#pragma unroll
    for (int u = 0; u < kStageU; ++u) {
      const int i = i0 + u * nthreads;
      ok[u] = target[u] = false;
      if (i >= n_items) continue;
      const int ls = i / ncols, c = i - ls * ncols;
      const int line = ls / k, slot = ls - line * k;
      const int sc = line * ncols + c;
      row[u] = src.row(hdr, blk, line, c, slot);
      const int w = slot >> 5, bit = slot & 31;
      const uint32_t bits = mask[sc * words + w];
      target[u] = line == kTargetLine && c >= xr && c < xr + width;
      ok[u] = (bits >> bit) & 1u;
      if (!ok[u]) continue;
      int idx = off[line * (ncols + 1) + c] +
                __popc(bits & ((1u << bit) - 1u));
      for (int w2 = 0; w2 < w; ++w2) idx += __popc(mask[sc * words + w2]);
      at[u] = idx;
      q[u] = src.template record<kWrap == kShift>(hdr, line, c, slot, row[u],
                                                  lx);
    }
#pragma unroll
    for (int u = 0; u < kStageU; ++u) {
      if (ok[u]) {
        src.put(pos, rows, at[u], q[u], row[u]);
      } else if (target[u]) {
        vis.zero(row[u]);
      }
    }
  }
  __syncthreads();

  // C: walk, cull, evaluate
  const int n_t = off[tcell0 + width] - tbase;
  vis.init();
  const float rc2 = vis.walk_rc2();
  const float inv_lx = 1.0f / lx, inv_ly = 1.0f / ly, inv_lz = 1.0f / lz;
  // an axis whose difference the minimum image wraps has |dr| > 0.49 L
  const float l_min = fminf(lx, fminf(ly, lz));
  const float wrap2 = 0.24f * l_min * l_min;
  auto min_image = [&](const float4& pi, const float4& q, float& drx,
                       float& dry, float& drz) {
    drx = pi.x - q.x;
    dry = pi.y - q.y;
    drz = pi.z - q.z;
    drx -= rintf(drx * inv_lx) * lx;
    dry -= rintf(dry * inv_ly) * ly;
    drz -= rintf(drz * inv_lz) * lz;
  };
  uint16_t* my = list + tid;
  for (int t0 = 0; t0 < n_t; t0 += nthreads) {
    const int t = t0 + tid;
    if (t >= n_t) continue;
    const int si = tbase + t;
    int tc = xr;
    while (si >= off[kTargetLine * (ncols + 1) + tc + 1]) ++tc;
    const float4 pi = pos[si];
    int row_i, self;
    src.target(si, pi, tc, rows, blk, row_i, self);
    vis.begin(row_i, self);
    int line = 0, s = off[tc - xr];  // line 0
    while (true) {
      // walk from (line, s) until the list is full or the stencil ends
      int n = 0;
      for (; line < kLines; ++line) {
        const int e = off[line * (ncols + 1) + tc + xr + 1];
        if (kWrap == kImageRaw) {
          auto raw_r2 = [&](int j) {
            const float4 q = pos[j];
            const float drx = pi.x - q.x, dry = pi.y - q.y,
                        drz = pi.z - q.z;
            return drx * drx + dry * dry + drz * drz;
          };
          auto image_in = [&](int j) {
            float drx, dry, drz;
            min_image(pi, pos[j], drx, dry, drz);
            return drx * drx + dry * dry + drz * drz < rc2;
          };
          // kWalkU candidates a step (independent loads) while the list
          // has room for them all, then one at a time; the step's in-range
          // flags as a bit mask (ptxas packed a bool array into bytes on
          // the common path, and the brick kernel ran slower in a timing
          // trial on an H100: PERF.md, PR 9)
          for (; s + kWalkU <= e && n <= list_cap - kWalkU; s += kWalkU) {
            float r2[kWalkU];
            unsigned in = 0u;
            bool wrapped = false;
#pragma unroll
            for (int u = 0; u < kWalkU; ++u) r2[u] = raw_r2(s + u);
#pragma unroll
            for (int u = 0; u < kWalkU; ++u) {
              in |= static_cast<unsigned>(r2[u] < rc2) << u;
              wrapped |= r2[u] > wrap2;
            }
            if (wrapped) {
#pragma unroll
              for (int u = 0; u < kWalkU; ++u)
                if (r2[u] > wrap2)
                  in = (in & ~(1u << u)) |
                       (static_cast<unsigned>(image_in(s + u)) << u);
            }
#pragma unroll
            for (int u = 0; u < kWalkU; ++u)
              if ((in >> u) & 1u)
                my[(n++) * nthreads] = static_cast<uint16_t>(s + u);
          }
          auto in_range = [&](int j) {
            const float r2 = raw_r2(j);
            return r2 < rc2 || (r2 > wrap2 && image_in(j));
          };
          for (; s < e && n < list_cap; ++s)
            if (in_range(s)) my[(n++) * nthreads] = static_cast<uint16_t>(s);
        } else {
          const float shy = kWrap == kImageAll ? 0.0f : lsh[2 * line];
          const float shz = kWrap == kImageAll ? 0.0f : lsh[2 * line + 1];
          auto in_range = [&](int j) {
            const float4 q = pos[j];
            float drx = pi.x - q.x, dry = pi.y - q.y, drz = pi.z - q.z;
            if (kWrap == kImageAll) {
              drx -= rintf(drx * inv_lx) * lx;
              dry -= rintf(dry * inv_ly) * ly;
              drz -= rintf(drz * inv_lz) * lz;
            } else {
              drx -= q.w;
              dry -= shy;
              drz -= shz;
            }
            const float r2 = drx * drx + dry * dry + drz * drz;
            return r2 < rc2 && r2 > 0.0f;
          };
          for (; s + kWalkU <= e && n <= list_cap - kWalkU; s += kWalkU) {
            bool in[kWalkU];
#pragma unroll
            for (int u = 0; u < kWalkU; ++u) in[u] = in_range(s + u);
#pragma unroll
            for (int u = 0; u < kWalkU; ++u)
              if (in[u]) my[(n++) * nthreads] = static_cast<uint16_t>(s + u);
          }
          for (; s < e && n < list_cap; ++s)
            if (in_range(s)) my[(n++) * nthreads] = static_cast<uint16_t>(s);
        }
        if (n == list_cap) break;  // s is the next candidate
        if (line + 1 < kLines) s = off[(line + 1) * (ncols + 1) + tc - xr];
      }
      // evaluate the list; each entry's loads (staged index, record and
      // the visitor's gathers) are issued one entry ahead of its
      // arithmetic
      struct Entry {
        int s, j;
        float4 q;
        typename Vis::Gathered g;
      };
      auto fetch = [&](int i) {
        Entry en;
        en.s = my[i * nthreads];
        en.q = pos[en.s];
        en.j = src.source(en.s, en.q, rows);
        en.g = vis.fetch(en.j);
        return en;
      };
      int el = 0;
      Entry next;
      if (n > 0) next = fetch(0);
      for (int i = 0; i < n; ++i) {
        const Entry cur = next;
        if (i + 1 < n) next = fetch(i + 1);
        const float4 q = cur.q;
        float drx, dry, drz;
        if (kWrap == kShift) {
          // the staged index's line, entries being in walk order
          while (cur.s >= (el + 1) * line_cap) ++el;
          drx = pi.x - q.x;
          dry = pi.y - q.y;
          drz = pi.z - q.z;
          drx -= q.w;
          dry -= lsh[2 * el];
          drz -= lsh[2 * el + 1];
        } else {
          min_image(pi, q, drx, dry, drz);
        }
        vis.pair(cur.g, cur.j, drx, dry, drz);
      }
      if (line == kLines) break;
    }
    vis.end(row_i);
  }
}

}  // namespace tiles
}  // namespace meso
