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
// pair_dpd_v3_kernel (the main path's) works on cell tiles: a block owns
// one (cy, cz) and a run of W consecutive cx (kernels/cell_tiles.py plans
// W and builds, on the host, the table of each block's lines, source
// columns and wrap shifts). It stages the sources of its 3 x 3 (dy, dz)
// lines x (W + 2 xr) columns (xr = 2 for spill layouts, 1 for strict ones)
// in shared memory, each slot-cell compacted to its valid rows, then one
// thread a valid target walks only the occupied slots of its stencil,
// culls the sources inside rc into a per-thread list and evaluates the
// list. Each row sums its pairs in registers in the order of the stencil
// walk (dy, dz, dx, slot) and is written once; every pair is computed by
// both of its rows (a full traversal): no atomics, and a deterministic
// per-row sum. Newton folding is left to a later change.
// pair_dpd_v3_general_kernel keeps the walk of for_each_pair
// (dpd_common.cuh): one thread a row over all K slots of each slot-cell.
//
// RNG: the fast tier reads h[j] = TEA-8(tag, tag ^ 0xDEADBEEF, step, seed)
// from particle_hash_kernel (one launch per step) and mixes it with
// combine_symmetric (meso_tpu/core/rng.py:103-117); the TEA tier runs
// TEA-rounds on (min tag, max tag, step, seed) per pair. Both feed the top
// 23 bits into a zero-mean unit-variance uniform (rng.py:67-75).
//
// What bounds it: at the 1M-particle main path (ncell 50^3, K = 16,
// nr = 2,000,000, spill) the one-thread-a-row walk of for_each_pair made
// 720 slot tests a row, half of them on empty slots, each a byte load of
// valid and, for a valid slot, three scalar loads of x through L1/L2; and
// a warp ran the in-range visitor whenever one of its 32 lanes had an
// in-range candidate (3.4% of a row's candidates are in range). The tile
// kernel makes 371 tests a valid row, each a float4 load from shared
// memory (lanes on one cell read one address), four at a time, and runs
// the visitor as often as the warp's longest list. Its DRAM bytes (x, v,
// h and valid read once, f written once) are ~3% of its time; on an H100
// it takes ~0.19 of its ~0.73 ms staging (5,000 blocks of W = 25, latency
// bound: the table, then the valid bytes, then x, each waits on the last)
// and the rest walking, issue bound at ~2 blocks an SM (PERF.md, PR 7).

#include "dpd_common.cuh"

namespace {

using namespace meso;

// The per-particle hash h = TEA-rounds(tag, tag ^ 0xDEADBEEF, step, seed)
// of every row, invalid ones included. One TEA chain is a serial run of
// integer instructions: compiled for sm_90a, a half-round is LEA, VIADD,
// LEA.HI, LOP3 and IMAD.IADD, so a row's 8 rounds take ~78 instructions,
// 46 of them on the ALU pipe (64 lanes an SM). At the main path's
// 2,000,000 rows that pipe needs ~0.0055 ms on an H100 against 0.0048 ms
// for its 16 MB: operations bound it (chip_smoke.py counts the
// instructions from the built library). So a thread takes kHashRows rows
// at once (one 16-byte load and store where both pointers allow it,
// scalars for the tail of n % kHashRows), runs their chains interleaved
// round by round (independent instructions for the scheduler), and the
// grid is sized to fill every SM, looping over the rest. kRounds > 0
// fixes the rounds at compile time (8, the fast tier's, unrolled); 0
// reads ``rounds``.
constexpr int kHashRows = 4;

template <int kRounds>
__global__ void __launch_bounds__(kThreads)
particle_hash_kernel(const int32_t* __restrict__ tag,
                     uint32_t* __restrict__ h, int n, uint32_t step,
                     uint32_t seed, int rounds, int vec) {
  const int units = (n + kHashRows - 1) / kHashRows;
  const int nr = kRounds > 0 ? kRounds : rounds;
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < units;
       u += gridDim.x * blockDim.x) {
    const int i = u * kHashRows;
    const bool whole = vec && i + kHashRows <= n;
    uint32_t v0[kHashRows], v1[kHashRows];
    if (whole) {
      const int4 t = reinterpret_cast<const int4*>(tag)[u];
      v0[0] = static_cast<uint32_t>(t.x);
      v0[1] = static_cast<uint32_t>(t.y);
      v0[2] = static_cast<uint32_t>(t.z);
      v0[3] = static_cast<uint32_t>(t.w);
    } else {
#pragma unroll
      for (int c = 0; c < kHashRows; ++c)
        v0[c] = i + c < n ? static_cast<uint32_t>(tag[i + c]) : 0u;
    }
#pragma unroll
    for (int c = 0; c < kHashRows; ++c) v1[c] = v0[c] ^ 0xDEADBEEFu;
    uint32_t s = 0u;
#pragma unroll
    for (int r = 0; r < nr; ++r) {
      s += kDelta;
#pragma unroll
      for (int c = 0; c < kHashRows; ++c)
        v0[c] += ((v1[c] << 4) + step) ^ (v1[c] + s) ^ ((v1[c] >> 5) + seed);
#pragma unroll
      for (int c = 0; c < kHashRows; ++c)
        v1[c] += ((v0[c] << 4) + kK2) ^ (v0[c] + s) ^ ((v0[c] >> 5) + kK3);
    }
    if (whole) {
      reinterpret_cast<uint4*>(h)[u] = make_uint4(v0[0], v0[1], v0[2], v0[3]);
    } else {
#pragma unroll
      for (int c = 0; c < kHashRows; ++c)
        if (i + c < n) h[i + c] = v0[c];
    }
  }
}

// The block's dynamic shared memory, in bytes from its start; the wrapper
// computes the same (kernels/cell_tiles.py::smem_bytes) and a launch whose
// size differs is refused. ncols and width are a full-width block's.
struct TileLayout {
  int pos, rows, off, mask, hdr, lsh, list, total;
};

constexpr int kLines = 9;
constexpr int kTargetLine = 4;
constexpr int kHead = 4;                  // cy, cz, cx0, width
constexpr int kCol0 = kHead + 3 * kLines;  // first (sx, x code) pair
constexpr int kTileMaxThreads = 256;
constexpr int kStageU = 4;  // staged items a thread loads at once
constexpr int kWalkU = 4;   // candidates a thread tests at once

__host__ __device__ inline int tile_table_width(int ncols) {
  return kCol0 + 2 * ncols;
}

__host__ __device__ inline TileLayout tile_layout(int ncols, int k,
                                                  int threads,
                                                  int list_cap) {
  const int s = kLines * ncols * k;
  const int words = (k + 31) / 32;
  TileLayout l;
  int b = 0;
  l.pos = b;
  b += 16 * s;
  l.rows = b;
  b += 4 * s;
  l.off = b;
  b += 4 * kLines * (ncols + 1);
  l.mask = b;
  b += 4 * kLines * ncols * words;
  l.hdr = b;
  b += 4 * tile_table_width(ncols);
  l.lsh = b;
  b += 4 * 2 * kLines;
  l.list = b;
  b += 2 * list_cap * threads;
  l.total = (b + 15) / 16 * 16;
  return l;
}

struct K1Args {
  const float* x;
  const float* v;
  const uint32_t* h;  // the per-particle hash (fast tier) or the tags (TEA)
  const uint8_t* valid;
  const float* a_tab;
  const float* gamma_tab;
  const float* sigma_tab;
  const float* rc_tab;
  const float* box_lo;
  const float* box_hi;
  const int32_t* table;  // (n_blocks, tile_table_width(ncols)) int32
  float* f;
  float* vir;
  int nx, k, xr, width, list_cap;
  float dt_inv_sqrt;
  uint32_t step, seed;
  int rounds;
};

// K1 on cell tiles. Block b owns the target cells of its table row: one
// (cy, cz) and the run cx0 .. cx0 + width - 1. Phases, with a barrier
// between each:
//  A. one warp a line, lanes over its source columns: each column's slot
//     mask from its K valid bytes, its count by popc, and by a warp scan
//     its first staged index (line l staged from l * line_cap on, in
//     (column, slot) order);
//  B. items (line, slot, column), column fastest (neighbouring rows, so
//     the loads coalesce), kStageU a thread with their loads in flight
//     together: each valid source's x, y, z and the x wrap shift of its
//     column as a float4, and its row; the target line's empty slots get
//     f = 0 here;
//  C. one thread a valid target (the target line's slots in the run, in
//     staged order: lanes of a warp share cells, and read the same sources
//     as a broadcast): it walks its stencil's occupied slots only, each
//     line's 2 xr + 1 slot-cells being one contiguous range, kWalkU
//     candidates at a time, and appends the staged index of each source
//     inside rc to its list; when the list is full, and after the walk, it
//     evaluates the list, each entry's loads issued one entry ahead. The
//     visitor thus runs for as many entries as the warp's longest list,
//     not for every candidate step on which one lane is in range.
// dr = (xi - xj) - shift, the shift being the wrap of the source's line
// (y, z) and column (x), as in for_each_pair: the two rows of a pair get
// exactly opposite dr. Each line's y and z shifts are read in that line's
// own loop. Carried across one loop over all nine lines, they came out
// wrong on the card without min-image: ptxas (CUDA 12.9, -O1 and up) set
// the line register to its exit value before the exit branch and formed
// the next line's shift address from it (PERF.md, PR 7).
template <bool kMinImage, bool kTea, bool kVirial>
__global__ void __launch_bounds__(kTileMaxThreads)
pair_dpd_v3_kernel(const K1Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = p.k, nx = p.nx, xr = p.xr;
  const int ncols_max = p.width + 2 * xr;
  const TileLayout lay = tile_layout(ncols_max, k, blockDim.x, p.list_cap);
  float4* pos = reinterpret_cast<float4*>(smem + lay.pos);
  int* rows = reinterpret_cast<int*>(smem + lay.rows);
  int* off = reinterpret_cast<int*>(smem + lay.off);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + lay.mask);
  int* hdr = reinterpret_cast<int*>(smem + lay.hdr);
  float* lsh = reinterpret_cast<float*>(smem + lay.lsh);
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + lay.list);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int tw = tile_table_width(ncols_max);
  const int32_t* trow = p.table + static_cast<size_t>(blockIdx.x) * tw;
  for (int i = tid; i < tw; i += nthreads) hdr[i] = trow[i];
  __syncthreads();

  const int width = hdr[3];
  const int ncols = width + 2 * xr;
  const int words = (k + 31) >> 5;
  const float lx = p.box_hi[0] - p.box_lo[0];
  const float ly = p.box_hi[1] - p.box_lo[1];
  const float lz = p.box_hi[2] - p.box_lo[2];
  if (tid < kLines) {
    lsh[2 * tid] = static_cast<float>(hdr[kHead + 3 * tid + 1]) * ly;
    lsh[2 * tid + 1] = static_cast<float>(hdr[kHead + 3 * tid + 2]) * lz;
  }

  // A: masks, counts and each column's first staged index
  const uint8_t* __restrict__ valid = p.valid;
  const int line_cap = ncols_max * k;
  for (int line = warp; line < kLines; line += nwarps) {
    int cnt = 0;
    if (lane < ncols) {
      const int sc = line * ncols + lane;
      const uint8_t* vb =
          valid + hdr[kHead + 3 * line] + hdr[kCol0 + 2 * lane];
      for (int w = 0; w < words; ++w) {
        const int m = min(32, k - 32 * w);
        uint32_t bits = 0u;
#pragma unroll 8
        for (int j = 0; j < m; ++j)
          bits |= static_cast<uint32_t>(vb[(32 * w + j) * nx] != 0) << j;
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
  const float* __restrict__ x = p.x;
  const float* __restrict__ v = p.v;
  const uint32_t* __restrict__ h = p.h;
  float* __restrict__ f = p.f;
  float* __restrict__ vir = p.vir;
  const int n_items = kLines * k * ncols;
  for (int i0 = tid; i0 < n_items; i0 += kStageU * nthreads) {
    float4 px[kStageU];
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
      row[u] = hdr[kHead + 3 * line] + slot * nx + hdr[kCol0 + 2 * c];
      const int col_off = off[line * (ncols + 1) + c];
      const int w = slot >> 5, bit = slot & 31;
      const uint32_t bits = mask[sc * words + w];
      target[u] = line == kTargetLine && c >= xr && c < xr + width;
      ok[u] = (bits >> bit) & 1u;
      if (!ok[u]) continue;
      int idx = col_off + __popc(bits & ((1u << bit) - 1u));
      for (int w2 = 0; w2 < w; ++w2) idx += __popc(mask[sc * words + w2]);
      at[u] = idx;
      const int r = row[u];
      px[u] = make_float4(x[3 * r], x[3 * r + 1], x[3 * r + 2],
                          kMinImage ? 0.0f
                                    : static_cast<float>(
                                          hdr[kCol0 + 2 * c + 1]) * lx);
    }
#pragma unroll
    for (int u = 0; u < kStageU; ++u) {
      if (ok[u]) {
        pos[at[u]] = px[u];
        rows[at[u]] = row[u];
      } else if (target[u]) {
        f[3 * row[u]] = 0.0f;
        f[3 * row[u] + 1] = 0.0f;
        f[3 * row[u] + 2] = 0.0f;
        if (kVirial) vir[row[u]] = 0.0f;
      }
    }
  }
  __syncthreads();

  // C: walk, cull, evaluate
  const int n_t = off[tcell0 + width] - tbase;
  const float a = p.a_tab[0];
  const float gamma = p.gamma_tab[0];
  const float sg = p.sigma_tab[0] * p.dt_inv_sqrt;
  const float rc = p.rc_tab[0];
  const float inv_rc = 1.0f / rc;
  const float rc2 = rc * rc;
  const float inv_lx = 1.0f / lx, inv_ly = 1.0f / ly, inv_lz = 1.0f / lz;
  uint16_t* my = list + tid;
  for (int t0 = 0; t0 < n_t; t0 += nthreads) {
    const int t = t0 + tid;
    if (t >= n_t) continue;
    const int si = tbase + t;
    int tc = xr;
    while (si >= off[kTargetLine * (ncols + 1) + tc + 1]) ++tc;
    const float4 pi = pos[si];
    const int row_i = rows[si];
    const float vxi = v[3 * row_i], vyi = v[3 * row_i + 1],
                vzi = v[3 * row_i + 2];
    const uint32_t h_i = h[row_i];
    float fx = 0.0f, fy = 0.0f, fz = 0.0f, vsum = 0.0f;
    int line = 0, s = off[tc - xr];  // line 0
    while (true) {
      // walk from (line, s) until the list is full or the stencil ends
      int n = 0;
      for (; line < kLines; ++line) {
        const int e = off[line * (ncols + 1) + tc + xr + 1];
        const float shy = kMinImage ? 0.0f : lsh[2 * line];
        const float shz = kMinImage ? 0.0f : lsh[2 * line + 1];
        auto in_range = [&](int j) {
          const float4 q = pos[j];
          float drx = pi.x - q.x, dry = pi.y - q.y, drz = pi.z - q.z;
          if (kMinImage) {
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
        // kWalkU candidates a step (independent loads) while the list has
        // room for them all, then one at a time
        for (; s + kWalkU <= e && n <= p.list_cap - kWalkU; s += kWalkU) {
          bool in[kWalkU];
#pragma unroll
          for (int u = 0; u < kWalkU; ++u) in[u] = in_range(s + u);
#pragma unroll
          for (int u = 0; u < kWalkU; ++u)
            if (in[u]) my[(n++) * nthreads] = static_cast<uint16_t>(s + u);
        }
        for (; s < e && n < p.list_cap; ++s)
          if (in_range(s)) my[(n++) * nthreads] = static_cast<uint16_t>(s);
        if (n == p.list_cap) break;  // s is the next candidate
        if (line + 1 < kLines) s = off[(line + 1) * (ncols + 1) + tc - xr];
      }
      // evaluate the list; each entry's loads (staged index, position, v
      // and hash) are issued one entry ahead of its arithmetic
      struct Source {
        int s;
        float4 q;
        float vx, vy, vz;
        uint32_t h;
      };
      auto fetch = [&](int i) {
        Source src;
        src.s = my[i * nthreads];
        src.q = pos[src.s];
        const int j = rows[src.s];
        src.vx = v[3 * j];
        src.vy = v[3 * j + 1];
        src.vz = v[3 * j + 2];
        src.h = h[j];
        return src;
      };
      int el = 0;
      Source next;
      if (n > 0) next = fetch(0);
      for (int i = 0; i < n; ++i) {
        const Source cur = next;
        if (i + 1 < n) next = fetch(i + 1);
        const int sj = cur.s;
        const float4 q = cur.q;
        float drx = pi.x - q.x, dry = pi.y - q.y, drz = pi.z - q.z;
        if (kMinImage) {
          drx -= rintf(drx * inv_lx) * lx;
          dry -= rintf(dry * inv_ly) * ly;
          drz -= rintf(drz * inv_lz) * lz;
        } else {
          while (sj >= (el + 1) * line_cap) ++el;
          drx -= q.w;
          dry -= lsh[2 * el];
          drz -= lsh[2 * el + 1];
        }
        const float r2 = drx * drx + dry * dry + drz * drz;
        const float vxj = cur.vx, vyj = cur.vy, vzj = cur.vz;
        const uint32_t h_j = cur.h;
        const float rinv = rsqrtf(r2);
        const float rr = r2 * rinv;
        const float w = 1.0f - rr * inv_rc;
        const float ev = (drx * (vxi - vxj) + dry * (vyi - vyj) +
                          drz * (vzi - vzj)) * rinv;
        const uint32_t hp = pair_hash<kTea>(
            static_cast<int32_t>(h_i), static_cast<int32_t>(h_j), h_i, h_j,
            p.step, p.seed, p.rounds);
        const float theta = u32_to_symmetric_uniform(hp);
        const float fmag = w * (a - (gamma * w) * ev + sg * theta);
        const float fr = fmag * rinv;
        fx += fr * drx;
        fy += fr * dry;
        fz += fr * drz;
        if (kVirial) vsum += 0.5f * fmag * rr;
      }
      if (line == kLines) break;
    }
    f[3 * row_i] = fx;
    f[3 * row_i + 1] = fy;
    f[3 * row_i + 2] = fz;
    if (kVirial) vir[row_i] = vsum;
  }
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
cudaError_t launch_pair(const K1Args& args, int n_blocks, int threads,
                        int smem, cudaStream_t stream) {
  auto kernel = pair_dpd_v3_kernel<kMinImage, kTea, kVirial>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<n_blocks, threads, smem, stream>>>(args);
  return cudaGetLastError();
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

// The hash of n tags: at most as many blocks as fill every SM of the
// current device (2048 threads an SM), each thread kHashRows rows a pass.
extern "C" int meso_particle_hash(const void* tag, void* h, int n,
                                  uint32_t step, uint32_t seed, int rounds,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  // the SM count of each device, asked once (the main path launches the
  // hash every step)
  static int sm_count[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev < 0 || dev >= 64)) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && sm_count[dev] == 0)
    e = cudaDeviceGetAttribute(&sm_count[dev],
                               cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = sm_count[dev];
  const int units = (n + kHashRows - 1) / kHashRows;
  const int fill = sms * (2048 / kThreads);
  const int need = (units + kThreads - 1) / kThreads;
  const int blocks = need < fill ? need : fill;
  const int vec = ((reinterpret_cast<uintptr_t>(tag) |
                    reinterpret_cast<uintptr_t>(h)) % 16) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(tag);
  uint32_t* out = static_cast<uint32_t*>(h);
  if (rounds == 8) {
    particle_hash_kernel<8><<<blocks, kThreads, 0, st>>>(t, out, n, step,
                                                         seed, rounds, vec);
  } else {
    particle_hash_kernel<0><<<blocks, kThreads, 0, st>>>(t, out, n, step,
                                                         seed, rounds, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 on the cell tiles of kernels/cell_tiles.py: ``table`` is the plan's
// tile table, (n_blocks, tile_table_width(width + 2 xr)) int32 on the
// card; width, threads, list_cap and smem_bytes are the plan's.
// Refused (cudaErrorInvalidValue, nothing launched): a block of more than
// kTileMaxThreads threads or not whole warps, more than 32 source
// columns, more staged slots than the lists' uint16 index reaches, or a
// smem_bytes that differs from tile_layout's.
extern "C" int meso_pair_dpd_v3(
    const void* x, const void* v, const void* h, const void* valid,
    const void* a_tab, const void* gamma_tab, const void* sigma_tab,
    const void* rc_tab, const void* box_lo, const void* box_hi,
    const void* table, void* f, void* vir, int nx, int k, int xr, int width,
    int n_blocks, int threads, int list_cap, int smem_bytes, int min_image,
    int tea, int need_virial,
    float dt_inv_sqrt, uint32_t step, uint32_t seed, int rounds,
    void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  const int ncols = width + 2 * xr;
  if (threads <= 0 || threads > kTileMaxThreads || threads % 32 != 0 ||
      ncols > 32 || kLines * ncols * k > (1 << 16) || list_cap <= 0 ||
      tile_layout(ncols, k, threads, list_cap).total != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  K1Args args;
  args.x = static_cast<const float*>(x);
  args.v = static_cast<const float*>(v);
  args.h = static_cast<const uint32_t*>(h);
  args.valid = static_cast<const uint8_t*>(valid);
  args.a_tab = static_cast<const float*>(a_tab);
  args.gamma_tab = static_cast<const float*>(gamma_tab);
  args.sigma_tab = static_cast<const float*>(sigma_tab);
  args.rc_tab = static_cast<const float*>(rc_tab);
  args.box_lo = static_cast<const float*>(box_lo);
  args.box_hi = static_cast<const float*>(box_hi);
  args.table = static_cast<const int32_t*>(table);
  args.f = static_cast<float*>(f);
  args.vir = static_cast<float*>(vir);
  args.nx = nx;
  args.k = k;
  args.xr = xr;
  args.width = width;
  args.list_cap = list_cap;
  args.dt_inv_sqrt = dt_inv_sqrt;
  args.step = step;
  args.seed = seed;
  args.rounds = rounds;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MESO_PAIR_ARGS args, n_blocks, threads, smem_bytes, st
  const int sel = (min_image ? 4 : 0) | (tea ? 2 : 0) | (need_virial ? 1 : 0);
  cudaError_t e;
  switch (sel) {
    case 0: e = launch_pair<false, false, false>(MESO_PAIR_ARGS); break;
    case 1: e = launch_pair<false, false, true>(MESO_PAIR_ARGS); break;
    case 2: e = launch_pair<false, true, false>(MESO_PAIR_ARGS); break;
    case 3: e = launch_pair<false, true, true>(MESO_PAIR_ARGS); break;
    case 4: e = launch_pair<true, false, false>(MESO_PAIR_ARGS); break;
    case 5: e = launch_pair<true, false, true>(MESO_PAIR_ARGS); break;
    case 6: e = launch_pair<true, true, false>(MESO_PAIR_ARGS); break;
    default: e = launch_pair<true, true, true>(MESO_PAIR_ARGS); break;
  }
#undef MESO_PAIR_ARGS
  return static_cast<int>(e);
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
