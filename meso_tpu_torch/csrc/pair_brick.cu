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
// smaller than the 2 xr + 1 columns of the window. Pad coordinates may be
// raw or pre-shifted by a box length: the minimum image on every axis gives
// the same dr either way, as in all three TPU kernels
// (pair_dpd_fused.py:163-171, pair_dpd.py:158-166,
// pair_multiphysics.py:119-125).
//
// Design: cell tiles, as K1's pair_dpd_v3_kernel (csrc/pair_dpd_v3.cu).
// A block owns one target (cy, cz) and a run of W consecutive cx
// (kernels/cell_tiles.py::brick_plan sizes W, the threads and the dynamic
// shared memory; brick_table gives each block its run and the brick index
// of its 9 lines). It stages the 3 x 3 (dy, dz) lines x (W + 2 xr) brick
// columns x K slots in shared memory, each slot-cell compacted to its valid
// rows; then one thread a valid target walks only the occupied slots of its
// stencil, culls the sources inside the walk's radius into a list of
// list_cap entries and evaluates the list when it is full and at the end,
// so any density is exact. The walk tests the raw difference, which is the
// minimum image unless an axis wraps, and a wrap makes r^2 exceed a quarter
// of the box's smallest length squared: only those candidates (pads that
// hold raw periodic copies) take the minimum image. For the in-range
// entries only it gathers v, the hash, the type, T or C and, where read,
// the tag from the brick's planes; the target's exclusion tags sit in
// registers (kExclRegs of them, the rest read from the brick). Each row
// sums its pairs in the order (dy, dz, dx, slot) and is written once: no
// atomics, no Newton folding.
// The walk tests the table's largest rc^2 with a 1e-4 margin; the visitor
// recomputes r^2 without fused multiply-adds (the plain version's order)
// under the minimum image and tests the pair's own rc_ij (and rcc for the
// tDPD flux, which the wrapper holds to rcc <= every rc_ij, R9), so kernel
// and plain version take the same pairs. The eDPD heat is q(i <- j),
// computed by row i, with the antisymmetric noises signed by tag order, as
// K2 (pair_transport_v3.cu). tDPD species ride in blocks of kSpeciesBlock
// registers (one register for one species): grid.y walks the species
// blocks, each block staging its tile again, and only species block 0
// writes f and the virial. Staging once and looping over the species
// blocks inside the block was the other way; it would need each thread's
// flux sums for every species across list flushes (registers or shared
// memory growing with S), where the paths run one species and a second
// block's staging runs on other SMs in parallel.
//
// What bounds it: at the 1M-particle spill shape (ncell 50^3, K = 16,
// 2,000,000 rows) the thread-a-row walk this kernel replaces made 720 slot
// tests a row (756 strict, K = 28), each an int32 valid load and three
// scalar plane loads through L1/L2, and a warp ran the visitor whenever
// one lane was in range; it ran 72-119x above its byte floor. The bytes
// (the brick once, the outputs once; ~100-200 MB) take 30-60 us at 3.35
// TB/s and the in-range pairs' arithmetic about as long: neither. The tile
// walk makes 371 tests a valid row on spill rows (223 strict), each a
// float4 from shared memory, lanes on one cell reading one address; the
// walk takes most of the time, staging (latency bound, as K1's) most of
// the rest. Taking the minimum image on every candidate made the classic
// spill case 1.2 ms alone on an H100; the raw-difference walk 0.92 ms
// (PERF.md).
// ptxas (CUDA 12.9, -O1 and up) miscompiled K1's first tile walk, which
// carried per-line state across one loop over the nine lines (PERF.md):
// here, as in K1, a line's bounds are read inside that line's pass.

#include "dpd_common.cuh"

namespace {

using namespace meso;

constexpr int kSpeciesBlock = 8;
constexpr int kDpd = 0, kEdpd = 1, kTdpd = 2;
constexpr int kLines = 9;
constexpr int kTargetLine = 4;              // (dy, dz) = (0, 0)
constexpr int kHead = 4;                    // cy, cz, cx0, width
constexpr int kTableWidth = kHead + kLines;  // then the lines' brick index
constexpr int kTileMaxThreads = 256;
constexpr int kStageU = 4;   // staged items a thread loads at once
constexpr int kWalkU = 4;    // candidates a thread tests at once
constexpr int kExclRegs = 4;  // the target's exclusion tags in registers

// The block's dynamic shared memory, in bytes from its start; the wrapper
// computes the same (kernels/cell_tiles.py::brick_smem_bytes) and a launch
// whose size differs is refused. ncols is a full-width block's.
struct TileLayout {
  int pos, off, mask, hdr, list, total;
};

__host__ __device__ inline TileLayout tile_layout(int ncols, int k,
                                                  int threads,
                                                  int list_cap) {
  const int s = kLines * ncols * k;
  const int words = (k + 31) / 32;
  TileLayout l;
  int b = 0;
  l.pos = b;
  b += 16 * s;
  l.off = b;
  b += 4 * kLines * (ncols + 1);
  l.mask = b;
  b += 4 * kLines * ncols * words;
  l.hdr = b;
  b += 4 * kTableWidth;
  l.list = b;
  b += 2 * list_cap * threads;
  l.total = (b + 15) / 16 * 16;
  return l;
}

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
  const int32_t* table;  // (n_blocks, kTableWidth)
  int nx, ny, nz, k, xr, width, list_cap;
  float dt_inv_sqrt, s_exp, mass, cv, rcc, s1;
  uint32_t step, seed;
  int rounds;
};

// kTypes: per-type-pair tables (else the row keeps one type's coefficients
// in registers); kSb: tDPD species per register block (grid.y walks the
// blocks). Phases, with a barrier between each:
//  A. one warp a line, lanes over its source columns: each column's slot
//     mask from its K valid words, its count by popc, and by a warp scan
//     its first staged index (line l staged from l * line_cap on, in
//     (column, slot) order);
//  B. items (line, slot, column), column fastest (neighbouring brick
//     indices, so the loads coalesce), kStageU a thread with their loads in
//     flight together: each valid source's x, y, z and its brick index as
//     a float4; the target line's empty slots get their outputs zeroed;
//  C. one thread a valid target (the target line's slots in the run, in
//     staged order): it walks its stencil's occupied slots only, each
//     line's 2 xr + 1 slot-cells being one contiguous range, kWalkU
//     candidates at a time, and appends the staged index of each source
//     inside the walk's radius to its list; when the list is full, and
//     after the walk, it evaluates the list, each entry's gathers issued
//     one entry ahead of its arithmetic.
template <int kModel, bool kTea, bool kTypes, int kSb>
__global__ void __launch_bounds__(kTileMaxThreads)
pair_brick_kernel(const BrickArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = p.k, xr = p.xr;
  const int px = p.nx + 2 * xr;
  const int ncols_max = p.width + 2 * xr;
  const TileLayout lay = tile_layout(ncols_max, k, blockDim.x, p.list_cap);
  float4* pos = reinterpret_cast<float4*>(smem + lay.pos);
  int* off = reinterpret_cast<int*>(smem + lay.off);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + lay.mask);
  int* hdr = reinterpret_cast<int*>(smem + lay.hdr);
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + lay.list);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int32_t* trow = p.table + static_cast<size_t>(blockIdx.x) *
                                      kTableWidth;
  for (int i = tid; i < kTableWidth; i += nthreads) hdr[i] = trow[i];
  __syncthreads();

  const int cy = hdr[0], cz = hdr[1], cx0 = hdr[2], width = hdr[3];
  const int ncols = width + 2 * xr;
  const int words = (k + 31) >> 5;
  const int s0 = static_cast<int>(blockIdx.y) * kSb;
  // in-plane offsets are 32-bit (the launcher refuses a plane of 2^31 or
  // more elements); channel offsets are not
  const size_t chan = static_cast<size_t>(p.ny + 2) * (p.nz + 2) * k * px;
  const float* __restrict__ fb = p.fb;
  const int32_t* __restrict__ ib = p.ib;

  // A: masks, counts and each column's first staged index
  const int32_t* __restrict__ validb = ib + chan;
  const int line_cap = ncols_max * k;
  for (int line = warp; line < kLines; line += nwarps) {
    int cnt = 0;
    if (lane < ncols) {
      const int sc = line * ncols + lane;
      const int32_t* vb = validb + hdr[kHead + line] + lane;
      for (int w = 0; w < words; ++w) {
        const int m = min(32, k - 32 * w);
        uint32_t bits = 0u;
#pragma unroll 8
        for (int j = 0; j < m; ++j)
          bits |= static_cast<uint32_t>(vb[(32 * w + j) * px] != 0) << j;
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
  float* __restrict__ f = p.f;
  float* __restrict__ vir = p.vir;
  float* __restrict__ extra = p.extra;
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
      const int w = slot >> 5, bit = slot & 31;
      const uint32_t bits = mask[sc * words + w];
      target[u] = line == kTargetLine && c >= xr && c < xr + width;
      row[u] = ((cy * p.nz + cz) * k + slot) * p.nx + cx0 + c - xr;
      ok[u] = (bits >> bit) & 1u;
      if (!ok[u]) continue;
      int idx = off[line * (ncols + 1) + c] +
                __popc(bits & ((1u << bit) - 1u));
      for (int w2 = 0; w2 < w; ++w2) idx += __popc(mask[sc * words + w2]);
      at[u] = idx;
      const int e = hdr[kHead + line] + slot * px + c;
      q[u] = make_float4(fb[e], fb[chan + e], fb[2 * chan + e],
                         __int_as_float(e));
    }
#pragma unroll
    for (int u = 0; u < kStageU; ++u) {
      if (ok[u]) {
        pos[at[u]] = q[u];
      } else if (target[u]) {
        const int r = row[u];
        if (s0 == 0) {
          f[3 * r] = 0.0f;
          f[3 * r + 1] = 0.0f;
          f[3 * r + 2] = 0.0f;
          vir[r] = 0.0f;
          if (kModel == kEdpd) extra[r] = 0.0f;
        }
        if (kModel == kTdpd) {
#pragma unroll
          for (int s = 0; s < kSb; ++s)
            if (s0 + s < p.ns)
              extra[static_cast<size_t>(r) * p.ns + s0 + s] = 0.0f;
        }
      }
    }
  }
  __syncthreads();

  // C: walk, cull, evaluate
  const int n_t = off[tcell0 + width] - tbase;
  const float lx = p.box_hi[0] - p.box_lo[0];
  const float ly = p.box_hi[1] - p.box_lo[1];
  const float lz = p.box_hi[2] - p.box_lo[2];
  const float inv_lx = 1.0f / lx, inv_ly = 1.0f / ly, inv_lz = 1.0f / lz;
  float rc2_max = 0.0f;
  for (int q2 = 0; q2 < p.n_types * p.n_types; ++q2)
    rc2_max = fmaxf(rc2_max, p.rc_tab[q2] * p.rc_tab[q2]);
  const float rc2_walk = rc2_max * 1.0001f;
  // an axis whose difference the minimum image wraps has |dr| > 0.49 L
  const float l_min = fminf(lx, fminf(ly, lz));
  const float wrap2 = 0.24f * l_min * l_min;
  const float a0 = p.a_tab[0], gamma0 = p.gamma_tab[0];
  const float x30 = p.x3_tab[0], rc0 = p.rc_tab[0];
  const float w_excl = p.n_excl > 0 ? p.excl_w[0] : 1.0f;
  const float rcc2 = p.rcc * p.rcc;
  const float* vxb = fb + 3 * chan;
  const float* vyb = fb + 4 * chan;
  const float* vzb = fb + 5 * chan;
  const float* mb = fb + 6 * chan;  // T or C_0
  const int32_t* tagb = ib;
  const int32_t* hb = ib + (kTea ? 0 : p.ch_h * chan);
  const int32_t* typb = ib + (kTypes ? p.ch_typ * chan : 0);
  uint16_t* my = list + tid;
  for (int t0 = 0; t0 < n_t; t0 += nthreads) {
    const int t = t0 + tid;
    if (t >= n_t) continue;
    const int si = tbase + t;
    int tc = xr;
    while (si >= off[kTargetLine * (ncols + 1) + tc + 1]) ++tc;
    const float4 pi = pos[si];
    const int self = __float_as_int(pi.w);
    const int slot_i = (self / px) % k;
    const int row_i = ((cy * p.nz + cz) * k + slot_i) * p.nx + cx0 + tc - xr;
    const float vxi = vxb[self], vyi = vyb[self], vzi = vzb[self];
    const int32_t tag_i = tagb[self];
    const uint32_t h_i = kTea ? 0u : static_cast<uint32_t>(hb[self]);
    const int t_row = kTypes ? typb[self] * p.n_types : 0;
    const float ti = kModel == kEdpd ? mb[self] : 0.0f;
    const float inv_ti = 1.0f / fmaxf(ti, 1e-12f);
    int32_t ex[kExclRegs];
#pragma unroll
    for (int e = 0; e < kExclRegs; ++e)
      ex[e] = kModel == kDpd && e < p.n_excl
                  ? ib[(p.ch_ex + e) * chan + self] : 0;
    float fx = 0.0f, fy = 0.0f, fz = 0.0f, vsum = 0.0f, qsum = 0.0f;
    float qs[kSb];
#pragma unroll
    for (int s = 0; s < kSb; ++s) qs[s] = 0.0f;

    auto min_image = [&](const float4& q, float& drx, float& dry,
                         float& drz) {
      drx = pi.x - q.x;
      dry = pi.y - q.y;
      drz = pi.z - q.z;
      drx -= rintf(drx * inv_lx) * lx;
      dry -= rintf(dry * inv_ly) * ly;
      drz -= rintf(drz * inv_lz) * lz;
    };
    int line = 0, s = off[tc - xr];  // line 0
    while (true) {
      // walk from (line, s) until the list is full or the stencil ends
      int n = 0;
      for (; line < kLines; ++line) {
        const int e = off[line * (ncols + 1) + tc + xr + 1];
        // the raw difference is the minimum image unless an axis wraps,
        // and a wrap makes r^2 exceed wrap2: only then is the minimum
        // image taken. The target itself (r^2 = 0) enters the list and the
        // visitor's r^2 > 0 drops it.
        auto raw_r2 = [&](int j) {
          const float4 q = pos[j];
          const float drx = pi.x - q.x, dry = pi.y - q.y, drz = pi.z - q.z;
          return drx * drx + dry * dry + drz * drz;
        };
        auto image_in = [&](int j) {
          float drx, dry, drz;
          min_image(pos[j], drx, dry, drz);
          return drx * drx + dry * dry + drz * drz < rc2_walk;
        };
        for (; s + kWalkU <= e && n <= p.list_cap - kWalkU; s += kWalkU) {
          float r2[kWalkU];
          bool in[kWalkU], wrapped = false;
#pragma unroll
          for (int u = 0; u < kWalkU; ++u) r2[u] = raw_r2(s + u);
#pragma unroll
          for (int u = 0; u < kWalkU; ++u) {
            in[u] = r2[u] < rc2_walk;
            wrapped |= r2[u] > wrap2;
          }
          if (wrapped) {
#pragma unroll
            for (int u = 0; u < kWalkU; ++u)
              if (r2[u] > wrap2) in[u] = image_in(s + u);
          }
#pragma unroll
          for (int u = 0; u < kWalkU; ++u)
            if (in[u]) my[(n++) * nthreads] = static_cast<uint16_t>(s + u);
        }
        auto in_range = [&](int j) {
          const float r2 = raw_r2(j);
          return r2 < rc2_walk || (r2 > wrap2 && image_in(j));
        };
        for (; s < e && n < p.list_cap; ++s)
          if (in_range(s)) my[(n++) * nthreads] = static_cast<uint16_t>(s);
        if (n == p.list_cap) break;  // s is the next candidate
        if (line + 1 < kLines) s = off[(line + 1) * (ncols + 1) + tc - xr];
      }
      // evaluate the list; each entry's gathers are issued one entry
      // ahead of its arithmetic
      struct Source {
        float4 q;
        float vx, vy, vz, fj;
        int32_t tag;
        uint32_t h;
        int typ;
      };
      auto fetch = [&](int i) {
        Source src;
        src.q = pos[my[i * nthreads]];
        const int j = __float_as_int(src.q.w);
        src.vx = vxb[j];
        src.vy = vyb[j];
        src.vz = vzb[j];
        // the tag signs the transport noises and finds exclusions; the
        // TEA tier hashes it; classic DPD on the fast tier reads none
        src.tag = kTea || kModel != kDpd || p.n_excl > 0 ? tagb[j] : 0;
        src.h = kTea ? 0u : static_cast<uint32_t>(hb[j]);
        src.typ = kTypes ? typb[j] : 0;
        src.fj = kModel == kEdpd ? mb[j] : 0.0f;
        return src;
      };
      Source next;
      if (n > 0) next = fetch(0);
      for (int i = 0; i < n; ++i) {
        const Source cur = next;
        if (i + 1 < n) next = fetch(i + 1);
        float drx, dry, drz;
        min_image(cur.q, drx, dry, drz);
        const float r2 = __fadd_rn(
            __fadd_rn(__fmul_rn(drx, drx), __fmul_rn(dry, dry)),
            __fmul_rn(drz, drz));
        float a = a0, gamma = gamma0, x3 = x30, rc = rc0;
        if (kTypes) {
          const int pr = t_row + cur.typ;
          a = p.a_tab[pr];
          gamma = p.gamma_tab[pr];
          x3 = p.x3_tab[pr];
          rc = p.rc_tab[pr];
        }
        if (!(r2 < rc * rc) || !(r2 > 0.0f)) continue;
        const float rinv = rsqrtf(r2);
        const float rr = r2 * rinv;
        const float w = 1.0f - rr * (1.0f / rc);
        const float ev = (drx * (vxi - cur.vx) + dry * (vyi - cur.vy) +
                          drz * (vzi - cur.vz)) * rinv;
        const int32_t tag_j = cur.tag;
        const uint32_t hp = pair_hash<kTea>(tag_i, tag_j, h_i, cur.h,
                                            p.step, p.seed, p.rounds);
        float fmag;
        if (kModel == kDpd) {
          const float theta = u32_to_symmetric_uniform(hp);
          const float sg = x3 * p.dt_inv_sqrt;
          if (p.s_exp == 1.0f) {
            fmag = w * (a - (gamma * w) * ev + sg * theta);
          } else {
            const float wr = powf(fmaxf(w, 0.0f), p.s_exp);
            fmag = a * w - gamma * (wr * wr) * ev + sg * wr * theta;
          }
          if (p.n_excl > 0) {
            bool hit = false;
#pragma unroll
            for (int e = 0; e < kExclRegs; ++e)
              hit |= e < p.n_excl && ex[e] == tag_j;
            for (int e = kExclRegs; e < p.n_excl; ++e)
              hit |= ib[(p.ch_ex + e) * chan + self] == tag_j;
            if (hit) fmag *= w_excl;
          }
        } else if (kModel == kEdpd) {
          const float theta = uniform_stream(hp, 0u);
          const float w2 = w * w;
          const float tj = cur.fj;
          const float tsum = ti + tj;
          const float sigma2 = 4.0f * gamma * ti * tj / fmaxf(tsum, 1e-12f);
          const float sigma = sqrtf(fmaxf(sigma2, 0.0f));
          const float noise = sigma * w * theta * p.dt_inv_sqrt;
          fmag = a * w - gamma * w2 * ev + noise;
          const float k_ij = x3 * 0.25f * (tsum * tsum);
          const float q_c = k_ij * w2 * (inv_ti - 1.0f / fmaxf(tj, 1e-12f));
          const float q_v = 0.5f * (w2 * (gamma * ev * ev - sigma2 / p.mass) -
                                    noise * ev);
          const float zeta =
              (tag_i < tag_j ? 1.0f : -1.0f) * uniform_stream(hp, 1u);
          const float q_r =
              sqrtf(fmaxf(2.0f * k_ij, 0.0f)) * w * zeta * p.dt_inv_sqrt;
          qsum += q_c + q_v + q_r;
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
            const int j = __float_as_int(cur.q.w);
            // kappa, eps and the target's C are read here, not held in
            // registers across the walk: with 8 species a block they
            // would be 24 more live registers
#pragma unroll
            for (int sp = 0; sp < kSb; ++sp) {
              if (s0 + sp < p.ns) {
                const float* c_s = mb + (s0 + sp) * chan;
                const float xi_s = sign * uniform_stream(
                    hp, 2u + static_cast<uint32_t>(s0 + sp));
                qs[sp] += -p.kappa_c[s0 + sp] * wdc * (c_s[self] - c_s[j]) +
                          p.eps_c[s0 + sp] * wrc * xi_s * p.dt_inv_sqrt;
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
      if (line == kLines) break;
    }
    if (s0 == 0) {
      f[3 * row_i] = fx;
      f[3 * row_i + 1] = fy;
      f[3 * row_i + 2] = fz;
      vir[row_i] = vsum;
      if (kModel == kEdpd) extra[row_i] = qsum / p.cv;
    }
    if (kModel == kTdpd) {
#pragma unroll
      for (int sp = 0; sp < kSb; ++sp)
        if (s0 + sp < p.ns)
          extra[static_cast<size_t>(row_i) * p.ns + s0 + sp] = qs[sp];
    }
  }
}

template <int kModel, bool kTea, bool kTypes, int kSb>
cudaError_t launch_tiles(const BrickArgs& args, dim3 grid, int threads,
                         int smem, cudaStream_t stream) {
  auto kernel = pair_brick_kernel<kModel, kTea, kTypes, kSb>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int kModel, int kSb>
cudaError_t launch_brick(const BrickArgs& args, dim3 grid, int threads,
                         int smem, cudaStream_t stream, bool tea,
                         bool types) {
  if (tea && types)
    return launch_tiles<kModel, true, true, kSb>(args, grid, threads, smem,
                                                 stream);
  if (tea)
    return launch_tiles<kModel, true, false, kSb>(args, grid, threads, smem,
                                                  stream);
  if (types)
    return launch_tiles<kModel, false, true, kSb>(args, grid, threads, smem,
                                                  stream);
  return launch_tiles<kModel, false, false, kSb>(args, grid, threads, smem,
                                                 stream);
}

}  // namespace

// The brick kernel on the cell tiles of kernels/cell_tiles.py::brick_plan:
// ``table`` is the plan's brick_table on the card, (n_blocks, kTableWidth)
// int32; width, threads, list_cap and smem_bytes are the plan's.
// Refused (cudaErrorInvalidValue, nothing launched): a block of more than
// kTileMaxThreads threads or not whole warps, more than 32 source columns,
// more staged slots than the lists' uint16 index reaches, a smem_bytes
// that differs from tile_layout's, a plane of 2^31 elements or more, or
// a channel the model or RNG tier reads that is missing.
extern "C" int meso_pair_brick(
    int model, int tea, const void* fb, const void* ib, const void* box_lo,
    const void* box_hi, const void* a_tab, const void* gamma_tab,
    const void* x3_tab, const void* rc_tab, int n_types, int ch_h, int ch_typ,
    int ch_ex, int n_excl, const void* excl_w, int ns, const void* kappa_c,
    const void* eps_c, void* f, void* extra, void* vir, int nx, int ny,
    int nz, int k, int xr, const void* table, int width, int n_blocks,
    int threads, int list_cap, int smem_bytes, float dt_inv_sqrt,
    float s_exp, float mass, float cv, float rcc, float s1, uint32_t step,
    uint32_t seed, int rounds, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  const long long plane = static_cast<long long>(ny + 2) * (nz + 2) * k *
                         (nx + 2 * xr);
  const int ncols = width + 2 * xr;
  if (model < kDpd || model > kTdpd || (model == kTdpd && ns < 1) ||
      (n_types > 1 && ch_typ < 0) || (!tea && ch_h < 0) ||
      (n_excl > 0 && ch_ex < 0) || plane >= (1LL << 31) || threads <= 0 ||
      threads > kTileMaxThreads || threads % 32 != 0 || ncols > 32 ||
      kLines * ncols * k > (1 << 16) || list_cap <= 0 ||
      tile_layout(ncols, k, threads, list_cap).total != smem_bytes) {
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
  args.table = static_cast<const int32_t*>(table);
  args.nx = nx;
  args.ny = ny;
  args.nz = nz;
  args.k = k;
  args.xr = xr;
  args.width = width;
  args.list_cap = list_cap;
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
  const dim3 grid(n_blocks, model == kTdpd ? (ns + sb - 1) / sb : 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool types = n_types > 1;
  cudaError_t e;
  if (model == kDpd) {
    e = launch_brick<kDpd, 1>(args, grid, threads, smem_bytes, st, tea,
                              types);
  } else if (model == kEdpd) {
    e = launch_brick<kEdpd, 1>(args, grid, threads, smem_bytes, st, tea,
                               types);
  } else if (sb == 1) {
    e = launch_brick<kTdpd, 1>(args, grid, threads, smem_bytes, st, tea,
                               types);
  } else {
    e = launch_brick<kTdpd, kSpeciesBlock>(args, grid, threads, smem_bytes,
                                           st, tea, types);
  }
  return static_cast<int>(e);
}
