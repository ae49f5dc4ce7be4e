// Classic-DPD pair forces on bucket rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel meso_tpu/kernels/pair_dpd_v3.py::_v3_kernel
// (classic model) and its in-kernel per-particle hash (hash_of,
// pair_dpd_v3.py:161-167). Two kernels cover its cases, both on the cell
// tiles of cell_tiles.cuh over bucket rows (the BucketRows source policy,
// K1's plan and table of kernels/cell_tiles.py): pair_dpd_v3_kernel the
// main path's (one particle type, s_exp = 1, no exclusions; its own
// visitor, K1Visitor), pair_dpd_v3_general_kernel every case (per-type-pair
// tables, s_exp != 1, special-bonds exclusions, debug_pairs accounting;
// the classic visitor of pair_visitor.cuh, which the brick kernel runs
// too). The general variant's min-image instances are also K6 on one card
// (kernels/pair_dpd.py::bucket_forces_pallas on strict rows): the walk and
// visitor the brick kernel ran over the padded brick, over the rows.
//
// Layout: row = ((cy * ncz + cz) * K + slot) * ncx + cx
// (meso_tpu/neighbor/bucket_layout.py:6-9). x and v are (nr, 3) float32,
// tag is (nr,) int32, valid is the (nr,) bool mask (one byte per row).
//
// A block owns one (cy, cz) and a run of W consecutive cx, stages the
// sources of its 3 x 3 (dy, dz) lines x (W + 2 xr) columns (xr = 2 for
// spill layouts, 1 for strict ones) in shared memory, each slot-cell
// compacted to its valid rows, then one thread a valid target walks only
// the occupied slots of its stencil, culls the sources inside the walk's
// radius into a per-thread list and evaluates the list (cell_tiles.cuh).
// Each row sums its pairs in registers in the order of the stencil walk
// (dy, dz, dx, slot) and is written once; every pair is computed by both
// of its rows (a full traversal): no atomics, and a deterministic per-row
// sum. Newton folding is left to a later change. Without the minimum
// image both kernels take dr = (xi - xj) - shift; with it K1 takes the
// minimum image on every candidate (PR 7's design) and the general
// variant the raw-difference walk (the minimum image only where an axis
// wraps).
//
// RNG: the fast tier reads h[j] = TEA-8(tag, tag ^ 0xDEADBEEF, step, seed)
// from particle_hash_kernel (one launch per step) and mixes it with
// combine_symmetric (meso_tpu/core/rng.py:103-117); the TEA tier runs
// TEA-rounds on (min tag, max tag, step, seed) per pair. Both feed the top
// 23 bits into a zero-mean unit-variance uniform (rng.py:67-75).
//
// What bounds it: at the 1M-particle main path (ncell 50^3, K = 16,
// nr = 2,000,000, spill) the former one-thread-a-row walk made
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
// The general variant walked as PR 6's K1 did until PR 9 (720 slot tests a
// row, 1.3-1.4x K1's time on the same rows); on the tiles it makes K1's
// 371 and gathers the type, and the tag where exclusions or TEA need it,
// beside v and h (PERF.md).

#include "cell_tiles.cuh"
#include "pair_visitor.cuh"

namespace {

using namespace meso;
using tiles::BucketRows;

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
  const int32_t* table;  // (n_blocks, BucketRows::table_width(ncols))
  float* f;
  float* vir;
  int nx, k, xr, width, list_cap;
  float dt_inv_sqrt;
  uint32_t step, seed;
  int rounds;
};

// K1's visitor: one type, s_exp = 1, no exclusions; the walk tests rc^2
// itself (no margin) and the visitor sums r^2 as the walk does.
template <bool kTea, bool kVirial>
struct K1Visitor {
  const K1Args& p;
  float a, gamma, sg, inv_rc, rc2;
  float vxi, vyi, vzi, fx, fy, fz, vsum;
  uint32_t h_i;

  struct Gathered {
    float vx, vy, vz;
    uint32_t h;
  };

  __device__ void zero(int r) const {
    p.f[3 * r] = 0.0f;
    p.f[3 * r + 1] = 0.0f;
    p.f[3 * r + 2] = 0.0f;
    if (kVirial) p.vir[r] = 0.0f;
  }
  __device__ void init() {
    a = p.a_tab[0];
    gamma = p.gamma_tab[0];
    sg = p.sigma_tab[0] * p.dt_inv_sqrt;
    const float rc = p.rc_tab[0];
    inv_rc = 1.0f / rc;
    rc2 = rc * rc;
  }
  __device__ float walk_rc2() const { return rc2; }
  __device__ void begin(int row_i, int) {
    vxi = p.v[3 * row_i];
    vyi = p.v[3 * row_i + 1];
    vzi = p.v[3 * row_i + 2];
    h_i = p.h[row_i];
    fx = fy = fz = vsum = 0.0f;
  }
  __device__ Gathered fetch(int j) const {
    Gathered g;
    g.vx = p.v[3 * j];
    g.vy = p.v[3 * j + 1];
    g.vz = p.v[3 * j + 2];
    g.h = p.h[j];
    return g;
  }
  __device__ void pair(const Gathered& g, int, float drx, float dry,
                       float drz) {
    const float r2 = drx * drx + dry * dry + drz * drz;
    const float rinv = rsqrtf(r2);
    const float rr = r2 * rinv;
    const float w = 1.0f - rr * inv_rc;
    const float ev = (drx * (vxi - g.vx) + dry * (vyi - g.vy) +
                      drz * (vzi - g.vz)) * rinv;
    const uint32_t hp = pair_hash<kTea>(
        static_cast<int32_t>(h_i), static_cast<int32_t>(g.h), h_i, g.h,
        p.step, p.seed, p.rounds);
    const float theta = u32_to_symmetric_uniform(hp);
    const float fmag = w * (a - (gamma * w) * ev + sg * theta);
    const float fr = fmag * rinv;
    fx += fr * drx;
    fy += fr * dry;
    fz += fr * drz;
    if (kVirial) vsum += 0.5f * fmag * rr;
  }
  __device__ void end(int row_i) const {
    p.f[3 * row_i] = fx;
    p.f[3 * row_i + 1] = fy;
    p.f[3 * row_i + 2] = fz;
    if (kVirial) p.vir[row_i] = vsum;
  }
};

// K1 on cell tiles (cell_tiles.cuh over bucket rows). Its min-image mode
// takes the minimum image on every candidate (PR 7's design); without it
// dr = (xi - xj) - shift.
template <bool kMinImage, bool kTea, bool kVirial>
__global__ void __launch_bounds__(tiles::kTileMaxThreads)
pair_dpd_v3_kernel(const __grid_constant__ K1Args p) {
  const BucketRows src{p.valid, p.x, p.nx};
  K1Visitor<kTea, kVirial> vis{p};
  tiles::run_tile<kMinImage ? tiles::kImageAll : tiles::kShift>(
      src, vis, p.table, p.k, p.xr, p.width, p.list_cap, p.box_lo,
      p.box_hi);
}

// The general case of _v3_kernel (pair_dpd_v3.py:197-212, 227-228,
// 245-248, 324-356) on K1's cell tiles and table, with the classic visitor
// of pair_visitor.cuh (kDpd; kDebug for debug_pairs) over per-row arrays:
// per-type-pair tables (T x T, row-major, typ_i * T + typ_j; kTypes), s_exp
// != 1, special-bonds exclusions (excl (excl_rows, n_excl) by tag, weight
// excl_w), debug_pairs (f = partners, the sum of their keys h_j >> 18, 0;
// h is the per-particle hash in both RNG tiers in this mode). The walk
// tests the table's largest rc^2 with a 1e-4 margin; the visitor sums r^2
// again without fused multiply-adds and tests the pair's own rc_ij, so the
// kernel takes exactly the plain version's pairs (the bitwise debug counts
// need it). Without the minimum image dr = (xi - xj) - shift as in K1;
// with it the walk tests the raw difference and takes the minimum image
// only where an axis wraps (the brick kernel's rule). The per-row virial is
// always written but in debug mode (the wrapper sums it where asked).
template <int kModel, bool kMinImage, bool kTea, bool kTypes>
__global__ void __launch_bounds__(tiles::kTileMaxThreads)
pair_dpd_v3_general_kernel(const __grid_constant__ RowArgs p) {
  const BucketRows src{p.valid, p.x, p.nx};
  PairVisitor<kModel, kTea, kTypes, 1, RowFields, RowArgs> vis(p,
                                                              p.fields());
  tiles::run_tile<kMinImage ? tiles::kImageRaw : tiles::kShift>(
      src, vis, p.table, p.k, p.xr, p.width, p.list_cap, p.box_lo,
      p.box_hi);
}

template <bool kMinImage, bool kTea, bool kVirial>
cudaError_t launch_pair(const K1Args& args, int n_blocks, int threads,
                        int smem, cudaStream_t stream) {
  return tiles::launch_tile(pair_dpd_v3_kernel<kMinImage, kTea, kVirial>,
                            args, dim3(n_blocks), threads, smem, stream);
}

template <int kModel, bool kMinImage, bool kTea, bool kTypes>
cudaError_t launch_general(const RowArgs& args, int n_blocks, int threads,
                           int smem, cudaStream_t stream) {
  return tiles::launch_tile(
      pair_dpd_v3_general_kernel<kModel, kMinImage, kTea, kTypes>, args,
      dim3(n_blocks), threads, smem, stream);
}

// The instance for the run-time flags (debug_pairs passes tea false: it
// reads the per-particle hash in both RNG tiers).
template <int kModel>
cudaError_t dispatch_general(const RowArgs& args, int n_blocks, int threads,
                             int smem, cudaStream_t st, bool min_image,
                             bool tea, bool types) {
#define MESO_GENERAL(mi, te, ty)                                          \
  if (min_image == mi && tea == te && types == ty)                        \
    return launch_general<kModel, mi, te, ty>(args, n_blocks, threads,   \
                                              smem, st);
  MESO_GENERAL(false, false, false)
  MESO_GENERAL(false, false, true)
  MESO_GENERAL(true, false, false)
  MESO_GENERAL(true, false, true)
  if constexpr (kModel != kDebug) {
    MESO_GENERAL(false, true, false)
    MESO_GENERAL(false, true, true)
    MESO_GENERAL(true, true, false)
    MESO_GENERAL(true, true, true)
  }
#undef MESO_GENERAL
  return cudaErrorInvalidValue;
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
// tile table, (n_blocks, BucketRows::table_width(width + 2 xr)) int32 on
// the card; width, threads, list_cap and smem_bytes are the plan's.
// Refused (cudaErrorInvalidValue, nothing launched): a block of more than
// kTileMaxThreads threads or not whole warps, more than 32 source
// columns, more staged slots than the lists' uint16 index reaches, or a
// smem_bytes that differs from the layout's (tiles::tile_launch_refused).
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
  if (tiles::tile_launch_refused<BucketRows>(width, xr, k, threads, list_cap,
                                             smem_bytes))
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

// K1's general variant on the same tiles as meso_pair_dpd_v3 (the plan and
// table of kernels/cell_tiles.py::plan); refused as it is. vir: nr rows,
// written unless debug.
extern "C" int meso_pair_dpd_v3_general(
    const void* x, const void* v, const void* tag, const void* typ,
    const void* valid, const void* h, const void* a_tab,
    const void* gamma_tab, const void* sigma_tab, const void* rc_tab,
    int n_types, const void* excl, int excl_rows, int n_excl,
    const void* excl_w, const void* box_lo, const void* box_hi,
    const void* table, void* f, void* vir, int nx, int k, int xr, int width,
    int n_blocks, int threads, int list_cap, int smem_bytes, int min_image,
    int tea, int debug, float dt_inv_sqrt, float s_exp, uint32_t step,
    uint32_t seed, int rounds, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  if (tiles::tile_launch_refused<BucketRows>(width, xr, k, threads, list_cap,
                                             smem_bytes) ||
      (!debug && vir == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  RowArgs args = {};
  args.x = static_cast<const float*>(x);
  args.v = static_cast<const float*>(v);
  args.tag = static_cast<const int32_t*>(tag);
  args.typ = static_cast<const int32_t*>(typ);
  args.valid = static_cast<const uint8_t*>(valid);
  args.h = static_cast<const uint32_t*>(h);
  args.a_tab = static_cast<const float*>(a_tab);
  args.gamma_tab = static_cast<const float*>(gamma_tab);
  args.x3_tab = static_cast<const float*>(sigma_tab);
  args.rc_tab = static_cast<const float*>(rc_tab);
  args.n_types = n_types;
  args.excl = static_cast<const int32_t*>(excl);
  args.excl_rows = excl_rows;
  args.n_excl = n_excl;
  args.excl_w = static_cast<const float*>(excl_w);
  args.ns = 0;
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
  args.s_exp = s_exp;
  args.step = step;
  args.seed = seed;
  args.rounds = rounds;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      debug ? dispatch_general<kDebug>(args, n_blocks, threads, smem_bytes,
                                       st, min_image, false, n_types > 1)
            : dispatch_general<kDpd>(args, n_blocks, threads, smem_bytes, st,
                                     min_image, tea, n_types > 1);
  return static_cast<int>(e);
}
