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
// Design: the cell tiles of cell_tiles.cuh (run_tile, with the BrickPlanes
// source policy) and the pair visitor of pair_visitor.cuh over the brick's
// channel planes (BrickFields), the same machinery as K1, K1's general
// variant and K3 over bucket rows. A block owns one target (cy, cz) and a
// run of W consecutive cx (kernels/cell_tiles.py::brick_plan sizes W, the
// threads and the dynamic shared memory; brick_table gives each block its
// run and the brick index of its 9 lines); it stages its 3 x 3 lines x
// (W + 2 xr) brick columns compacted to their valid slots, with the brick
// index as the staged position's fourth word, and a thread a valid target
// walks the occupied slots, culls into a list and evaluates it. The walk
// tests the raw difference (Wrap kImageRaw): the pads may hold raw
// periodic copies, and only candidates whose raw r^2 shows a wrapped axis
// take the minimum image. For the in-range entries only the visitor
// gathers v, the hash, the type, T or C and, where read, the tag from the
// planes; the target's exclusion tags sit in registers (kExclRegs of them,
// the rest read from the brick). tDPD species ride in blocks of
// kSpeciesBlock registers (one register for one species): grid.y walks
// the species blocks, each block staging its tile again, and only species
// block 0 writes f and the virial. Staging once and looping over the
// species blocks inside the block was the other way; it would need each
// thread's flux sums for every species across list flushes (registers or
// shared memory growing with S), where the paths run one species and a
// second block's staging runs on other SMs in parallel. The rc_ij tests
// hold rcc <= every rc_ij (the wrapper's R9).
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

#include "cell_tiles.cuh"
#include "pair_visitor.cuh"

namespace {

using namespace meso;
using tiles::BrickPlanes;

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
  const int32_t* table;  // (n_blocks, BrickPlanes::table_width)
  int nx, ny, nz, k, xr, width, list_cap;
  float dt_inv_sqrt, s_exp, mass, cv, rcc, s1;
  uint32_t step, seed;
  int rounds;
};

// kTypes: per-type-pair tables (else the row keeps one type's coefficients
// in registers); kSb: tDPD species per register block (grid.y walks the
// blocks).
template <int kModel, bool kTea, bool kTypes, int kSb>
__global__ void __launch_bounds__(tiles::kTileMaxThreads)
pair_brick_kernel(const __grid_constant__ BrickArgs p) {
  const int px = p.nx + 2 * p.xr;
  // in-plane offsets are 32-bit (the launcher refuses a plane of 2^31 or
  // more elements); channel offsets are not
  const size_t chan = static_cast<size_t>(p.ny + 2) * (p.nz + 2) * p.k * px;
  const BrickPlanes src{p.ib + chan, p.fb, chan, px, p.nx, p.nz, p.k, p.xr};
  using Fields = BrickFields<kTea, kTypes>;
  PairVisitor<kModel, kTea, kTypes, kSb, Fields, BrickArgs> vis(
      p, Fields(p.fb, p.ib, chan, p.ch_h, p.ch_typ, p.ch_ex, p.n_excl));
  tiles::run_tile<tiles::kImageRaw>(src, vis, p.table, p.k, p.xr, p.width,
                                    p.list_cap, p.box_lo, p.box_hi);
}

template <int kModel, bool kTea, bool kTypes, int kSb>
cudaError_t launch_tiles(const BrickArgs& args, dim3 grid, int threads,
                         int smem, cudaStream_t stream) {
  return tiles::launch_tile(pair_brick_kernel<kModel, kTea, kTypes, kSb>,
                            args, grid, threads, smem, stream);
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
// ``table`` is the plan's brick_table on the card, (n_blocks,
// BrickPlanes::table_width) int32; width, threads, list_cap and smem_bytes
// are the plan's. Refused (cudaErrorInvalidValue, nothing launched): a
// launch tiles::tile_launch_refused refuses (a block of more than
// kTileMaxThreads threads or not whole warps, more than 32 source columns,
// more staged slots than the lists' uint16 index reaches, a smem_bytes
// that differs from the layout's), a plane of 2^31 elements or more, or a
// channel the model or RNG tier reads that is missing.
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
  if (model < kDpd || model > kTdpd || (model == kTdpd && ns < 1) ||
      (n_types > 1 && ch_typ < 0) || (!tea && ch_h < 0) ||
      (n_excl > 0 && ch_ex < 0) || plane >= (1LL << 31) ||
      tiles::tile_launch_refused<BrickPlanes>(width, xr, k, threads,
                                              list_cap, smem_bytes)) {
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
