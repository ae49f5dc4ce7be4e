// eDPD and tDPD pair forces and transport fluxes on bucket rows, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel meso_tpu/kernels/pair_dpd_v3.py::_v3_kernel
// (line 75) with model="edpd" (K2, bucket_forces_pallas_v3_edpd, :871) and
// model="tdpd" (K3, bucket_forces_pallas_v3_tdpd, :896).
//
// Both compute a full traversal: each row sums its own force, virial and
// flux in registers, no atomics. The TPU kernel visits each pair once
// (Newton folding) and so has to split eDPD's heat into a part both sides
// gain (q^V) and a part they exchange (q^C + q^R), returned through a
// reaction plane. Here row i computes q(i <- j) directly, as the dense
// oracles do (meso_tpu/ops/edpd.py:68-99, ops/tdpd.py:72-86).
//
// eDPD, per pair (w = 1 - r/rc, sign = +1 if tag_i < tag_j else -1):
//   sigma^2 = 4 gamma T_i T_j / (T_i + T_j),  theta = uniform_stream(hp, 0)
//   F   = a w - gamma w^2 (e.v) + sigma w theta / sqrt(dt)
//   k   = kappa (T_i + T_j)^2 / 4
//   q_C = k w^2 (1/T_i - 1/T_j)
//   q_V = 1/2 [w^2 (gamma (e.v)^2 - sigma^2/m) - sigma w (e.v) theta/sqrt(dt)]
//   q_R = sqrt(2k) w sign uniform_stream(hp, 1) / sqrt(dt)
//   dT_i/dt = sum_j (q_C + q_V + q_R) / cv.
// tDPD: the classic force, and for each species s inside r < rcc, with
// w_dc = (1 - r/rcc)^s1,
//   dC_i,s/dt = sum_j -kappa_s w_dc (C_i,s - C_j,s)
//               + eps_s sqrt(w_dc) sign uniform_stream(hp, 2 + s) / sqrt(dt).
// rcc <= rc_ij for every type pair is required (the visitor sees a pair
// only inside its own rc_ij; ROADMAP Queue 3, R9); the wrapper checks it.
// Per-type-pair tables (T x T, row-major, typ_i * T + typ_j): with T > 1
// the walk tests the table's largest rc^2 with a 1e-4 margin and the
// visitor the pair's own rc_ij on r^2 summed without fused multiply-adds
// (the plain version's order); a template flag (kTypes) keeps the one-type
// instantiations' coefficients in registers.
//
// K2 (pair_edpd_v3_kernel) and K3 (pair_tdpd_v3_kernel) work on K1's cell
// tiles (cell_tiles.cuh with the BucketRows source policy,
// kernels/cell_tiles.py::plan and its table) with the model's visitor of
// pair_visitor.cuh over per-row arrays, the one the brick kernel runs over
// its planes: a block stages its tile's valid sources in shared memory and
// a thread a valid target walks only the occupied slots, culls into a
// list and evaluates it. K2 gathers v, the tag, h and T of each in-range
// source and holds the target's T and 1/T across the walk. K3's species ride in blocks of kSpeciesBlock
// registers (one for one species, as the tDPD path runs it), grid.y walks
// the blocks, each staging its tile again, and species block 0 writes f
// and the virial; kappa, eps and the target's C are read at the flux.
// Without the minimum image dr = (xi - xj) - shift (K1's rule); with it
// the raw-difference walk.
//
// What bounds them: at the 1M-particle eDPD shape (ncell 50^3, K = 16,
// nr = 2,000,000, spill) ~12.9M ordered pairs are inside rc; the distinct
// bytes (x, v, T, tag, mask, h in; f, dT/dt and the per-row virial out)
// are ~71 MB, ~21 us at 3.35 TB/s, and the in-range arithmetic (74 fp32
// operations a pair, 33 integer ones for the hash streams) less. Neither
// bounds them: the walk does, 371 slot tests a valid row from shared
// memory (the former one-thread-a-row walk made 720 from device memory),
// then the in-range visitor, as for K1 (PERF.md).

#include "cell_tiles.cuh"
#include "pair_visitor.cuh"

namespace {

using namespace meso;
using tiles::BucketRows;

__global__ void uniform_stream_kernel(const uint32_t* __restrict__ h,
                                      float* __restrict__ out, int n,
                                      uint32_t salt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = uniform_stream(h[i], salt);
}

// K2 on K1's cell tiles and table (cell_tiles.cuh over bucket rows) with
// the eDPD visitor of pair_visitor.cuh over per-row arrays: fld is T,
// x3_tab kappa, extra dT/dt. Without the minimum image dr = (xi - xj) -
// shift as in K1; with it the raw-difference walk.
template <bool kMinImage, bool kTea, bool kTypes>
__global__ void __launch_bounds__(tiles::kTileMaxThreads)
pair_edpd_v3_kernel(const __grid_constant__ RowArgs p) {
  const BucketRows src{p.valid, p.x, p.nx};
  PairVisitor<kEdpd, kTea, kTypes, 1, RowFields, RowArgs> vis(p, p.fields());
  tiles::run_tile<kMinImage ? tiles::kImageRaw : tiles::kShift>(
      src, vis, p.table, p.k, p.xr, p.width, p.list_cap, p.box_lo,
      p.box_hi);
}

// K3 on K1's cell tiles and table (cell_tiles.cuh over bucket rows) with
// the tDPD visitor of pair_visitor.cuh over per-row arrays; kSb species a
// register block (1 for one species, else kSpeciesBlock; grid.y walks the
// blocks, each staging its tile again, and block 0 writes f and the
// virial). Without the minimum image dr = (xi - xj) - shift as in K1;
// with it the walk tests the raw difference and takes the minimum image
// only where an axis wraps.
template <bool kMinImage, bool kTea, bool kTypes, int kSb>
__global__ void __launch_bounds__(tiles::kTileMaxThreads)
pair_tdpd_v3_kernel(const __grid_constant__ RowArgs p) {
  const BucketRows src{p.valid, p.x, p.nx};
  PairVisitor<kTdpd, kTea, kTypes, kSb, RowFields, RowArgs> vis(p,
                                                              p.fields());
  tiles::run_tile<kMinImage ? tiles::kImageRaw : tiles::kShift>(
      src, vis, p.table, p.k, p.xr, p.width, p.list_cap, p.box_lo,
      p.box_hi);
}

// K2's instance for the run-time flags.
cudaError_t launch_edpd(const RowArgs& args, dim3 grid, int threads,
                        int smem, cudaStream_t st, bool min_image, bool tea,
                        bool types) {
#define MESO_EDPD(mi, te, ty)                                               \
  if (min_image == mi && tea == te && types == ty)                          \
    return tiles::launch_tile(pair_edpd_v3_kernel<mi, te, ty>, args, grid,  \
                              threads, smem, st);
  MESO_EDPD(false, false, false)
  MESO_EDPD(false, false, true)
  MESO_EDPD(false, true, false)
  MESO_EDPD(false, true, true)
  MESO_EDPD(true, false, false)
  MESO_EDPD(true, false, true)
  MESO_EDPD(true, true, false)
  MESO_EDPD(true, true, true)
#undef MESO_EDPD
  return cudaErrorInvalidValue;
}

// K3's instance for the run-time flags.
template <int kSb>
cudaError_t launch_tdpd(const RowArgs& args, dim3 grid, int threads,
                        int smem, cudaStream_t st, bool min_image, bool tea,
                        bool types) {
#define MESO_TDPD(mi, te, ty)                                               \
  if (min_image == mi && tea == te && types == ty)                          \
    return tiles::launch_tile(pair_tdpd_v3_kernel<mi, te, ty, kSb>, args,   \
                              grid, threads, smem, st);
  MESO_TDPD(false, false, false)
  MESO_TDPD(false, false, true)
  MESO_TDPD(false, true, false)
  MESO_TDPD(false, true, true)
  MESO_TDPD(true, false, false)
  MESO_TDPD(true, false, true)
  MESO_TDPD(true, true, false)
  MESO_TDPD(true, true, true)
#undef MESO_TDPD
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int meso_uniform_stream(const void* h, void* out, int n,
                                   uint32_t salt, void* stream) {
  if (n > 0) {
    uniform_stream_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(h), static_cast<float*>(out), n, salt);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 on the cell tiles of kernels/cell_tiles.py::plan (K1's plan and
// table, the same staged record); refused as meso_pair_dpd_v3 is.
extern "C" int meso_pair_edpd_v3(
    const void* x, const void* v, const void* t, const void* tag,
    const void* typ, const void* valid, const void* h, const void* a_tab,
    const void* gamma_tab, const void* kappa_tab, const void* rc_tab,
    int n_types, const void* box_lo, const void* box_hi, const void* table,
    void* f, void* dtdt, void* vir, int nx, int k, int xr, int width,
    int n_blocks, int threads, int list_cap, int smem_bytes, int min_image,
    int tea, float dt_inv_sqrt, float mass, float cv, uint32_t step,
    uint32_t seed, int rounds, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  if (tiles::tile_launch_refused<BucketRows>(width, xr, k, threads, list_cap,
                                             smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  RowArgs args = {};
  args.x = static_cast<const float*>(x);
  args.v = static_cast<const float*>(v);
  args.tag = static_cast<const int32_t*>(tag);
  args.typ = static_cast<const int32_t*>(typ);
  args.valid = static_cast<const uint8_t*>(valid);
  args.h = static_cast<const uint32_t*>(h);
  args.fld = static_cast<const float*>(t);
  args.a_tab = static_cast<const float*>(a_tab);
  args.gamma_tab = static_cast<const float*>(gamma_tab);
  args.x3_tab = static_cast<const float*>(kappa_tab);
  args.rc_tab = static_cast<const float*>(rc_tab);
  args.n_types = n_types;
  args.ns = 1;
  args.box_lo = static_cast<const float*>(box_lo);
  args.box_hi = static_cast<const float*>(box_hi);
  args.table = static_cast<const int32_t*>(table);
  args.f = static_cast<float*>(f);
  args.extra = static_cast<float*>(dtdt);
  args.vir = static_cast<float*>(vir);
  args.nx = nx;
  args.k = k;
  args.xr = xr;
  args.width = width;
  args.list_cap = list_cap;
  args.dt_inv_sqrt = dt_inv_sqrt;
  args.s_exp = 1.0f;
  args.mass = mass;
  args.cv = cv;
  args.step = step;
  args.seed = seed;
  args.rounds = rounds;
  return static_cast<int>(launch_edpd(args, dim3(n_blocks), threads,
                                      smem_bytes,
                                      static_cast<cudaStream_t>(stream),
                                      min_image, tea, n_types > 1));
}

// K3 on the cell tiles of kernels/cell_tiles.py::plan (K1's plan and
// table, the same staged record); refused as meso_pair_dpd_v3 is, or
// with no species.
extern "C" int meso_pair_tdpd_v3(
    const void* x, const void* v, const void* c, const void* tag,
    const void* typ, const void* valid, const void* h, const void* a_tab,
    const void* gamma_tab, const void* sigma_tab, const void* rc_tab,
    int n_types, const void* kappa_c, const void* eps_c,
    const void* box_lo, const void* box_hi, const void* table, void* f,
    void* dcdt, void* vir, int nx, int k, int xr, int ns, int width,
    int n_blocks, int threads, int list_cap, int smem_bytes, int min_image,
    int tea, float dt_inv_sqrt, float rcc, float s1, uint32_t step,
    uint32_t seed, int rounds, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  if (ns < 1 || tiles::tile_launch_refused<BucketRows>(
                    width, xr, k, threads, list_cap, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  RowArgs args = {};
  args.x = static_cast<const float*>(x);
  args.v = static_cast<const float*>(v);
  args.tag = static_cast<const int32_t*>(tag);
  args.typ = static_cast<const int32_t*>(typ);
  args.valid = static_cast<const uint8_t*>(valid);
  args.h = static_cast<const uint32_t*>(h);
  args.fld = static_cast<const float*>(c);
  args.a_tab = static_cast<const float*>(a_tab);
  args.gamma_tab = static_cast<const float*>(gamma_tab);
  args.x3_tab = static_cast<const float*>(sigma_tab);
  args.rc_tab = static_cast<const float*>(rc_tab);
  args.n_types = n_types;
  args.ns = ns;
  args.kappa_c = static_cast<const float*>(kappa_c);
  args.eps_c = static_cast<const float*>(eps_c);
  args.box_lo = static_cast<const float*>(box_lo);
  args.box_hi = static_cast<const float*>(box_hi);
  args.table = static_cast<const int32_t*>(table);
  args.f = static_cast<float*>(f);
  args.extra = static_cast<float*>(dcdt);
  args.vir = static_cast<float*>(vir);
  args.nx = nx;
  args.k = k;
  args.xr = xr;
  args.width = width;
  args.list_cap = list_cap;
  args.dt_inv_sqrt = dt_inv_sqrt;
  args.s_exp = 1.0f;
  args.rcc = rcc;
  args.s1 = s1;
  args.step = step;
  args.seed = seed;
  args.rounds = rounds;
  // one species (the tDPD path) keeps one register; more take blocks
  const int sb = ns > 1 ? kSpeciesBlock : 1;
  const dim3 grid(n_blocks, (ns + sb - 1) / sb);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      sb == 1 ? launch_tdpd<1>(args, grid, threads, smem_bytes, st,
                               min_image, tea, n_types > 1)
              : launch_tdpd<kSpeciesBlock>(args, grid, threads, smem_bytes,
                                           st, min_image, tea, n_types > 1);
  return static_cast<int>(e);
}
