// The per-pair visitor of the cell-tile kernels (cell_tiles.cuh) for the
// three pair models over per-type-pair tables, shared by the brick kernel
// (pair_brick.cu: K4-K7, K6-halo), K1's general variant (pair_dpd_v3.cu),
// K2 and K3 (pair_transport_v3.cu). What differs between them is where an
// entry's fields lie, the Fields accessor: channel planes of the brick
// (BrickFields, gather index = brick index) or per-row arrays (RowFields,
// gather index = row).
//
// Per in-range entry (dr = x_i - x_j under the kernel's periodic rule):
// r^2 is summed again without fused multiply-adds (the plain versions'
// order), the pair's own rc_ij is tested (the walk took the table's
// largest rc^2 with a 1e-4 margin) and the target itself (r^2 = 0)
// dropped, so the kernel takes exactly the plain version's pairs. Then,
// with w = 1 - r / rc_ij and the tables' a, gamma and sigma (or kappa,
// eDPD) of the pair:
// - kDpd, classic: fmag = w (a - gamma w (e.v) + s theta) with s = sigma /
//   sqrt(dt); s_exp != 1 takes wr = max(w, 0)^s_exp for the dissipative
//   and random weights (the conservative part keeps w); fmag times excl_w
//   where tag_j is one of the target's exclusion tags (the first
//   kExclRegs of them held in registers, the rest read on a hit test);
// - kEdpd: the force and the heat q(i <- j) of ops/edpd.py, the
//   antisymmetric noise signed by tag order;
// - kTdpd: the classic force with s_exp = 1, and inside rcc, with w_dc =
//   (1 - r / rcc)^s1 and r the correctly rounded root of the unfused r^2
//   (sqrt(w_dc) magnifies an ulp of r near rcc), per species s
//   dC_i/dt += -kappa_s w_dc (C_i - C_j) + eps_s sqrt(w_dc) xi / sqrt(dt),
//   xi signed by tag order; kappa, eps and the target's C are read at the
//   flux, not held in registers across the walk (with 8 species a block
//   they would be 24 more live registers);
// - kDebug (debug_pairs): f = (the in-range partners, the sum of their
//   keys h_j >> 18, 0), no virial; h is the per-particle hash.
// f, the virial (0.5 fmag r per pair, the row's half) and eDPD's dT/dt are
// written by species block 0 only; tDPD species ride in blocks of kSb
// registers (grid.y walks the blocks, each staging its tile again).
// Without per-type tables (kTypes false) a, gamma, sigma or kappa and rc
// are the table's first entry, held in registers.

#pragma once

#include "dpd_common.cuh"

namespace meso {

constexpr int kDpd = 0, kEdpd = 1, kTdpd = 2, kDebug = 3;
constexpr int kSpeciesBlock = 8;
constexpr int kExclRegs = 4;  // the target's exclusion tags in registers

// The brick's channel planes (kernels/_brick.py): fb (nf, planes) float32:
// x, y, z, vx, vy, vz, then T or C_0 .. C_{S-1}; ib (ni, planes) int32:
// tag, valid, then h, typ and the E exclusion tags where present.
template <bool kTea, bool kTypes>
struct BrickFields {
  const float* vxb;
  const float* vyb;
  const float* vzb;
  const float* mb;  // T or C_0
  const int32_t* tagb;
  const int32_t* hb;
  const int32_t* typb;
  const int32_t* ib;
  size_t chan;
  int ch_ex, n_excl;

  __device__ BrickFields(const float* fb, const int32_t* ib_, size_t chan_,
                         int ch_h, int ch_typ, int ch_ex_, int n_excl_)
      : vxb(fb + 3 * chan_), vyb(fb + 4 * chan_), vzb(fb + 5 * chan_),
        mb(fb + 6 * chan_), tagb(ib_),
        hb(ib_ + (kTea ? 0 : ch_h * chan_)),
        typb(ib_ + (kTypes ? ch_typ * chan_ : 0)), ib(ib_), chan(chan_),
        ch_ex(ch_ex_), n_excl(n_excl_) {}
  // the planes are read through the read-only data path (__ldg), as the
  // brick kernel read them before the shared header: with plain loads its
  // classic instance ran 1.8% slower on an H100 (PERF.md, PR 9)
  __device__ float vx(int j) const { return __ldg(vxb + j); }
  __device__ float vy(int j) const { return __ldg(vyb + j); }
  __device__ float vz(int j) const { return __ldg(vzb + j); }
  __device__ int32_t tag(int j) const { return __ldg(tagb + j); }
  __device__ uint32_t h(int j) const {
    return static_cast<uint32_t>(__ldg(hb + j));
  }
  __device__ int typ(int j) const { return __ldg(typb + j); }
  __device__ float temp(int j) const { return __ldg(mb + j); }
  __device__ float conc(int j, int s) const {
    return __ldg(mb + s * chan + j);
  }
  // the target's exclusion tags: where they start, how many, the e-th
  __device__ size_t excl_base(int self, int32_t) const {
    return ch_ex * chan + self;
  }
  __device__ int excl_count(int32_t) const { return n_excl; }
  __device__ int32_t excl_at(size_t base, int e) const {
    return __ldg(ib + base + e * chan);
  }
};

// Per-row arrays of the bucket layout: v (nr, 3), tag, the per-particle
// hash h (or the tags, TEA tier), typ, the field (T (nr,) or C (nr, S)),
// and the exclusion table excl (excl_rows, n_excl) indexed by tag.
struct RowFields {
  const float* v;
  const int32_t* tg;
  const uint32_t* hh;
  const int32_t* ty;
  const float* fld;
  int ns;
  const int32_t* excl;
  int excl_rows, n_excl;

  // read-only data path, as BrickFields (in a timing trial on an H100 K3
  // and the walls' general variant ran faster with it than with plain
  // loads, K1's own visitor slower: PERF.md, PR 9)
  __device__ float vx(int j) const { return __ldg(v + 3 * j); }
  __device__ float vy(int j) const { return __ldg(v + 3 * j + 1); }
  __device__ float vz(int j) const { return __ldg(v + 3 * j + 2); }
  __device__ int32_t tag(int j) const { return __ldg(tg + j); }
  __device__ uint32_t h(int j) const { return __ldg(hh + j); }
  __device__ int typ(int j) const { return __ldg(ty + j); }
  __device__ float temp(int j) const { return __ldg(fld + j); }
  __device__ float conc(int j, int s) const {
    return __ldg(fld + j * ns + s);
  }
  __device__ size_t excl_base(int, int32_t tag_i) const {
    return static_cast<size_t>(tag_i) * n_excl;
  }
  __device__ int excl_count(int32_t tag_i) const {
    return n_excl > 0 && tag_i >= 0 && tag_i < excl_rows ? n_excl : 0;
  }
  __device__ int32_t excl_at(size_t base, int e) const {
    return __ldg(excl + base + e);
  }
};

// The argument struct of the tile kernels over bucket rows (K1's general
// variant, K2, K3): the rows, the coefficient tables, the outputs (f (nr, 3),
// extra: dT/dt (nr,) or dC/dt (nr, S), the per-row virial (nr,)) and the
// plan's table, width and list capacity (kernels/cell_tiles.py::plan).
struct RowArgs {
  const float* x;
  const float* v;
  const int32_t* tag;
  const int32_t* typ;
  const uint8_t* valid;
  const uint32_t* h;  // the per-particle hash (fast tier) or the tags (TEA)
  const float* fld;   // T (nr,) or C (nr, S); null for classic DPD
  const float* a_tab;
  const float* gamma_tab;
  const float* x3_tab;  // sigma (classic, tDPD) or kappa (eDPD), (T, T)
  const float* rc_tab;
  int n_types;
  const int32_t* excl;
  int excl_rows, n_excl;
  const float* excl_w;
  int ns;
  const float* kappa_c;
  const float* eps_c;
  const float* box_lo;
  const float* box_hi;
  const int32_t* table;  // (n_blocks, BucketRows::table_width(ncols))
  float* f;
  float* extra;
  float* vir;
  int nx, k, xr, width, list_cap;
  float dt_inv_sqrt, s_exp, mass, cv, rcc, s1;
  uint32_t step, seed;
  int rounds;

  __device__ RowFields fields() const {
    return RowFields{v, tag, h, typ, fld, ns, excl, excl_rows, n_excl};
  }
};

// Args: the kernel's argument struct, with the members a_tab, gamma_tab,
// x3_tab (sigma, or kappa for eDPD), rc_tab, n_types, excl_w, ns, kappa_c,
// eps_c, f, extra (dT/dt (nr,) or dC/dt (nr, S)), vir, dt_inv_sqrt, s_exp,
// mass, cv, rcc, s1, step, seed, rounds.
template <int kModel, bool kTea, bool kTypes, int kSb, class Fields,
          class Args>
struct PairVisitor {
  const Args& p;
  const Fields fl;
  const int s0;  // the block's first species
  // block constants
  float rc2_walk, a0, gamma0, x30, rc0, w_excl, rcc2;
  // the target's fields and sums
  int self;
  float vxi, vyi, vzi, ti, inv_ti;
  int32_t tag_i;
  uint32_t h_i;
  int t_row;
  int32_t ex[kExclRegs];
  float fx, fy, fz, vsum, qsum, qs[kSb];

  struct Gathered {
    float vx, vy, vz, fj;
    int32_t tag;
    uint32_t h;
    int typ;
  };

  __device__ PairVisitor(const Args& args, const Fields& fields)
      : p(args), fl(fields), s0(static_cast<int>(blockIdx.y) * kSb) {}

  __device__ void zero(int r) const {
    if (s0 == 0) {
      p.f[3 * r] = 0.0f;
      p.f[3 * r + 1] = 0.0f;
      p.f[3 * r + 2] = 0.0f;
      if (kModel != kDebug) p.vir[r] = 0.0f;
      if (kModel == kEdpd) p.extra[r] = 0.0f;
    }
    if (kModel == kTdpd) {
#pragma unroll
      for (int s = 0; s < kSb; ++s)
        if (s0 + s < p.ns)
          p.extra[static_cast<size_t>(r) * p.ns + s0 + s] = 0.0f;
    }
  }

  __device__ void init() {
    float rc2_max = 0.0f;
    for (int q2 = 0; q2 < p.n_types * p.n_types; ++q2)
      rc2_max = fmaxf(rc2_max, p.rc_tab[q2] * p.rc_tab[q2]);
    rc2_walk = rc2_max * 1.0001f;
    a0 = p.a_tab[0];
    gamma0 = p.gamma_tab[0];
    x30 = p.x3_tab[0];
    rc0 = p.rc_tab[0];
    w_excl = kModel == kDpd && fl.n_excl > 0 ? p.excl_w[0] : 1.0f;
    rcc2 = p.rcc * p.rcc;
  }

  __device__ float walk_rc2() const { return rc2_walk; }

  __device__ void begin(int, int self_) {
    self = self_;
    vxi = fl.vx(self);
    vyi = fl.vy(self);
    vzi = fl.vz(self);
    tag_i = fl.tag(self);
    h_i = kTea && kModel != kDebug ? 0u : fl.h(self);
    t_row = kTypes ? fl.typ(self) * p.n_types : 0;
    ti = kModel == kEdpd ? fl.temp(self) : 0.0f;
    inv_ti = 1.0f / fmaxf(ti, 1e-12f);
    // the exclusion count and base are recomputed where read (a hit test)
    // rather than held across the walk
#pragma unroll
    for (int e = 0; e < kExclRegs; ++e)
      ex[e] = kModel == kDpd && e < fl.excl_count(tag_i)
                  ? fl.excl_at(fl.excl_base(self, tag_i), e) : 0;
    fx = fy = fz = vsum = qsum = 0.0f;
#pragma unroll
    for (int s = 0; s < kSb; ++s) qs[s] = 0.0f;
  }

  __device__ Gathered fetch(int j) const {
    Gathered g;
    if (kModel != kDebug) {
      g.vx = fl.vx(j);
      g.vy = fl.vy(j);
      g.vz = fl.vz(j);
    }
    // the tag signs the transport noises and finds exclusions; the TEA
    // tier hashes it; classic DPD on the fast tier reads none
    g.tag = kModel != kDebug && (kTea || kModel != kDpd || fl.n_excl > 0)
                ? fl.tag(j) : 0;
    g.h = kTea && kModel != kDebug ? 0u : fl.h(j);
    g.typ = kTypes ? fl.typ(j) : 0;
    g.fj = kModel == kEdpd ? fl.temp(j) : 0.0f;
    return g;
  }

  __device__ void pair(const Gathered& g, int j, float drx, float dry,
                       float drz) {
    const float r2 = __fadd_rn(
        __fadd_rn(__fmul_rn(drx, drx), __fmul_rn(dry, dry)),
        __fmul_rn(drz, drz));
    float a = a0, gamma = gamma0, x3 = x30, rc = rc0;
    if (kTypes) {
      const int pr = t_row + g.typ;
      a = p.a_tab[pr];
      gamma = p.gamma_tab[pr];
      x3 = p.x3_tab[pr];
      rc = p.rc_tab[pr];
    }
    if (!(r2 < rc * rc) || !(r2 > 0.0f)) return;
    if (kModel == kDebug) {
      fx += 1.0f;
      fy += static_cast<float>(g.h >> 18);
      return;
    }
    const float rinv = rsqrtf(r2);
    const float rr = r2 * rinv;
    const float w = 1.0f - rr * (1.0f / rc);
    const float ev = (drx * (vxi - g.vx) + dry * (vyi - g.vy) +
                      drz * (vzi - g.vz)) * rinv;
    const int32_t tag_j = g.tag;
    const uint32_t hp = pair_hash<kTea>(tag_i, tag_j, h_i, g.h, p.step,
                                        p.seed, p.rounds);
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
      if (fl.n_excl > 0) {
        const int n_ex = fl.excl_count(tag_i);
        bool hit = false;
#pragma unroll
        for (int e = 0; e < kExclRegs; ++e)
          hit |= e < n_ex && ex[e] == tag_j;
        for (int e = kExclRegs; e < n_ex; ++e)
          hit |= fl.excl_at(fl.excl_base(self, tag_i), e) == tag_j;
        if (hit) fmag *= w_excl;
      }
    } else if (kModel == kEdpd) {
      const float theta = uniform_stream(hp, 0u);
      const float w2 = w * w;
      const float tj = g.fj;
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
      fmag = a * w - gamma * (w * w) * ev + x3 * p.dt_inv_sqrt * w * theta;
      if (r2 < rcc2) {
        const float base = fmaxf(1.0f - sqrtf(r2) / p.rcc, 0.0f);
        const float wdc = p.s1 == 1.0f ? base : powf(base, p.s1);
        const float wrc = sqrtf(wdc);
        const float sign = tag_i < tag_j ? 1.0f : -1.0f;
#pragma unroll
        for (int sp = 0; sp < kSb; ++sp) {
          if (s0 + sp < p.ns) {
            const float xi_s = sign * uniform_stream(
                hp, 2u + static_cast<uint32_t>(s0 + sp));
            qs[sp] += -p.kappa_c[s0 + sp] * wdc *
                          (fl.conc(self, s0 + sp) - fl.conc(j, s0 + sp)) +
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

  __device__ void end(int row_i) const {
    if (s0 == 0) {
      p.f[3 * row_i] = fx;
      p.f[3 * row_i + 1] = fy;
      p.f[3 * row_i + 2] = fz;
      if (kModel != kDebug) p.vir[row_i] = vsum;
      if (kModel == kEdpd) p.extra[row_i] = qsum / p.cv;
    }
    if (kModel == kTdpd) {
#pragma unroll
      for (int sp = 0; sp < kSb; ++sp)
        if (s0 + sp < p.ns)
          p.extra[static_cast<size_t>(row_i) * p.ns + s0 + sp] = qs[sp];
    }
  }
};

}  // namespace meso
