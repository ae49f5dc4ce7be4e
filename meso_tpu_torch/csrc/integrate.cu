// The modified velocity-Verlet update of core/integrate.py, for Hopper
// (sm_90a): the predictor with its optional wrap, and the corrector.
//
// Replaces no TPU kernel: the JAX package writes the integrator as XLA
// code, and the port ran it as plain torch (core/integrate.py::
// initial_integrate_plain and final_integrate_plain): about 9 operations a
// step for the predictor (17 with the wrap every step) and 5 for the
// corrector, each one launch the host issues and one pass over the rows.
// The kernels compute the same numbers bit for bit: every float operation
// is the one torch runs, in torch's order, rounded to nearest through the
// _rn intrinsics, which the compiler never contracts. The scalars arrive
// as torch casts a Python float that multiplies a float32 tensor: rounded
// to float32 from the double.
//
// Predictor, a thread a row, on each axis (a = f * inv_mass):
//   v~ = v + (lam dt) a, x' = (x + dt v) + (dt^2 / 2) a on mobile rows,
//   v and x unchanged on the others; with the wrap, l = hi - lo,
//   shift = floor((x' - lo) / l), x' - shift * l (lo where that is >= hi),
//   image + shift.
// Corrector: v' = v + (dt / 2) ((f_old + f_new) * inv_mass) on mobile
// rows, v on the others.
// inv_mass is a value a row, or one value for every row (per_row 0).
// Bytes a row: predictor 37 read and 24 written (+ 12 and 12 with the
// wrap), corrector 37 read and 12 written, plus inv_mass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;

__global__ void __launch_bounds__(kRowThreads)
initial_kernel(const float* __restrict__ x, const float* __restrict__ v,
               const float* __restrict__ f, const int* __restrict__ image,
               const float* __restrict__ inv_mass, int per_row,
               const uint8_t* __restrict__ move,
               const float* __restrict__ lo, const float* __restrict__ hi,
               float* __restrict__ x_out, float* __restrict__ v_out,
               int* __restrict__ image_out, long long n, float dt,
               float c_v, float c_x, int wrap) {
  const long long i = blockIdx.x * static_cast<long long>(kRowThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const float im = inv_mass[per_row ? i : 0];
  const bool m = move[i] != 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const long long e = 3 * i + d;
    const float vd = v[e];
    const float xd = x[e];
    const float a = __fmul_rn(f[e], im);
    v_out[e] = m ? __fadd_rn(vd, __fmul_rn(c_v, a)) : vd;
    float xn = m ? __fadd_rn(__fadd_rn(xd, __fmul_rn(dt, vd)),
                             __fmul_rn(c_x, a))
                 : xd;
    if (wrap) {
      const float lod = lo[d];
      const float hid = hi[d];
      const float l = __fsub_rn(hid, lod);
      const int shift =
          static_cast<int>(floorf(__fdiv_rn(__fsub_rn(xn, lod), l)));
      xn = __fsub_rn(xn, __fmul_rn(static_cast<float>(shift), l));
      if (xn >= hid) xn = lod;
      image_out[e] = image[e] + shift;
    }
    x_out[e] = xn;
  }
}

__global__ void __launch_bounds__(kRowThreads)
final_kernel(const float* __restrict__ v, const float* __restrict__ f_old,
             const float* __restrict__ f_new,
             const float* __restrict__ inv_mass, int per_row,
             const uint8_t* __restrict__ move, float* __restrict__ v_out,
             long long n, float c_v) {
  const long long i = blockIdx.x * static_cast<long long>(kRowThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const float im = inv_mass[per_row ? i : 0];
  const bool m = move[i] != 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const long long e = 3 * i + d;
    const float vd = v[e];
    const float a = __fmul_rn(__fadd_rn(f_old[e], f_new[e]), im);
    v_out[e] = m ? __fadd_rn(vd, __fmul_rn(c_v, a)) : vd;
  }
}

}  // namespace

// The predictor over n rows: x, v, f float32 (n, 3); move one byte a row;
// inv_mass float32, n values (per_row 1) or one; x_out and v_out (n, 3)
// written. With wrap, image int32 (n, 3) and the box's lo and hi (3,) are
// read and image_out (n, 3) written; without, they may be null. dt, c_v =
// lam dt and c_x = dt^2 / 2 as float32. One kernel on ``stream``.
extern "C" int meso_initial_integrate(const void* x, const void* v,
                                      const void* f, const void* image,
                                      const void* inv_mass, int per_row,
                                      const void* move, const void* lo,
                                      const void* hi, void* x_out,
                                      void* v_out, void* image_out, int n,
                                      float dt, float c_v, float c_x,
                                      int wrap, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kRowThreads - 1) / kRowThreads;
  initial_kernel<<<blocks, kRowThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(v),
      static_cast<const float*>(f), static_cast<const int*>(image),
      static_cast<const float*>(inv_mass), per_row,
      static_cast<const uint8_t*>(move), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<float*>(x_out),
      static_cast<float*>(v_out), static_cast<int*>(image_out), n, dt, c_v,
      c_x, wrap);
  return static_cast<int>(cudaGetLastError());
}

// The corrector over n rows: v, f_old, f_new float32 (n, 3); inv_mass and
// move as the predictor's; v_out (n, 3) written; c_v = dt / 2 as float32.
// One kernel on ``stream``.
extern "C" int meso_final_integrate(const void* v, const void* f_old,
                                    const void* f_new, const void* inv_mass,
                                    int per_row, const void* move,
                                    void* v_out, int n, float c_v,
                                    void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kRowThreads - 1) / kRowThreads;
  final_kernel<<<blocks, kRowThreads, 0, st>>>(
      static_cast<const float*>(v), static_cast<const float*>(f_old),
      static_cast<const float*>(f_new), static_cast<const float*>(inv_mass),
      per_row, static_cast<const uint8_t*>(move), static_cast<float*>(v_out),
      n, c_v);
  return static_cast<int>(cudaGetLastError());
}
