// (Accelerated-)Jacobi round for Hopper: one round of the Section-V
// solvers,
//
//     x_next = w (x + inv_d (y - q)) - s x_prev,
//
// with w = 1, s = 0 the plain Jacobi round (Eq. (24)) and the per-round
// Chebyshev-accelerated weights of Eq. (25) otherwise, on (B, n) iterates,
// in two instances.  y and inv_d are either batched (B, n) or one (n,) row
// shared by the whole batch, read with a row stride of 0 (never expanded).
//
// Replaces: src/repro/kernels/jacobi_step.py::jacobi_step.
//
// 1. The stand-alone instance (jacobi_step_f32 / _f64) takes q = Q x from
//    outside (an opaque matvec: the sharded exchange).  f32, and f64 for
//    float64 reference plans on the card.
// 2. The round instance (jacobi_round_f32) fuses the last step of Horner's
//    q = den(P) x with the update on a local sliced-ELL P,
//        q = a (P h) + c_0 x,
//    the row product of h (sliced_ell_rows.cuh) staying in registers.  For
//    deg(den) = 1, h = x and a = den[1]: a round is one launch.  For a
//    higher degree the caller forms h by the earlier Horner steps and
//    passes a = 1.  Rounding: the per-round path used to form P (c_1 x)
//    and now forms c_1 (P x) (ROADMAP 3.5); the two differ in the last
//    bits of q, within the solvers' tolerances.
//
// What bounds them on this card: bytes.  The stand-alone update reads q, x,
// x_prev (and y, inv_d when batched) and writes x_next: 16 to 24 bytes for
// 5 FLOPs per element; the round instance reads the layout once per tile
// of signals (8 bytes per stored entry) in place of q: nnz * 8 + (3 or 5)
// B n * 4 bytes.  Both sit far below the card's ~20 FLOP/byte balance
// point.
//
// What the design does about it: as cheb_step.cu (a 2-D grid over vertex
// tiles and signals, 16-byte accesses where the wrapper allows them; the
// round instance's warp-per-slice product and update in one thread, every
// store a coalesced 128-byte line).  A shared (n,) row of y or inv_d is
// read by every signal from the L2.  x_next may be written over x_prev
// (the per-round loops rotate two buffers), never over x or h, which
// other warps of the round instance still gather; no operand that may
// alias the output is declared __restrict__.  w, s, a and c_0 are scalars
// passed per launch (the TPU kernel read w and s from a (2, 1) operand so
// that one trace served every round of a scan).
#include "sliced_ell_rows.cuh"

namespace {

using slice_rows::load_pack;
using slice_rows::Pack;
using slice_rows::store_pack;

constexpr int kThreads = 256;  // stand-alone: threads per block

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
jacobi_step_kernel(const T* qx, const T* x, const T* x_prev, const T* y,
                   const T* inv_d, T* out, long long n, long long B,
                   long long y_stride, long long d_stride, T w, T s) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (i >= n) return;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const long long e = b * n + i;
    const Pack<T, V> q = load_pack<V>(qx + e);
    const Pack<T, V> xv = load_pack<V>(x + e);
    const Pack<T, V> xp = load_pack<V>(x_prev + e);
    const Pack<T, V> yv = load_pack<V>(y + b * y_stride + i);
    const Pack<T, V> dv = load_pack<V>(inv_d + b * d_stride + i);
    Pack<T, V> o;
#pragma unroll
    for (int v = 0; v < V; ++v)
      o.v[v] = w * (xv.v[v] + dv.v[v] * (yv.v[v] - q.v[v])) - s * xp.v[v];
    store_pack<V>(out + e, o);
  }
}

template <typename T>
int launch_step(const void* qx, const void* x, const void* x_prev,
                const void* y, const void* inv_d, void* out, long long B,
                long long n, long long y_stride, long long d_stride, T w,
                T s, int vec, unsigned gx, unsigned gy, void* stream) {
  const dim3 grid(gx, gy);
  auto st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(qx), static_cast<const T*>(x),
        static_cast<const T*>(x_prev), static_cast<const T*>(y),
        static_cast<const T*>(inv_d), static_cast<T*>(out), n, B, y_stride,
        d_stride, w, s);
  };
  constexpr int kPack = static_cast<int>(16 / sizeof(T));
  if (vec == kPack)
    args(jacobi_step_kernel<T, kPack>);
  else if (vec == 1)
    args(jacobi_step_kernel<T, 1>);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// One round on a sliced-ELL P: q = a (P h) + c0 x, then the update.
template <int TB>
__global__ void __launch_bounds__(slice_rows::kThreads)
jacobi_round_kernel(const float* __restrict__ values,
                    const int* __restrict__ columns,
                    const int* __restrict__ offsets,
                    const int* __restrict__ widths,
                    const float* __restrict__ h, const float* x,
                    const float* x_prev, const float* y, const float* inv_d,
                    float* out, int n_slices, long long n, int B,
                    long long y_stride, long long d_stride, float a,
                    float c0, float w, float s) {
  const int slice = blockIdx.x * slice_rows::kWarps + threadIdx.x / 32;
  if (slice >= n_slices) return;
  const int lane = threadIdx.x % 32;
  const int width = widths[slice];
  const float* v = values + offsets[slice] + lane;
  const int* c = columns + offsets[slice] + lane;
  const long long row = static_cast<long long>(slice) * 32 + lane;
  const int n_bt = (B + TB - 1) / TB;
  for (int bt = blockIdx.y; bt < n_bt; bt += gridDim.y) {
    const int b0 = bt * TB;
    const int nb = B - b0 < TB ? B - b0 : TB;
    float p[TB];
    slice_rows::slice_product<TB>(v, c, width, h + b0 * n, n, nb, p);
    if (row >= n) continue;
    // every load of the tile first (out may alias x_prev), then the stores
    float o[TB];
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      if (t >= nb) break;
      const long long b = b0 + t;
      const long long e = b * n + row;
      const float xv = x[e];
      const float q = a * p[t] + c0 * xv;
      const float r = y[b * y_stride + row] - q;
      o[t] = w * (xv + inv_d[b * d_stride + row] * r) - s * x_prev[e];
    }
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      if (t >= nb) break;
      out[(b0 + t) * n + row] = o[t];
    }
  }
}

template <int TB>
int launch_round(const void* values, const void* columns,
                 const void* offsets, const void* widths, const void* h,
                 const void* x, const void* x_prev, const void* y,
                 const void* inv_d, void* out, int n_slices, long long n,
                 int B, long long y_stride, long long d_stride, float a,
                 float c0, float w, float s, unsigned gx, unsigned gy,
                 cudaStream_t st) {
  jacobi_round_kernel<TB><<<dim3(gx, gy), slice_rows::kThreads, 0, st>>>(
      static_cast<const float*>(values), static_cast<const int*>(columns),
      static_cast<const int*>(offsets), static_cast<const int*>(widths),
      static_cast<const float*>(h), static_cast<const float*>(x),
      static_cast<const float*>(x_prev), static_cast<const float*>(y),
      static_cast<const float*>(inv_d), static_cast<float*>(out), n_slices,
      n, B, y_stride, d_stride, a, c0, w, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The stand-alone instance.  qx, x, x_prev, out: (B, n); y: (B, n) with
// y_stride = n or (n,) with y_stride = 0; inv_d likewise with d_stride.
// x_prev may alias x (the plain Jacobi round passes the iterate twice);
// out may alias x_prev.  vec and the grid (gx, gy) come from
// kernels/cheb_step.py::vector_launch.  Returns the launch's cudaError_t.
int jacobi_step_f32(const void* qx, const void* x, const void* x_prev,
                    const void* y, const void* inv_d, void* out, long long B,
                    long long n, long long y_stride, long long d_stride,
                    float w, float s, int vec, unsigned gx, unsigned gy,
                    void* stream) {
  return launch_step<float>(qx, x, x_prev, y, inv_d, out, B, n, y_stride,
                            d_stride, w, s, vec, gx, gy, stream);
}

int jacobi_step_f64(const void* qx, const void* x, const void* x_prev,
                    const void* y, const void* inv_d, void* out, long long B,
                    long long n, long long y_stride, long long d_stride,
                    double w, double s, int vec, unsigned gx, unsigned gy,
                    void* stream) {
  return launch_step<double>(qx, x, x_prev, y, inv_d, out, B, n, y_stride,
                             d_stride, w, s, vec, gx, gy, stream);
}

// The round instance on a square sliced-ELL layout (core/graph.py::
// SlicedELL).  h, x, x_prev, out: (B, n); y, inv_d as above.  h may be x
// itself; out may alias x_prev but neither h nor x.  tb: signals per
// thread (8, 2 or 1); grid (gx, gy) from kernels/cheb_step.py::
// slice_launch.  Returns the launch's cudaError_t.
int jacobi_round_f32(const void* values, const void* columns,
                     const void* offsets, const void* widths, const void* h,
                     const void* x, const void* x_prev, const void* y,
                     const void* inv_d, void* out, int n_slices, long long n,
                     int B, long long y_stride, long long d_stride, float a,
                     float c0, float w, float s, int tb, unsigned gx,
                     unsigned gy, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (tb) {
    case 8:
      return launch_round<8>(values, columns, offsets, widths, h, x, x_prev,
                             y, inv_d, out, n_slices, n, B, y_stride,
                             d_stride, a, c0, w, s, gx, gy, st);
    case 2:
      return launch_round<2>(values, columns, offsets, widths, h, x, x_prev,
                             y, inv_d, out, n_slices, n, B, y_stride,
                             d_stride, a, c0, w, s, gx, gy, st);
    case 1:
      return launch_round<1>(values, columns, offsets, widths, h, x, x_prev,
                             y, inv_d, out, n_slices, n, B, y_stride,
                             d_stride, a, c0, w, s, gx, gy, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
