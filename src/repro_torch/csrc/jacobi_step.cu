// Fused (accelerated-)Jacobi update for Hopper: one round of the
// Section-V solvers after the matvec qx = Q x,
//
//     x_next = w (x + inv_d (y - qx)) - s x_prev,
//
// with w = 1, s = 0 the plain Jacobi round (Eq. (24)) and the per-round
// Chebyshev-accelerated weights of Eq. (25) otherwise, on (B, n) iterates.
// y and inv_d are either batched (B, n) or one (n,) row shared by the
// whole batch (row stride 0).
//
// Replaces: src/repro/kernels/jacobi_step.py::jacobi_step.
//
// What bounds it on this card: bytes.  Per element it reads qx, x, x_prev
// (and y, inv_d when batched) and writes x_next: 16 to 24 bytes for 5
// FLOPs, far below the card's ~20 FLOP/byte balance point.
//
// What the design does about it: one pass, one thread per (signal,
// vertex), neighbouring threads on neighbouring vertices, so every load
// and store is coalesced; a shared (n,) row of y or inv_d is read by every
// signal from the L2.  It takes any n and masks the ragged edge (the TPU
// kernel padded to the 128-lane width).  w and s are scalars passed per
// launch (the TPU kernel read them from a (2, 1) operand so that one trace
// served every round of a scan).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
jacobi_step_kernel(const T* __restrict__ qx, const T* x, const T* x_prev,
                   const T* __restrict__ y, const T* __restrict__ inv_d,
                   T* out, long long n, long long total, long long y_stride,
                   long long d_stride, T w, T s) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = e / n, i = e % n;
    const T xv = x[e];
    const T r = y[b * y_stride + i] - qx[e];
    out[e] = w * (xv + inv_d[b * d_stride + i] * r) - s * x_prev[e];
  }
}

template <typename T>
int launch(const void* qx, const void* x, const void* x_prev, const void* y,
           const void* inv_d, void* out, long long B, long long n,
           long long y_stride, long long d_stride, T w, T s, void* stream) {
  const long long total = B * n;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  jacobi_step_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qx), static_cast<const T*>(x),
      static_cast<const T*>(x_prev), static_cast<const T*>(y),
      static_cast<const T*>(inv_d), static_cast<T*>(out), n, total,
      y_stride, d_stride, w, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// qx, x, x_prev, out: (B, n); y: (B, n) with y_stride = n or (n,) with
// y_stride = 0; inv_d likewise with d_stride.  x_prev may alias x (the
// plain Jacobi round passes the iterate twice).  Returns the launch's
// cudaError_t.  The f64 entry serves float64 reference plans on the card.
int jacobi_step_f32(const void* qx, const void* x, const void* x_prev,
                    const void* y, const void* inv_d, void* out, long long B,
                    long long n, long long y_stride, long long d_stride,
                    float w, float s, void* stream) {
  return launch<float>(qx, x, x_prev, y, inv_d, out, B, n, y_stride,
                       d_stride, w, s, stream);
}

int jacobi_step_f64(const void* qx, const void* x, const void* x_prev,
                    const void* y, const void* inv_d, void* out, long long B,
                    long long n, long long y_stride, long long d_stride,
                    double w, double s, void* stream) {
  return launch<double>(qx, x, x_prev, y, inv_d, out, B, n, y_stride,
                        d_stride, w, s, stream);
}

}  // extern "C"
