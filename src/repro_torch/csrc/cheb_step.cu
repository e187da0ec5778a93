// Fused Chebyshev step for Hopper: one order of Algorithm 1 after the
// SpMV pt = P t_{k-1},
//
//     t_k   = (2/alpha) pt - 2 t_{k-1} - t_{k-2}
//     acc_j += c_{j,k} t_k            for every multiplier j < eta,
//
// on (B, n) iterates and a (B, eta, n) accumulator (f32; an f64 instance
// serves float64 reference plans on the card).
//
// Replaces: src/repro/kernels/cheb_step.py::cheb_step.
//
// What bounds it on this card: bytes.  Per element it reads three
// iterates and eta accumulator values and writes t_k and eta accumulator
// values, (4 + 2 eta) * 4 bytes for 2 + 2 eta FLOPs, far below the
// card's ~20 FLOP/byte balance point.
//
// What the design does about it: one pass, one thread per (signal,
// vertex), neighbouring threads on neighbouring vertices, so every load
// and store is coalesced; t_k stays in a register for the eta
// accumulator updates.  It takes any n and masks the ragged edge (the TPU
// kernel padded to the 128-lane width; there is no such tile here).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cheb_step_kernel(const T* __restrict__ pt, const T* __restrict__ t1,
                 const T* __restrict__ t2, const T* __restrict__ acc,
                 const T* __restrict__ coef, T* __restrict__ tk_out,
                 T* __restrict__ acc_out, long long n, long long total,
                 int eta, T two_over_alpha) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = e / n, i = e % n;
    const T tk = two_over_alpha * pt[e] - T(2) * t1[e] - t2[e];
    tk_out[e] = tk;
    const long long base = b * eta * n + i;
    for (int j = 0; j < eta; ++j)
      acc_out[base + j * n] = acc[base + j * n] + coef[j] * tk;
  }
}

template <typename T>
int launch(const void* pt, const void* t1, const void* t2, const void* acc,
           const void* coef, void* tk_out, void* acc_out, long long B,
           long long n, int eta, T two_over_alpha, void* stream) {
  const long long total = B * n;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  cheb_step_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pt), static_cast<const T*>(t1),
      static_cast<const T*>(t2), static_cast<const T*>(acc),
      static_cast<const T*>(coef), static_cast<T*>(tk_out),
      static_cast<T*>(acc_out), n, total, eta, two_over_alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pt, t1, t2, tk_out: (B, n); acc, acc_out: (B, eta, n); coef: (eta,).
// Returns the launch's cudaError_t.
int cheb_step_f32(const void* pt, const void* t1, const void* t2,
                  const void* acc, const void* coef, void* tk_out,
                  void* acc_out, long long B, long long n, int eta,
                  float two_over_alpha, void* stream) {
  return launch<float>(pt, t1, t2, acc, coef, tk_out, acc_out, B, n, eta,
                       two_over_alpha, stream);
}

int cheb_step_f64(const void* pt, const void* t1, const void* t2,
                  const void* acc, const void* coef, void* tk_out,
                  void* acc_out, long long B, long long n, int eta,
                  double two_over_alpha, void* stream) {
  return launch<double>(pt, t1, t2, acc, coef, tk_out, acc_out, B, n, eta,
                        two_over_alpha, stream);
}

}  // extern "C"
