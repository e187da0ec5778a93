// Fused Chebyshev step for Hopper: one order of Algorithm 1 after the
// SpMV pt = P t_{k-1},
//
//     t_k   = (2/alpha) pt - 2 t_{k-1} - t_{k-2}
//     acc_j += c_{j,k} t_k            for every multiplier j < eta,
//
// on (B, n) iterates and a (B, eta, n) accumulator.
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

__global__ void __launch_bounds__(kThreads)
cheb_step_kernel(const float* __restrict__ pt, const float* __restrict__ t1,
                 const float* __restrict__ t2, const float* __restrict__ acc,
                 const float* __restrict__ coef, float* __restrict__ tk_out,
                 float* __restrict__ acc_out, long long n, long long total,
                 int eta, float two_over_alpha) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = e / n, i = e % n;
    const float tk = two_over_alpha * pt[e] - 2.f * t1[e] - t2[e];
    tk_out[e] = tk;
    const long long base = b * eta * n + i;
    for (int j = 0; j < eta; ++j)
      acc_out[base + j * n] = acc[base + j * n] + coef[j] * tk;
  }
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
  const long long total = B * n;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  cheb_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pt), static_cast<const float*>(t1),
      static_cast<const float*>(t2), static_cast<const float*>(acc),
      static_cast<const float*>(coef), static_cast<float*>(tk_out),
      static_cast<float*>(acc_out), n, total, eta, two_over_alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
