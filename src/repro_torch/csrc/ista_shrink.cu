// Fused ISTA step with shrinkage for Hopper — Algorithm 3 lines 5-7:
//
//     z   = a + gamma (phi_y - gram_a)
//     out = sign(z) max(|z| - t, 0)
//
// on (R, eta, n) coefficient tensors (R = the product of any leading batch
// dims; f32, and an f64 instance for float64 reference plans), with a
// threshold t read through strides so that every form of the lasso
// weights reaches the kernel without being expanded: per scale
// (eta, 1), per signal and scale (R, eta, 1) — column stride 0 — or per
// vertex (R, eta, n) / (eta, n) — column stride 1; a batch stride of 0
// shares one (eta, .) table across the batch.
//
// Replaces: src/repro/kernels/soft_threshold.py::ista_shrink.
//
// What bounds it on this card: bytes.  Per element it reads three
// coefficient tensors and writes one (16 bytes, plus 4 for a per-vertex
// threshold) for about 6 FLOPs.
//
// What the design does about it: one pass, one thread per element,
// neighbouring threads on neighbouring vertices, so every stream is
// coalesced; a per-row threshold is one broadcast load per warp.  It takes
// any n and any leading batch (the TPU kernel took a single (eta, n) tile
// with n % 128 == 0).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ista_shrink_kernel(const T* __restrict__ a, const T* __restrict__ phi_y,
                   const T* __restrict__ gram, const T* __restrict__ thresh,
                   T* __restrict__ out, long long n, long long total, int eta,
                   long long t_batch_stride, long long t_row_stride,
                   long long t_col_stride, T gamma) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = e / n, i = e % n;
    const long long b = row / eta, j = row % eta;
    const T t =
        thresh[b * t_batch_stride + j * t_row_stride + i * t_col_stride];
    const T z = a[e] + gamma * (phi_y[e] - gram[e]);
    // sign(z) as jnp.sign: 0 at 0, NaN for NaN (fmax would drop a NaN)
    const T sg = z > T(0) ? T(1) : (z < T(0) ? T(-1) : z);
    out[e] = sg * fmax(fabs(z) - t, T(0));
  }
}

template <typename T>
int launch(const void* a, const void* phi_y, const void* gram,
           const void* thresh, void* out, long long R, int eta, long long n,
           long long t_batch_stride, long long t_row_stride,
           long long t_col_stride, T gamma, void* stream) {
  const long long total = R * eta * n;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  ista_shrink_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(phi_y),
      static_cast<const T*>(gram), static_cast<const T*>(thresh),
      static_cast<T*>(out), n, total, eta, t_batch_stride, t_row_stride,
      t_col_stride, gamma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a, phi_y, gram, out: (R, eta, n) contiguous; thresh element (b, j, i) at
// b * t_batch_stride + j * t_row_stride + i * t_col_stride.  Returns the
// launch's cudaError_t.  The f64 entry serves float64 reference plans on
// the card.
int ista_shrink_f32(const void* a, const void* phi_y, const void* gram,
                    const void* thresh, void* out, long long R, int eta,
                    long long n, long long t_batch_stride,
                    long long t_row_stride, long long t_col_stride,
                    float gamma, void* stream) {
  return launch<float>(a, phi_y, gram, thresh, out, R, eta, n,
                       t_batch_stride, t_row_stride, t_col_stride, gamma,
                       stream);
}

int ista_shrink_f64(const void* a, const void* phi_y, const void* gram,
                    const void* thresh, void* out, long long R, int eta,
                    long long n, long long t_batch_stride,
                    long long t_row_stride, long long t_col_stride,
                    double gamma, void* stream) {
  return launch<double>(a, phi_y, gram, thresh, out, R, eta, n,
                        t_batch_stride, t_row_stride, t_col_stride, gamma,
                        stream);
}

}  // extern "C"
