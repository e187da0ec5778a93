// Fused ISTA step with shrinkage for Hopper — Algorithm 3 lines 5-7:
//
//     z   = a + gamma (phi_y - gram_a)
//     out = sign(z) max(|z| - t, 0)
//
// on (R, eta, n) coefficient tensors (R = the product of any leading batch
// dims; f32, and an f64 instance for float64 reference plans), with a
// threshold t read through strides so that every form of the lasso
// weights reaches the kernel without being expanded: per scale (eta, 1) or
// per signal and scale (R, eta, 1) — one value per row of R x eta — or per
// vertex (R, eta, n) / (eta, n); a batch stride of 0 shares one (eta, .)
// table across the batch.
//
// Replaces: src/repro/kernels/soft_threshold.py::ista_shrink.
//
// What bounds it on this card: bytes.  Per element it reads three
// coefficient tensors and writes one (16 bytes in f32, plus 4 for a
// per-vertex threshold) for about 6 FLOPs.
//
// What the design does about it:
//   - a 2-D grid of (vertex tiles, rows of R x eta), striding over the rows
//     beyond 65535: a row's batch and scale come from one 32-bit division
//     per row, never a 64-bit division or remainder per element;
//   - 16-byte accesses (four floats, two doubles) where the wrapper found n
//     a multiple of the pack and every pointer 16-byte aligned, one element
//     a thread otherwise (kernels/cheb_step.py::vector_launch); a per-vertex
//     threshold is one more stream of packs;
//   - a per-row threshold is one broadcast load per warp and row;
//   - out may alias a (the ISTA loops update their iterate in place): each
//     thread loads its packs before it stores them, and neither a nor out
//     is declared __restrict__.
// It takes any n and any leading batch (the TPU kernel took a single
// (eta, n) tile with n % 128 == 0).  Each element is computed by one
// thread from its own inputs, so two launches give the same bits.
#include "sliced_ell_rows.cuh"

// One launch's arguments, filled by the wrapper
// (kernels/soft_threshold.py::_ShrinkArgs, field for field): a, phi_y,
// gram, out (rows, n) contiguous, rows = R * eta < 2**31, out may be a;
// the threshold of row r = b eta + j starts at b * t_batch_stride + j *
// t_row_stride and is one value (per_vertex 0) or n (per_vertex 1); vec
// (1 or the 16-byte pack) and the grid (gx vertex tiles, gy rows) from
// kernels/cheb_step.py::vector_launch.  One pointer crosses from Python
// per launch, so the call costs the host little.
struct ShrinkArgs {
  const void* a;
  const void* phi_y;
  const void* gram;
  const void* thresh;
  void* out;
  void* stream;
  long long n;
  long long t_batch_stride;
  long long t_row_stride;
  double gamma;
  int rows;
  int eta;
  int per_vertex;
  int vec;
  unsigned gx;
  unsigned gy;
};

namespace {

using slice_rows::load_pack;
using slice_rows::Pack;
using slice_rows::store_pack;

constexpr int kThreads = 256;

template <typename T, int V, bool PER_VERTEX>
__global__ void __launch_bounds__(kThreads)
ista_shrink_kernel(const T* a, const T* __restrict__ phi_y,
                   const T* __restrict__ gram, const T* __restrict__ thresh,
                   T* out, long long n, int rows, int eta,
                   long long t_batch_stride, long long t_row_stride,
                   T gamma) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (i >= n) return;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int b = r / eta, j = r - b * eta;
    const T* t_row = thresh + b * t_batch_stride + j * t_row_stride;
    const long long e = static_cast<long long>(r) * n + i;
    const Pack<T, V> pa = load_pack<V>(a + e);
    const Pack<T, V> pp = load_pack<V>(phi_y + e);
    const Pack<T, V> pg = load_pack<V>(gram + e);
    Pack<T, V> pt;
    if (PER_VERTEX) {
      pt = load_pack<V>(t_row + i);
    } else {
      const T t = *t_row;
#pragma unroll
      for (int v = 0; v < V; ++v) pt.v[v] = t;
    }
    Pack<T, V> o;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const T z = pa.v[v] + gamma * (pp.v[v] - pg.v[v]);
      // sign(z) as jnp.sign: 0 at 0, NaN for NaN (fmax would drop a NaN)
      const T sg = z > T(0) ? T(1) : (z < T(0) ? T(-1) : z);
      o.v[v] = sg * fmax(fabs(z) - pt.v[v], T(0));
    }
    store_pack<V>(out + e, o);
  }
}

template <typename T>
int launch(const ShrinkArgs& p) {
  auto args = [&](auto kernel) {
    kernel<<<dim3(p.gx, p.gy), kThreads, 0,
             static_cast<cudaStream_t>(p.stream)>>>(
        static_cast<const T*>(p.a), static_cast<const T*>(p.phi_y),
        static_cast<const T*>(p.gram), static_cast<const T*>(p.thresh),
        static_cast<T*>(p.out), p.n, p.rows, p.eta, p.t_batch_stride,
        p.t_row_stride, static_cast<T>(p.gamma));
  };
  constexpr int kPack = static_cast<int>(16 / sizeof(T));
  if (p.vec == kPack && p.per_vertex)
    args(ista_shrink_kernel<T, kPack, true>);
  else if (p.vec == kPack)
    args(ista_shrink_kernel<T, kPack, false>);
  else if (p.vec == 1 && p.per_vertex)
    args(ista_shrink_kernel<T, 1, true>);
  else if (p.vec == 1)
    args(ista_shrink_kernel<T, 1, false>);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The f32 entry, and the f64 one for float64 reference plans on the
// card.  Each returns the launch's cudaError_t.
int ista_shrink_f32(const ShrinkArgs* p) { return launch<float>(*p); }

int ista_shrink_f64(const ShrinkArgs* p) { return launch<double>(*p); }

}  // extern "C"
