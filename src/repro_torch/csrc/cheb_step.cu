// Chebyshev step for Hopper: one order of Algorithm 1,
//
//     t_k   = (2/alpha) P t_{k-1} - 2 t_{k-1} - t_{k-2}
//     acc_j += c_{j,k} t_k            for every multiplier j < eta,
//
// on (B, n) iterates and a (B, eta, n) accumulator, in two instances.
//
// Replaces: src/repro/kernels/cheb_step.py::cheb_step.
//
// 1. The stand-alone instance (cheb_step_f32 / _f64) takes pt = P t_{k-1}
//    from outside: an opaque matvec (the sharded exchange, gossip) forms
//    it.  f32, and f64 for float64 reference plans on the card.
// 2. The order instance (cheb_order_f32) fuses the sliced-ELL row product
//    of t_{k-1} (sliced_ell_rows.cuh) with the update: pt stays in the
//    thread's registers and never reaches memory, and one launch runs one
//    order.  Its first mode runs order 1 from the signal x,
//        t_1 = P x / alpha - x,   acc_j = c_{j,0} / 2 x + c_{j,1} t_1,
//    so the per-order path is K launches and no other op.
//
// What bounds them on this card: bytes.  The stand-alone update reads
// three iterates and eta accumulator values and writes t_k and eta
// accumulator values per element, (4 + 2 eta) * 4 bytes for 2 + 2 eta
// FLOPs; the order instance reads the layout (value and column, 8 bytes
// per stored entry) and two iterates in place of three: nnz * 8 +
// (3 + 2 eta) B n * 4 bytes.  Both sit far below the card's ~20 FLOP/byte
// balance point.
//
// What the design does about it:
//   - stand-alone: a 2-D grid of (vertex tiles, signals), so no 64-bit
//     division per element; 16-byte accesses (four floats, two doubles)
//     where the wrapper found n a multiple of the pack and every pointer
//     16-byte aligned, one element a thread otherwise; eta coefficients
//     staged in shared memory once per block;
//   - order instance: the warp-per-slice product of sliced_ell_spmv.cu
//     for a tile of TB signals, then, in the same thread, the update of
//     those TB signals at the lane's row: every store of t_k and acc is a
//     coalesced 128-byte line of 32 rows; t_k is written over t_{k-2}
//     (read by this thread alone), never over t_{k-1}, which other warps
//     still gather; acc is updated in place;
//   - outputs may alias inputs (the per-order loops rotate two buffers and
//     keep one accumulator), so no operand that may alias an output is
//     declared __restrict__.
// Each element of t_k and acc is written by the thread that reads it, so
// in-place updates need no synchronisation.  The order instance takes
// eta <= 4096 (its coefficients fit 32 KiB of shared memory in the first
// mode, which stages c_0 and c_1).
#include "sliced_ell_rows.cuh"

namespace {

using slice_rows::load_pack;
using slice_rows::Pack;
using slice_rows::store_pack;

constexpr int kThreads = 256;  // stand-alone: threads per block
constexpr int kChunk = 4;      // stand-alone: accumulator rows in flight
constexpr int kOrderChunk = 8;  // order instance: the same

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
cheb_step_kernel(const T* pt, const T* t1, const T* t2, const T* acc,
                 const T* __restrict__ coef, T* tk_out, T* acc_out,
                 long long n, long long B, int eta, T two_over_alpha) {
  extern __shared__ unsigned char smem[];
  T* s_coef = reinterpret_cast<T*>(smem);
  for (int j = threadIdx.x; j < eta; j += blockDim.x) s_coef[j] = coef[j];
  __syncthreads();
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (i >= n) return;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const long long e = b * n + i;
    const Pack<T, V> p = load_pack<V>(pt + e);
    const Pack<T, V> a = load_pack<V>(t1 + e);
    const Pack<T, V> c = load_pack<V>(t2 + e);
    Pack<T, V> tk;
#pragma unroll
    for (int v = 0; v < V; ++v)
      tk.v[v] = two_over_alpha * p.v[v] - T(2) * a.v[v] - c.v[v];
    store_pack<V>(tk_out + e, tk);
    // kChunk accumulator rows in flight at once: acc_out may alias acc,
    // so the compiler cannot hoist a load above the previous row's store
    const long long base = b * eta * n + i;
    for (int j0 = 0; j0 < eta; j0 += kChunk) {
      Pack<T, V> r[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        if (j0 + u < eta) r[u] = load_pack<V>(acc + base + (j0 + u) * n);
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (j0 + u >= eta) break;
#pragma unroll
        for (int v = 0; v < V; ++v)
          r[u].v[v] = r[u].v[v] + s_coef[j0 + u] * tk.v[v];
        store_pack<V>(acc_out + base + (j0 + u) * n, r[u]);
      }
    }
  }
}

template <typename T>
int launch_step(const void* pt, const void* t1, const void* t2,
                const void* acc, const void* coef, void* tk_out,
                void* acc_out, long long B, long long n, int eta,
                T two_over_alpha, int vec, unsigned gx, unsigned gy,
                void* stream) {
  const dim3 grid(gx, gy);
  const size_t smem = sizeof(T) * eta;
  auto s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(pt), static_cast<const T*>(t1),
        static_cast<const T*>(t2), static_cast<const T*>(acc),
        static_cast<const T*>(coef), static_cast<T*>(tk_out),
        static_cast<T*>(acc_out), n, B, eta, two_over_alpha);
  };
  constexpr int kPack = static_cast<int>(16 / sizeof(T));
  if (vec == kPack)
    args(cheb_step_kernel<T, kPack>);
  else if (vec == 1)
    args(cheb_step_kernel<T, 1>);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// One order on a sliced-ELL P.  FIRST: t1 is x, t2 is not read, coef holds
// c_0 then c_1 (2 eta values) and acc_in is not read.
template <int TB, bool FIRST>
__global__ void __launch_bounds__(slice_rows::kThreads)
cheb_order_kernel(const float* __restrict__ values,
                  const int* __restrict__ columns,
                  const int* __restrict__ offsets,
                  const int* __restrict__ widths,
                  const float* __restrict__ t1, const float* t2, float* tk,
                  const float* acc_in, float* acc_out,
                  const float* __restrict__ coef, int n_slices, long long n,
                  int B, int eta, float scale) {
  extern __shared__ float s_coef[];
  for (int j = threadIdx.x; j < (FIRST ? 2 : 1) * eta; j += blockDim.x)
    s_coef[j] = coef[j];
  __syncthreads();
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
    slice_rows::slice_product<TB>(v, c, width, t1 + b0 * n, n, nb, p);
    if (row >= n) continue;
    // every load of the tile's iterates first (t_k may alias t_{k-2}),
    // then the stores, then the accumulator rows kOrderChunk at a time
    float xv[TB], tkv[TB];
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      if (t >= nb) break;
      const long long e = (b0 + t) * n + row;
      xv[t] = t1[e];
      tkv[t] = FIRST ? scale * p[t] - xv[t]
                     : scale * p[t] - 2.f * xv[t] - t2[e];
    }
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      if (t >= nb) break;
      tk[(b0 + t) * n + row] = tkv[t];
    }
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      if (t >= nb) break;
      const long long base =
          (b0 + t) * static_cast<long long>(eta) * n + row;
      for (int j0 = 0; j0 < eta; j0 += kOrderChunk) {
        float r[kOrderChunk];
        if (!FIRST) {
#pragma unroll
          for (int u = 0; u < kOrderChunk; ++u)
            if (j0 + u < eta) r[u] = acc_in[base + (j0 + u) * n];
        }
#pragma unroll
        for (int u = 0; u < kOrderChunk; ++u) {
          if (j0 + u >= eta) break;
          const int j = j0 + u;
          acc_out[base + j * n] =
              FIRST ? 0.5f * s_coef[j] * xv[t] + s_coef[eta + j] * tkv[t]
                    : r[u] + s_coef[j] * tkv[t];
        }
      }
    }
  }
}

template <int TB>
int launch_order(const void* values, const void* columns,
                 const void* offsets, const void* widths, const void* t1,
                 const void* t2, void* tk, const void* acc_in, void* acc_out,
                 const void* coef, int n_slices, long long n, int B, int eta,
                 float scale, int first, unsigned gx, unsigned gy,
                 cudaStream_t s) {
  const dim3 grid(gx, gy);
  const size_t smem = sizeof(float) * (first ? 2 : 1) * eta;
  auto args = [&](auto kernel) {
    kernel<<<grid, slice_rows::kThreads, smem, s>>>(
        static_cast<const float*>(values), static_cast<const int*>(columns),
        static_cast<const int*>(offsets), static_cast<const int*>(widths),
        static_cast<const float*>(t1), static_cast<const float*>(t2),
        static_cast<float*>(tk), static_cast<const float*>(acc_in),
        static_cast<float*>(acc_out), static_cast<const float*>(coef),
        n_slices, n, B, eta, scale);
  };
  if (first)
    args(cheb_order_kernel<TB, true>);
  else
    args(cheb_order_kernel<TB, false>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The stand-alone instance.  pt, t1, t2, tk_out: (B, n); acc, acc_out:
// (B, eta, n); coef: (eta,).  tk_out may alias t2 (or pt), acc_out may
// alias acc.  vec: elements per access (16 / sizeof(T), or 1); grid
// (gx, gy) = (vertex tiles of 256 * vec, signals up to 65535), from
// kernels/cheb_step.py::vector_launch.  Returns the launch's cudaError_t.
int cheb_step_f32(const void* pt, const void* t1, const void* t2,
                  const void* acc, const void* coef, void* tk_out,
                  void* acc_out, long long B, long long n, int eta,
                  float two_over_alpha, int vec, unsigned gx, unsigned gy,
                  void* stream) {
  return launch_step<float>(pt, t1, t2, acc, coef, tk_out, acc_out, B, n,
                            eta, two_over_alpha, vec, gx, gy, stream);
}

int cheb_step_f64(const void* pt, const void* t1, const void* t2,
                  const void* acc, const void* coef, void* tk_out,
                  void* acc_out, long long B, long long n, int eta,
                  double two_over_alpha, int vec, unsigned gx, unsigned gy,
                  void* stream) {
  return launch_step<double>(pt, t1, t2, acc, coef, tk_out, acc_out, B, n,
                             eta, two_over_alpha, vec, gx, gy, stream);
}

// The order instance on a square sliced-ELL layout (core/graph.py::
// SlicedELL: values / columns (stored,), offsets / widths (n_slices,)).
// t1, t2, tk: (B, n); acc_in, acc_out: (B, eta, n).  first = 0: order
// k >= 2, coef = c_k (eta,), scale = 2 / alpha; tk may alias t2, acc_out
// may alias acc_in, and neither may alias t1.  first = 1: order 1 from
// t1 = x, coef = (c_0, c_1) (2 eta), scale = 1 / alpha; t2 and acc_in are
// not read.  tb: signals per thread (8, 2 or 1); grid (gx, gy) = (groups
// of 4 slices, signal tiles up to 65535), from kernels/cheb_step.py::
// slice_launch.  Returns the launch's cudaError_t.
int cheb_order_f32(const void* values, const void* columns,
                   const void* offsets, const void* widths, const void* t1,
                   const void* t2, void* tk, const void* acc_in,
                   void* acc_out, const void* coef, int n_slices, long long n,
                   int B, int eta, float scale, int first, int tb,
                   unsigned gx, unsigned gy, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (tb) {
    case 8:
      return launch_order<8>(values, columns, offsets, widths, t1, t2, tk,
                             acc_in, acc_out, coef, n_slices, n, B, eta,
                             scale, first, gx, gy, s);
    case 2:
      return launch_order<2>(values, columns, offsets, widths, t1, t2, tk,
                             acc_in, acc_out, coef, n_slices, n, B, eta,
                             scale, first, gx, gy, s);
    case 1:
      return launch_order<1>(values, columns, offsets, widths, t1, t2, tk,
                             acc_in, acc_out, coef, n_slices, n, B, eta,
                             scale, first, gx, gy, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
