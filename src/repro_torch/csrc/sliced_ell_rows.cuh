// What cheb_step.cu and jacobi_step.cu share.
//
// 1. Their stand-alone instances' 16-byte accesses: a Pack of V elements
//    (4 floats or 2 doubles) is one vector load or store where the
//    wrapper has checked that n % V == 0 and that every pointer is
//    16-byte aligned (kernels/cheb_step.py::vector_launch); V = 1
//    otherwise.
//
// 2. Their fused instances' row product: one warp's product of a 32-row
//    slice of a sliced-ELL matrix (core/graph.py::SlicedELL) with a tile
//    of TB signals in the caller's (B, n) row-major layout, left in the
//    thread's registers for the elementwise update that follows it in the
//    same thread, so the product of P never reaches memory.  It is the
//    row product of sliced_ell_spmv.cu, in the same order: the lanes of a
//    warp own the 32 rows of a slice; a slot is 32 consecutive values and
//    32 consecutive columns, one 128-byte load each, reused for the TB
//    signals of the tile; each row is summed by one thread in increasing
//    column order with f32 FFMA (no tensor core, so no TF32), so P x has
//    the stand-alone SpMV's bits.  The padding past a row's last entry is
//    value 0 at the row's own column.
//
//    The signals gathered here must not be written by the same launch:
//    the fused instances write their outputs into other buffers (t_k over
//    t_{k-2}, x_next over x_prev), never into the iterate that other
//    warps still gather.
#pragma once

#include <cuda_runtime.h>

namespace slice_rows {

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <int V, typename T>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <int V, typename T>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& x) {
  *reinterpret_cast<Pack<T, V>*>(p) = x;
}

constexpr int kWarps = 4;  // slices (warps) per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGridY = 65535;

// p[t] = sum_j A[row, col_j] x[b0 + t, col_j] for t < nb (the rest 0),
// where v / c point at the lane's first value / column of its slice and
// xb at signal b0's row.
template <int TB>
__device__ __forceinline__ void slice_product(const float* __restrict__ v,
                                              const int* __restrict__ c,
                                              int width,
                                              const float* __restrict__ xb,
                                              long long n_cols, int nb,
                                              float (&p)[TB]) {
#pragma unroll
  for (int t = 0; t < TB; ++t) p[t] = 0.f;
  if (nb == TB) {
#pragma unroll 2
    for (int j = 0; j < width; ++j) {
      const float a = v[32 * j];
      const long long col = c[32 * j];
#pragma unroll
      for (int t = 0; t < TB; ++t) p[t] = fmaf(a, xb[t * n_cols + col], p[t]);
    }
  } else {  // the ragged last tile of signals
    for (int j = 0; j < width; ++j) {
      const float a = v[32 * j];
      const long long col = c[32 * j];
#pragma unroll
      for (int t = 0; t < TB; ++t)
        if (t < nb) p[t] = fmaf(a, xb[t * n_cols + col], p[t]);
    }
  }
}

}  // namespace slice_rows
