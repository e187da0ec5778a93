// What the two whole-iteration sweeps (cheb_sweep.cu, jacobi_sweep.cu)
// share: one warp's product of a 32-row slice of a sliced-ELL matrix
// (core/graph.py::SlicedELL) with a tile of TB signals, the signal-minor
// layout of the iterates the sweeps keep in their own scratch, and the
// fixed walk of the work items that lets them rotate buffers in place.
//
// Layout of a scratch iterate: (n_tiles, n, TB), signal tile bt and row r
// at ((bt * n + r) * TB), the TB signals b = bt * TB + t contiguous.  A
// gather of one column for a tile is then one vector load of TB values
// (32 bytes at TB = 8 in f32: one sector), where the caller's (B, n)
// layout takes TB loads of one word, a sector each.  The
// padded signals of a ragged last tile (b >= B) hold zeros.
//
// Caller-layout operands (x, b, x0, inv_d, the outputs) are (B, n): lanes
// own consecutive rows, so every read or write of one signal's rows by a
// warp is one coalesced 128-byte access.
//
// Element types: T is float or __nv_bfloat16 (the sweeps' bf16 scratch
// mode); either is widened to f32 as it is loaded, and every sum is f32.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kWarps = 8;  // slices (warps) per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kSliceRows = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The value an f32 number takes once stored in T (round to nearest even
// for bf16).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 32-bit words of T: elements per word, widening and packing (of values
// already rounded to T, so packing a bf16 keeps its upper half).
template <typename T>
struct Word;
template <>
struct Word<float> {
  static constexpr int kPer = 1;
  static __device__ void widen(unsigned w, float* v) {
    v[0] = __uint_as_float(w);
  }
  static __device__ unsigned pack(const float* v) {
    return __float_as_uint(v[0]);
  }
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int kPer = 2;
  static __device__ void widen(unsigned w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ unsigned pack(const float* v) {
    return (__float_as_uint(v[0]) >> 16) |
           (__float_as_uint(v[1]) & 0xffff0000u);
  }
};

// TB values of a signal-minor row, widened to f32, in 16-byte (or 8- or
// 4-byte) vector accesses.  Plain loads, not the read-only path: other
// blocks of the same launch write the iterates.
template <typename T, int TB>
__device__ __forceinline__ void load_row(const T* p, float (&v)[TB]) {
  constexpr int kWords = TB / Word<T>::kPer;
  unsigned w[kWords];
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 c = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = c.x, w[4 * i + 1] = c.y, w[4 * i + 2] = c.z,
      w[4 * i + 3] = c.w;
    }
  } else if constexpr (kWords == 2) {
    const uint2 c = *reinterpret_cast<const uint2*>(p);
    w[0] = c.x, w[1] = c.y;
  } else {
    static_assert(kWords == 1, "TB must fill 4, 8 or a multiple of 16 B");
    w[0] = *reinterpret_cast<const unsigned*>(p);
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) Word<T>::widen(w[i], v + i * Word<T>::kPer);
}

// Store TB values (already rounded to T) to a signal-minor row.
template <typename T, int TB>
__device__ __forceinline__ void store_row(T* p, const float (&v)[TB]) {
  constexpr int kWords = TB / Word<T>::kPer;
  unsigned w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) w[i] = Word<T>::pack(v + i * Word<T>::kPer);
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else if constexpr (kWords == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<unsigned*>(p) = w[0];
  }
}

// Gathers for the slice SpMV: column col of a tile of TB signals.
// Signal-minor scratch (base = buffer + bt * n * TB): one vector load.
template <typename T, int TB>
struct MinorRows {
  const T* base;
  __device__ __forceinline__ void operator()(long long col,
                                             float (&v)[TB]) const {
    load_row<T, TB>(base + col * TB, v);
  }
};

// The caller's f32 (B, n) layout (base = x + b0 * n), nb live signals,
// each value rounded to T as it is read (bf16 mode reads x as bf16).
template <typename T, int TB>
struct CallerRows {
  const float* base;
  long long n;
  int nb;
  __device__ __forceinline__ void operator()(long long col,
                                             float (&v)[TB]) const {
#pragma unroll
    for (int t = 0; t < TB; ++t)
      v[t] = t < nb ? round_to<T>(base[t * n + col]) : 0.f;
  }
};

// y[t] = sum_j a_j src[t][c_j] over the lane's row of one slice, in slot
// (increasing column) order: one coalesced load of 32 values and one of
// 32 columns per slot, each (value, column) pair reused for TB signals.
// TV is the values' type (float, or the layout's bf16 copy).
template <int TB, typename TV, typename Src>
__device__ __forceinline__ void slice_spmv(const TV* __restrict__ values,
                                           const int* __restrict__ columns,
                                           int off, int width, int lane,
                                           const Src& src, float (&y)[TB]) {
#pragma unroll
  for (int t = 0; t < TB; ++t) y[t] = 0.f;
  const TV* v = values + off + lane;
  const int* c = columns + off + lane;
#pragma unroll 4
  for (int j = 0; j < width; ++j) {
    const float a = to_f32(v[kSliceRows * j]);
    float xs[TB];
    src(static_cast<long long>(c[kSliceRows * j]), xs);
#pragma unroll
    for (int t = 0; t < TB; ++t) y[t] = fmaf(a, xs[t], y[t]);
  }
}

// The fixed walk: warp w of the grid takes items w, w + W, ... (W warps
// in all) of n_slices * n_tiles, item i = (slice i % n_slices, tile
// i / n_slices), so neighbouring warps read neighbouring slices of one
// tile (their gathers share L1 lines) and every phase of a launch gives
// each warp the same rows.
struct Walk {
  long long warp, n_warps, items;
  __device__ Walk(int n_slices, int n_tiles)
      : warp(static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32),
        n_warps(static_cast<long long>(gridDim.x) * kWarps),
        items(static_cast<long long>(n_slices) * n_tiles) {}
};

// Co-resident grid size for a cooperative launch of `kernel` with
// kThreads threads and no shared memory: occupancy x SM count, at most
// enough blocks for the items.  Returns a cudaError_t.
template <typename Kernel>
int coop_grid(Kernel kernel, long long items, int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return static_cast<int>(err);
  long long g = static_cast<long long>(per_sm) * sms;
  const long long need = (items + kWarps - 1) / kWarps;
  if (g > need) g = need;
  *grid = static_cast<int>(g);
  return 0;
}

}  // namespace repro
