// One (row block x batch tile) of a Block-ELL SpMV, shared by the
// per-order SpMV kernel (block_ell_spmv.cu) and the whole-iteration
// sweeps (cheb_sweep.cu, jacobi_sweep.cu).
//
// Layout: blocks (nrb, slots, br, bc), indices (nrb, slots) int32,
// iterate src (B, ncols) row-major (ncols = ncb * bc).  Padded slots
// hold zero blocks at column block 0, so reading them stays in bounds and
// adds zero.
//
// A thread block of kThreads threads owns row block `rb` and the batch
// rows [b0, b0 + NB * (kThreads / br)).  Thread t computes rows
// r = t % br of the batch rows bl + i * (kThreads / br), i < NB, with
// bl = t / br, so neighbouring threads hold neighbouring output rows of
// one signal: a warp stores whole 32-byte sectors.  Per slot the block
// stages the (br, bc) matrix block and the (tb, bc) iterate tile in shared
// memory (row stride bc + 1, so the column walk is free of bank
// conflicts) and every thread runs bc f32 FMAs per output in registers.
// Plain FFMA: no tensor core, so no TF32 rounding.
//
// Element types: the blocks (TB) and the iterate (TS) are float or
// __nv_bfloat16 (the sweeps' bf16 scratch mode).  Either is widened to
// f32 as it is staged, so shared memory, the FMAs and the sum are f32 in
// every instance; in the f32 instance the widening is the identity.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Store a f32 value in element type T (round to nearest even for bf16).
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The value a f32 number takes once stored in T.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

constexpr int kThreads = 256;

// Shared memory in bytes for one tile: the matrix block and the iterate
// tile, both with padded rows.
inline size_t tile_smem_bytes(int br, int bc, int tb) {
  return sizeof(float) * static_cast<size_t>(br + tb) * (bc + 1);
}

template <int NB, typename TB = float, typename TS = float>
__device__ __forceinline__ void spmv_tile(
    const TB* __restrict__ blocks, const int* __restrict__ indices,
    const TS* src, int slots, int br, int bc, long long ncols, int B,
    int rb, int b0, float* smem, float (&y)[NB]) {
  const int tid = threadIdx.x;
  const int per_pass = kThreads / br;
  const int tb = NB * per_pass;
  const int r = tid % br;
  const int bl = tid / br;
  const int ld = bc + 1;
  float* As = smem;            // (br, bc + 1)
  float* Xs = smem + br * ld;  // (tb, bc + 1)
#pragma unroll
  for (int i = 0; i < NB; ++i) y[i] = 0.f;
  for (int s = 0; s < slots; ++s) {
    const long long slot = static_cast<long long>(rb) * slots + s;
    const long long col0 = static_cast<long long>(indices[slot]) * bc;
    const TB* blk = blocks + slot * br * bc;
    __syncthreads();  // the previous slot's tiles are no longer read
    for (int e = tid; e < br * bc; e += kThreads)
      As[(e / bc) * ld + e % bc] = to_f32(blk[e]);
    for (int e = tid; e < tb * bc; e += kThreads) {
      const int bb = e / bc, j = e % bc;
      const int b = b0 + bb;
      Xs[bb * ld + j] = b < B ? to_f32(src[b * ncols + col0 + j]) : 0.f;
    }
    __syncthreads();
    const float* a_row = As + r * ld;
    for (int j = 0; j < bc; ++j) {
      const float a = a_row[j];
#pragma unroll
      for (int i = 0; i < NB; ++i)
        y[i] = fmaf(a, Xs[(bl + i * per_pass) * ld + j], y[i]);
    }
  }
}

}  // namespace repro
