// One (row block x batch tile) of a Block-ELL SpMV, shared by the
// per-order SpMV kernel (block_ell_spmv.cu) and the whole-recurrence
// sweep (cheb_sweep.cu).
//
// Layout: blocks (nrb, slots, br, bc) f32, indices (nrb, slots) int32,
// iterate src (B, ncols) f32 row-major (ncols = ncb * bc).  Padded slots
// hold zero blocks at column block 0, so reading them stays in bounds and
// adds zero.
//
// A thread block of kThreads threads owns row block `rb` and the batch
// rows [b0, b0 + NB * (kThreads / br)).  Thread t computes rows
// r = t % br of the batch rows bl + i * (kThreads / br), i < NB, with
// bl = t / br, so neighbouring threads hold neighbouring output rows of
// one signal: a warp stores whole 32-byte sectors.  Per slot the block
// stages the (br, bc) matrix block and the (TB, bc) iterate tile in shared
// memory (row stride bc + 1, so the column walk is free of bank
// conflicts) and every thread runs bc f32 FMAs per output in registers.
// Plain FFMA: no tensor core, so no TF32 rounding.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;

// Shared memory in bytes for one tile: the matrix block and the iterate
// tile, both with padded rows.
inline size_t tile_smem_bytes(int br, int bc, int tb) {
  return sizeof(float) * static_cast<size_t>(br + tb) * (bc + 1);
}

template <int NB>
__device__ __forceinline__ void spmv_tile(
    const float* __restrict__ blocks, const int* __restrict__ indices,
    const float* src, int slots, int br, int bc, long long ncols, int B,
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
    const float* blk = blocks + slot * br * bc;
    __syncthreads();  // the previous slot's tiles are no longer read
    for (int e = tid; e < br * bc; e += kThreads)
      As[(e / bc) * ld + e % bc] = blk[e];
    for (int e = tid; e < tb * bc; e += kThreads) {
      const int bb = e / bc, j = e % bc;
      const int b = b0 + bb;
      Xs[bb * ld + j] = b < B ? src[b * ncols + col0 + j] : 0.f;
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
