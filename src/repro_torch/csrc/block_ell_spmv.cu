// Block-ELL SpMV for Hopper: Y = A X^T on a (B, n) row-major batch of
// signals, one launch per matvec.
//
// Replaces: src/repro/kernels/bcsr_spmv.py::block_ell_spmv and
// ::block_ell_spmv_batched (one kernel here for any B >= 1; no
// (ncb, bc, B) transpose of the iterate is needed).
//
// What bounds it on this card: the bytes of the Block-ELL blocks.  Every
// (br, bc) block is streamed from device memory once per batch tile, and
// at the (8, 128) tile of a sensor graph most of each block is zero
// padding (2.3% fill at n = 16384), so the kernel moves and multiplies
// ~40x the non-zeros the product needs.  Inside the SM the FMA loop is
// bounded by shared-memory loads (two per FMA at NB = 1, 1.5 at NB = 2).
//
// What the design does about it: one thread block per (row block, batch
// tile of up to 64 signals) reads each block once for the whole tile,
// the way the TPU kernel amortised a block load over its (bc, B) tile;
// it loads its own column indices (no scalar prefetch on this card); the
// output rows of one signal are written by neighbouring threads, so
// stores are whole sectors.  A block shape chosen for the card and
// tensor-core products belong to later work.
#include <cuda_runtime.h>

#include "block_ell_tile.cuh"

namespace {

template <int NB>
__global__ void __launch_bounds__(repro::kThreads)
block_ell_spmv_kernel(const float* __restrict__ blocks,
                      const int* __restrict__ indices,
                      const float* __restrict__ x, float* __restrict__ y,
                      int slots, int br, int bc, long long ncols,
                      long long nrows, int B) {
  extern __shared__ float smem[];
  const int rb = blockIdx.x;
  const int per_pass = repro::kThreads / br;
  const int b0 = blockIdx.y * NB * per_pass;
  float acc[NB];
  repro::spmv_tile<NB>(blocks, indices, x, slots, br, bc, ncols, B, rb, b0,
                       smem, acc);
  const long long row = static_cast<long long>(rb) * br + threadIdx.x % br;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int b = b0 + threadIdx.x / br + i * per_pass;
    if (b < B) y[b * nrows + row] = acc[i];
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// blocks (nrb, slots, br, bc), indices (nrb, slots), x (B, ncols),
// y (B, nrb * br).  Requires kThreads % br == 0 and the tile to fit in
// 48 KB of shared memory (checked by the caller).  Returns the launch's
// cudaError_t.
int block_ell_spmv_f32(const void* blocks, const void* indices,
                       const void* x, void* y, int nrb, int slots, int br,
                       int bc, int B, long long ncols, void* stream) {
  const int per_pass = repro::kThreads / br;
  const int nb = B > per_pass ? 2 : 1;
  const int tb = nb * per_pass;
  const dim3 grid(nrb, (B + tb - 1) / tb);
  const size_t smem = repro::tile_smem_bytes(br, bc, tb);
  const long long nrows = static_cast<long long>(nrb) * br;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb == 2)
    block_ell_spmv_kernel<2><<<grid, repro::kThreads, smem, s>>>(
        static_cast<const float*>(blocks), static_cast<const int*>(indices),
        static_cast<const float*>(x), static_cast<float*>(y), slots, br, bc,
        ncols, nrows, B);
  else
    block_ell_spmv_kernel<1><<<grid, repro::kThreads, smem, s>>>(
        static_cast<const float*>(blocks), static_cast<const int*>(indices),
        static_cast<const float*>(x), static_cast<float*>(y), slots, br, bc,
        ncols, nrows, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
