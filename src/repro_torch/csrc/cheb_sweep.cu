// Whole-recurrence Chebyshev sweep for Hopper: all K orders of Algorithm 1
// in one cooperative launch,
//
//     acc  = (c_0 / 2) x + c_1 t_1 + sum_{k=2..K} c_k t_k,
//     t_1  = P x / alpha - x,
//     t_k  = (2/alpha) P t_{k-1} - 2 t_{k-1} - t_{k-2},
//
// for a (B, n) batch x, Block-ELL P and an order-major (K+1, eta)
// coefficient table, into a (B, eta, n) accumulator.
//
// Replaces: src/repro/kernels/cheb_sweep.py::cheb_sweep (body
// _cheb_sweep_kernel, in-kernel SpMV _spmv_into).  The TPU kernel ran the
// order loop on one core with the iterates pinned in VMEM.  Here each
// order's SpMV reads all of t_{k-1}, written by every SM in the order
// before, so orders are separated by a grid-wide barrier
// (cooperative_groups::this_grid().sync()) and the iterates live in
// device memory, where the 50 MB L2 decides whether they stay on chip
// (the footprint guard in repro_torch/kernels/ops.py).
//
// What bounds it on this card: per order, the same as the per-order SpMV
// (block_ell_spmv.cu): the Block-ELL blocks streamed from device memory
// and the shared-memory-bound FMA loop over mostly-zero (8, 128) blocks.
// What the sweep saves against the per-order path is 2K - 1 launches and
// the round trip of P t_{k-1} through device memory: the product stays in
// registers and feeds the fused update directly.
//
// Design: the grid is sized to the number of blocks that can be resident
// at once (occupancy x SM count) and walks the (row block, batch tile)
// work items with a grid-stride loop, the same items in every order.
// Within order k a thread block computes its rows of P t_{k-1}, then
// applies the update to those same rows: t_k is written into the buffer
// of t_{k-2}, and acc += c_k (x) t_k.  Only the block's own rows of
// t_{k-2} are read in that order, and they are read by the same thread
// just before it overwrites them; every other row any block reads in
// order k belongs to t_{k-1}, which nobody writes in order k.  So three
// (B, n) buffers — x (t_0, read only), U and V — rotate in place with ONE
// barrier per order: t_1 -> U, t_2 -> V, then t_k -> buffer of t_{k-2}.
// f32 mode: f32 throughout, plain FFMA (no TF32).
//
// bf16 mode (the JAX kernel's scratch_dtype="bf16"): x, the Block-ELL
// blocks and the iterates U / V are bf16, the coefficient table and the
// (B, eta, n) accumulator f32.  The SpMV widens each staged element to
// f32 and sums in f32; each new iterate is computed in f32 from that sum
// and the bf16 iterates and rounded once to bf16 where it is stored, and
// the accumulator adds the stored (rounded) value.  The TPU kernel rounded
// the SpMV product to bf16 in scratch as well and ran the update in bf16
// arithmetic; here the product never leaves registers, so it is not
// rounded on its own.  Same kernel template, T = __nv_bfloat16.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_ell_tile.cuh"

namespace cg = cooperative_groups;

namespace {

template <int NB, typename T>
__global__ void __launch_bounds__(repro::kThreads)
cheb_sweep_kernel(const T* __restrict__ blocks,
                  const int* __restrict__ indices,
                  const T* __restrict__ x,
                  const float* __restrict__ coefT, float* __restrict__ acc,
                  T* U, T* V, int nrb, int slots, int br, int bc,
                  long long n, int B, int K, int eta, float alpha) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int per_pass = repro::kThreads / br;
  const int tb = NB * per_pass;
  const int n_tiles = (B + tb - 1) / tb;
  const long long items = static_cast<long long>(nrb) * n_tiles;
  const float two_over_alpha = 2.f / alpha;
  const T* tm1 = x;        // t_{k-1}
  const T* tm2 = nullptr;  // t_{k-2}
  T* dst = U;              // where t_k goes
  for (int k = 1; k <= K; ++k) {
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const int rb = static_cast<int>(item / n_tiles);
      const int b0 = static_cast<int>(item % n_tiles) * tb;
      float pt[NB];
      repro::spmv_tile<NB, T, T>(blocks, indices, tm1, slots, br, bc, n, B,
                                 rb, b0, smem, pt);
      const long long row = static_cast<long long>(rb) * br +
                            threadIdx.x % br;
      const float* ck = coefT + static_cast<long long>(k) * eta;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int b = b0 + threadIdx.x / br + i * per_pass;
        if (b >= B) continue;
        const long long off = b * n + row;
        float* a = acc + static_cast<long long>(b) * eta * n + row;
        if (k == 1) {
          // orders 0 and 1: acc = (c_0/2) x + c_1 t_1    (lines 4-5)
          const float xv = repro::to_f32(x[off]);
          const T t1s = repro::from_f32<T>(pt[i] / alpha - xv);
          const float t1 = repro::to_f32(t1s);
          dst[off] = t1s;
          for (int j = 0; j < eta; ++j)
            a[j * n] = 0.5f * coefT[j] * xv + ck[j] * t1;
        } else {
          // line 9, then the running sum of line 12
          const T tks = repro::from_f32<T>(
              two_over_alpha * pt[i] - 2.f * repro::to_f32(tm1[off]) -
              repro::to_f32(tm2[off]));
          const float tk = repro::to_f32(tks);
          dst[off] = tks;
          for (int j = 0; j < eta; ++j) a[j * n] = a[j * n] + ck[j] * tk;
        }
      }
    }
    if (k == K) break;
    grid.sync();  // t_k complete everywhere before order k+1 reads it
    // rotate: t_{k+1} goes into the buffer of t_{k-1} (V after order 1,
    // since t_0 is the read-only input x)
    T* freed = (k == 1) ? V : const_cast<T*>(tm1);
    tm2 = tm1;
    tm1 = dst;
    dst = freed;
  }
}

template <int NB, typename T>
int launch(const T* blocks, const int* indices, const T* x,
           const float* coefT, float* acc, T* U, T* V, int nrb,
           int slots, int br, int bc, long long n, int B, int K, int eta,
           float alpha, cudaStream_t stream, int* grid_out) {
  const int per_pass = repro::kThreads / br;
  const int tb = NB * per_pass;
  const size_t smem = repro::tile_smem_bytes(br, bc, tb);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cheb_sweep_kernel<NB, T>, repro::kThreads, smem);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      static_cast<long long>(nrb) * ((B + tb - 1) / tb);
  long long g = static_cast<long long>(per_sm) * sms;
  if (g > items) g = items;
  *grid_out = static_cast<int>(g);
  void* args[] = {&blocks, &indices, &x, &coefT, &acc, &U, &V, &nrb,
                  &slots, &br, &bc, &n, &B, &K, &eta, &alpha};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(cheb_sweep_kernel<NB, T>),
      dim3(static_cast<unsigned>(g)), dim3(repro::kThreads), args, smem,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sweep(const void* blocks, const void* indices, const void* x,
          const void* coefT, void* acc, void* U, void* V, int nrb, int slots,
          int br, int bc, int B, int K, int eta, float alpha, void* stream,
          void* grid_out) {
  const int per_pass = repro::kThreads / br;
  const long long n = static_cast<long long>(nrb) * br;
  auto* b = static_cast<const T*>(blocks);
  auto* ix = static_cast<const int*>(indices);
  auto* xx = static_cast<const T*>(x);
  auto* c = static_cast<const float*>(coefT);
  auto* a = static_cast<float*>(acc);
  auto* u = static_cast<T*>(U);
  auto* v = static_cast<T*>(V);
  auto s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<int*>(grid_out);
  if (B > per_pass)
    return launch<2>(b, ix, xx, c, a, u, v, nrb, slots, br, bc, n, B, K, eta,
                     alpha, s, g);
  return launch<1>(b, ix, xx, c, a, u, v, nrb, slots, br, bc, n, B, K, eta,
                   alpha, s, g);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// blocks (nrb, slots, br, bc), indices (nrb, slots), x (B, n) with
// n = nrb * br = ncb * bc, coefT (K+1, eta) f32, acc (B, eta, n) f32
// output, U and V (B, n) scratch.  blocks, x, U and V are f32 in
// cheb_sweep_f32 and bf16 in cheb_sweep_bf16.  K >= 1.  Writes the grid
// size used to *grid_out.  Returns the launch's cudaError_t: a
// cooperative launch the card refuses is reported, never run partially or
// retried another way.
int cheb_sweep_f32(const void* blocks, const void* indices, const void* x,
                   const void* coefT, void* acc, void* U, void* V, int nrb,
                   int slots, int br, int bc, int B, int K, int eta,
                   float alpha, void* stream, void* grid_out) {
  return sweep<float>(blocks, indices, x, coefT, acc, U, V, nrb, slots, br,
                      bc, B, K, eta, alpha, stream, grid_out);
}

int cheb_sweep_bf16(const void* blocks, const void* indices, const void* x,
                    const void* coefT, void* acc, void* U, void* V, int nrb,
                    int slots, int br, int bc, int B, int K, int eta,
                    float alpha, void* stream, void* grid_out) {
  return sweep<__nv_bfloat16>(blocks, indices, x, coefT, acc, U, V, nrb,
                              slots, br, bc, B, K, eta, alpha, stream,
                              grid_out);
}

}  // extern "C"
