// Whole (accelerated-)Jacobi solve for Hopper: all rounds of Eq. (24) /
// Eq. (25) on den(P) x = b in one cooperative launch.  Per round t
//
//     h      = den(P) x                 (Horner: deg(den) SpMVs)
//     x_next = w_t (x + inv_d (b - h)) - s_t x_prev
//
// for a (B, n) batch, Block-ELL P, monomial coefficients den (low degree
// first) and an (n_iters, 2) table of (w_t, s_t), starting from
// x = x_prev = x0.
//
// Replaces: src/repro/kernels/cheb_sweep.py::jacobi_sweep (body
// _jacobi_sweep_kernel, in-kernel SpMV _spmv_into).  The TPU kernel ran
// every round on one core with x, x_prev, h and the SpMV product in VMEM
// and wrote the Horner accumulator in place right after a SpMV had read
// all of it.  Here each SpMV reads all rows of its source, written by
// every SM in the step before, so steps are separated by a grid-wide
// barrier (cooperative_groups::this_grid().sync()) and the iterates live
// in device memory, where the 50 MB L2 decides whether they stay on chip
// (the footprint guard in repro_torch/kernels/ops.py).
//
// What bounds it on this card: per SpMV, the same as the per-order SpMV
// (block_ell_spmv.cu): the Block-ELL blocks streamed from device memory
// and the shared-memory-bound FMA loop over mostly-zero (8, 128) blocks.
// What the sweep saves against the per-round path is the launches and
// the round trip of every SpMV product and Horner partial sum through
// device memory.
//
// Design: a grid of co-resident blocks (occupancy x SM count) walks the
// (row block, batch tile) work items with a grid-stride loop, the same
// items in every step.  Horner step m of a round computes the block's
// rows of h_m = P h_{m-1} + den[D-m] x, with h_0 = den[D] x folded into the
// first SpMV (it reads x and scales the product), so x is never copied.
// An in-place h would race with blocks still reading it, so h ping-pongs
// between two (B, n) buffers H0 / H1: step m writes one and the next step
// reads it, one barrier per SpMV and no read-after-write hazard.  The last
// step keeps its rows of h in registers and applies the update to the same
// rows.  x_next goes into the buffer of x_prev: a thread reads its own
// rows of x_prev just before it overwrites them, and no other thread reads
// x_prev, so two buffers U / V rotate with no extra barrier (x0 is the
// read-only input: round 0 writes U, round 1 writes V, then x_next always
// lands where x_prev was).  One barrier after each SpMV step, i.e. deg(den)
// per round; with deg(den) = 0 there is no SpMV and no barrier, since
// every thread then only touches its own elements.  f32 mode: f32
// throughout, plain FFMA (no TF32).
//
// bf16 mode (the JAX kernel's scratch_dtype="bf16"): the Block-ELL blocks
// and the Horner buffers H0 / H1 are bf16; x (U / V, x0), b, D^-1, the
// weight table and the update are f32.  Each Horner step sums its SpMV in
// f32, adds den[D-m] x in f32 and rounds the partial sum once to bf16
// (stored, or kept in a register by the last step); x_prev enters the
// update rounded to bf16, as the TPU kernel kept it in bf16 scratch.  The
// first SpMV reads x itself (h_0 = den[D] x is folded into it), so h_0 is
// never rounded.  x_prev is the previous x, which the U / V rotation keeps
// in f32 anyway: a separate bf16 copy would only add a buffer.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_ell_tile.cuh"

namespace cg = cooperative_groups;

namespace {

template <int NB, typename T>
__global__ void __launch_bounds__(repro::kThreads)
jacobi_sweep_kernel(const T* __restrict__ blocks,
                    const int* __restrict__ indices,
                    const float* __restrict__ rhs,
                    const float* __restrict__ inv_d, long long d_stride,
                    const float* __restrict__ x0,
                    const float* __restrict__ table, float* U, float* V,
                    T* H0, T* H1, int nrb, int slots, int br, int bc,
                    long long n, int B, int n_iters, int D) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int per_pass = repro::kThreads / br;
  const int tb = NB * per_pass;
  const int n_tiles = (B + tb - 1) / tb;
  const long long items = static_cast<long long>(nrb) * n_tiles;
  const float* den = table;            // (D + 1,), low degree first
  const float* ws = table + D + 1;     // (n_iters, 2)
  for (int t = 0; t < n_iters; ++t) {
    const float* x = t == 0 ? x0 : ((t & 1) ? U : V);
    const float* xp = t <= 1 ? x0 : ((t & 1) ? V : U);
    float* dst = (t & 1) ? V : U;      // == xp's buffer from round 2 on
    const float w = ws[2 * t], s = ws[2 * t + 1];
    const T* src = nullptr;            // the Horner buffer the SpMV reads
    for (int m = (D == 0 ? 0 : 1); m <= D; ++m) {
      const bool last = m == D;
      T* hdst = (m & 1) ? H0 : H1;
      const float scale = m == 1 ? den[D] : 1.f;
      const float c = den[D - m];
      for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        const int rb = static_cast<int>(item / n_tiles);
        const int b0 = static_cast<int>(item % n_tiles) * tb;
        float pt[NB];
        if (m == 1)  // h_0 = den[D] x: the SpMV reads x
          repro::spmv_tile<NB, T, float>(blocks, indices, x, slots, br, bc,
                                         n, B, rb, b0, smem, pt);
        else if (m > 1)
          repro::spmv_tile<NB, T, T>(blocks, indices, src, slots, br, bc, n,
                                     B, rb, b0, smem, pt);
        const long long row =
            static_cast<long long>(rb) * br + threadIdx.x % br;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int b = b0 + threadIdx.x / br + i * per_pass;
          if (b >= B) continue;
          const long long off = b * n + row;
          const float xv = x[off];
          // Horner step m (with D = 0: h = den[0] x, no SpMV)
          const T hs = repro::from_f32<T>(D > 0 ? scale * pt[i] + c * xv
                                                 : c * xv);
          if (!last) {
            hdst[off] = hs;
          } else {
            const float h = repro::to_f32(hs);
            const float xpv = repro::round_to<T>(xp[off]);
            dst[off] = w * (xv + inv_d[b * d_stride + row] * (rhs[off] - h)) -
                       s * xpv;
          }
        }
      }
      src = hdst;
      if (D > 0 && !(last && t == n_iters - 1))
        grid.sync();  // this step's rows complete before the next SpMV
    }
  }
}

template <int NB, typename T>
int launch(const T* blocks, const int* indices, const float* rhs,
           const float* inv_d, long long d_stride, const float* x0,
           const float* table, float* U, float* V, T* H0, T* H1,
           int nrb, int slots, int br, int bc, long long n, int B,
           int n_iters, int D, cudaStream_t stream, int* grid_out) {
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
        &per_sm, jacobi_sweep_kernel<NB, T>, repro::kThreads, smem);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      static_cast<long long>(nrb) * ((B + tb - 1) / tb);
  long long g = static_cast<long long>(per_sm) * sms;
  if (g > items) g = items;
  *grid_out = static_cast<int>(g);
  void* args[] = {&blocks, &indices, &rhs, &inv_d, &d_stride, &x0,
                  &table, &U, &V, &H0, &H1, &nrb, &slots, &br, &bc,
                  &n, &B, &n_iters, &D};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(jacobi_sweep_kernel<NB, T>),
      dim3(static_cast<unsigned>(g)), dim3(repro::kThreads), args, smem,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sweep(const void* blocks, const void* indices, const void* rhs,
          const void* inv_d, long long d_stride, const void* x0,
          const void* table, void* U, void* V, void* H0, void* H1, int nrb,
          int slots, int br, int bc, int B, int n_iters, int D, void* stream,
          void* grid_out) {
  const int per_pass = repro::kThreads / br;
  const long long n = static_cast<long long>(nrb) * br;
  auto* bl = static_cast<const T*>(blocks);
  auto* ix = static_cast<const int*>(indices);
  auto* r = static_cast<const float*>(rhs);
  auto* d = static_cast<const float*>(inv_d);
  auto* x = static_cast<const float*>(x0);
  auto* tab = static_cast<const float*>(table);
  auto* u = static_cast<float*>(U);
  auto* v = static_cast<float*>(V);
  auto* h0 = static_cast<T*>(H0);
  auto* h1 = static_cast<T*>(H1);
  auto s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<int*>(grid_out);
  if (B > per_pass)
    return launch<2>(bl, ix, r, d, d_stride, x, tab, u, v, h0, h1, nrb,
                     slots, br, bc, n, B, n_iters, D, s, g);
  return launch<1>(bl, ix, r, d, d_stride, x, tab, u, v, h0, h1, nrb, slots,
                   br, bc, n, B, n_iters, D, s, g);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// blocks (nrb, slots, br, bc), indices (nrb, slots), rhs and x0 (B, n)
// with n = nrb * br = ncb * bc, inv_d (B, n) with d_stride = n or (n,) with
// d_stride = 0, table = [den (D + 1), (w_t, s_t) (n_iters, 2)] f32, U, V
// (B, n) f32 scratch, H0, H1 (B, n) scratch.  blocks, H0 and H1 are f32 in
// jacobi_sweep_f32 and bf16 in jacobi_sweep_bf16; everything else is f32
// in both.  n_iters >= 1.  After the launch x lives in U when n_iters is
// odd and in V when it is even.  Writes the grid size used to *grid_out.
// Returns the launch's cudaError_t: a cooperative launch the card refuses
// is reported, never run partially or retried another way.
int jacobi_sweep_f32(const void* blocks, const void* indices,
                     const void* rhs, const void* inv_d, long long d_stride,
                     const void* x0, const void* table, void* U, void* V,
                     void* H0, void* H1, int nrb, int slots, int br, int bc,
                     int B, int n_iters, int D, void* stream,
                     void* grid_out) {
  return sweep<float>(blocks, indices, rhs, inv_d, d_stride, x0, table, U,
                      V, H0, H1, nrb, slots, br, bc, B, n_iters, D, stream,
                      grid_out);
}

int jacobi_sweep_bf16(const void* blocks, const void* indices,
                      const void* rhs, const void* inv_d, long long d_stride,
                      const void* x0, const void* table, void* U, void* V,
                      void* H0, void* H1, int nrb, int slots, int br, int bc,
                      int B, int n_iters, int D, void* stream,
                      void* grid_out) {
  return sweep<__nv_bfloat16>(blocks, indices, rhs, inv_d, d_stride, x0,
                              table, U, V, H0, H1, nrb, slots, br, bc, B,
                              n_iters, D, stream, grid_out);
}

}  // extern "C"
