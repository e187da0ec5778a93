// Whole-recurrence Chebyshev sweep for Hopper: all K orders of Algorithm 1
// in one cooperative launch,
//
//     acc  = (c_0 / 2) x + c_1 t_1 + sum_{k=2..K} c_k t_k,
//     t_1  = P x / alpha - x,
//     t_k  = (2/alpha) P t_{k-1} - 2 t_{k-1} - t_{k-2},
//
// for a (B, n) batch x, P in the sliced-ELL row layout
// (core/graph.py::SlicedELL) and an order-major (K+1, eta) coefficient
// table, into a (B, eta, n) accumulator.
//
// Replaces: src/repro/kernels/cheb_sweep.py::cheb_sweep (body
// _cheb_sweep_kernel, in-kernel SpMV _spmv_into).  The TPU kernel ran the
// order loop on one core with the iterates pinned in VMEM and multiplied
// (8, 128) Block-ELL tiles.  Here each order's SpMV reads all of t_{k-1},
// written by every SM in the order before, so orders are separated by a
// grid-wide barrier (cooperative_groups::this_grid().sync()) and the
// iterates live in device memory, where the 50 MB L2 decides whether they
// stay on chip (the footprint guard in repro_torch/kernels/ops.py).
//
// What bounds it on this card: per order, the SpMV's gathers and one
// grid barrier.  The least work is the structure read once (8 B per
// non-zero), x read and acc written once, and 2 nnz B + 4 B n +
// 2 (K+1) B eta n operations: 0.019 ms at n = 16384, B = 64, eta = 7,
// K = 20 (operations, at the 67 TFLOP/s f32 peak).  In practice each
// order gathers 8-32 bytes per stored entry and signal tile from the L2
// and waits at one barrier.
//
// What the design does about it:
//   - the SpMV reads the sliced-ELL layout (~1.4 stored entries per
//     non-zero where the (8, 128) tile stored ~44): a warp owns a
//     32-row slice, one coalesced load of values and one of columns per
//     slot, each pair reused for TB signals held in registers; no shared
//     memory and no block barrier;
//   - the iterates are the kernel's own scratch, stored signal-minor
//     (sliced_ell_sweep.cuh), so a gather of one column for TB signals
//     is one vector load; order 1 gathers x in the caller's layout;
//   - every t_k is kept in its own buffer of a (K, B / TB, n, TB)
//     scratch: order k gathers t_{k-1} from buffer k-1 and writes t_k to
//     buffer k, so no buffer is written twice and orders need ONE barrier
//     each (t_k complete everywhere before order k+1 gathers it); t_{k-2}
//     is read only at the lane's own rows;
//   - the (B, eta, n) accumulator is formed once, after the last order:
//     a fixed work decomposition (sliced_ell_sweep.cuh::Walk) gives each
//     warp the same (slice, signal tile) items in every order, so a lane
//     reads back only its own rows of x and t_1..t_K, which it wrote
//     itself, with no further barrier, sums eta x TB of them in registers
//     and writes each accumulator row once (coalesced).  Reading and
//     writing the 29 MB accumulator back in every order instead (its
//     rows owned the same way) took 1.5077 ms against this form's 0.4847
//     ms in f32 on an H100 80GB HBM3 at 700 W at n = 16384, B = 64,
//     eta = 7, K = 20 (chip_smoke.py).
// f32 mode: f32 throughout, plain FFMA (no TF32).
//
// bf16 mode (the JAX kernel's scratch_dtype="bf16"): the layout's bf16
// values copy, x read as bf16 and the kept iterates bf16; the coefficient
// table and the (B, eta, n) accumulator f32.  The SpMV widens each
// element to f32 and sums in f32; each new iterate is computed in f32
// from that sum and the bf16 iterates and rounded once to bf16 where it
// is stored, and the accumulator sums the stored (rounded) values.  The
// TPU kernel rounded the SpMV product to bf16 in scratch as well and ran
// the update in bf16 arithmetic; here the product never leaves
// registers, so it is not rounded on its own.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sliced_ell_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::CallerRows;
using repro::MinorRows;

template <typename T, int TB>
__global__ void __launch_bounds__(repro::kThreads)
cheb_sweep_kernel(const T* __restrict__ values,
                  const int* __restrict__ columns,
                  const int* __restrict__ offsets,
                  const int* __restrict__ widths,
                  const float* __restrict__ x,
                  const float* __restrict__ coefT, float* __restrict__ acc,
                  T* Ts, int n_slices, long long n, int B, int K, int eta,
                  float alpha) {
  cg::grid_group grid = cg::this_grid();
  const int n_tiles = (B + TB - 1) / TB;
  const repro::Walk walk(n_slices, n_tiles);
  const int lane = threadIdx.x % 32;
  const float two_over_alpha = 2.f / alpha;
  const long long stride = static_cast<long long>(n_tiles) * n * TB;
  auto kept = [&](int k) { return Ts + (k - 1) * stride; };  // t_k, k >= 1
  for (int k = 1; k <= K; ++k) {
    for (long long item = walk.warp; item < walk.items;
         item += walk.n_warps) {
      const int slice = static_cast<int>(item % n_slices);
      const int bt = static_cast<int>(item / n_slices);
      const int b0 = bt * TB;
      const int nb = B - b0 < TB ? B - b0 : TB;
      const long long tile = static_cast<long long>(bt) * n * TB;
      const CallerRows<T, TB> x_rows{x + b0 * n, n, nb};
      float pt[TB];
      if (k == 1)
        repro::slice_spmv<TB>(values, columns, offsets[slice],
                              widths[slice], lane, x_rows, pt);
      else
        repro::slice_spmv<TB>(values, columns, offsets[slice],
                              widths[slice], lane,
                              MinorRows<T, TB>{kept(k - 1) + tile}, pt);
      const long long row =
          static_cast<long long>(slice) * repro::kSliceRows + lane;
      if (row >= n) continue;  // a partly filled last slice
      // this lane's row of t_{k-1} and t_{k-2}, then of t_k
      float p1[TB], p2[TB], tk[TB];
      if (k == 1) {
        x_rows(row, p1);
      } else {
        repro::load_row<T, TB>(kept(k - 1) + tile + row * TB, p1);
        if (k == 2)
          x_rows(row, p2);
        else
          repro::load_row<T, TB>(kept(k - 2) + tile + row * TB, p2);
      }
#pragma unroll
      for (int t = 0; t < TB; ++t)
        tk[t] = repro::round_to<T>(
            k == 1 ? pt[t] / alpha - p1[t]                   // line 4
                   : two_over_alpha * pt[t] - 2.f * p1[t] - p2[t]);  // 9
      repro::store_row<T, TB>(kept(k) + tile + row * TB, tk);
    }
    if (k < K) grid.sync();  // t_k complete everywhere before order k+1
  }
  // acc = (c_0/2) x + sum_k c_k t_k (lines 5 and 12) from the lane's own
  // rows, which it wrote itself: no barrier
  constexpr int kJ = 8;  // accumulator rows summed in registers per pass
  for (long long item = walk.warp; item < walk.items; item += walk.n_warps) {
    const int slice = static_cast<int>(item % n_slices);
    const int bt = static_cast<int>(item / n_slices);
    const int b0 = bt * TB;
    const int nb = B - b0 < TB ? B - b0 : TB;
    const long long tile = static_cast<long long>(bt) * n * TB;
    const long long row =
        static_cast<long long>(slice) * repro::kSliceRows + lane;
    if (row >= n) continue;
    float xv[TB];
    CallerRows<T, TB>{x + b0 * n, n, nb}(row, xv);
    for (int j0 = 0; j0 < eta; j0 += kJ) {
      float a[kJ][TB];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const float c0 = j0 + jj < eta ? 0.5f * coefT[j0 + jj] : 0.f;
#pragma unroll
        for (int t = 0; t < TB; ++t) a[jj][t] = c0 * xv[t];
      }
      for (int k = 1; k <= K; ++k) {
        float tk[TB];
        repro::load_row<T, TB>(kept(k) + tile + row * TB, tk);
        const float* ck = coefT + static_cast<long long>(k) * eta + j0;
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const float cj = j0 + jj < eta ? ck[jj] : 0.f;
#pragma unroll
          for (int t = 0; t < TB; ++t) a[jj][t] = a[jj][t] + cj * tk[t];
        }
      }
#pragma unroll
      for (int t = 0; t < TB; ++t) {
        if (t >= nb) break;
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
          if (j0 + jj < eta)
            acc[(static_cast<long long>(b0 + t) * eta + j0 + jj) * n + row] =
                a[jj][t];
      }
    }
  }
}

template <typename T, int TB>
int launch(const void* values, const void* columns, const void* offsets,
           const void* widths, const void* x, const void* coefT, void* acc,
           void* Ts, int n_slices, long long n, int B, int K, int eta,
           float alpha, cudaStream_t stream, int* grid_out) {
  auto kernel = cheb_sweep_kernel<T, TB>;
  const long long items =
      static_cast<long long>(n_slices) * ((B + TB - 1) / TB);
  int err = repro::coop_grid(kernel, items, grid_out);
  if (err) return err;
  void* args[] = {&values, &columns, &offsets, &widths, &x, &coefT, &acc,
                  &Ts, &n_slices, &n, &B, &K, &eta, &alpha};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(*grid_out)),
                                    dim3(repro::kThreads), args, 0, stream);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// values (stored,) f32 in cheb_sweep_f32 and the layout's bf16 copy in
// cheb_sweep_bf16, columns (stored,) int32, offsets / widths (n_slices,)
// int32 (core/graph.py::SlicedELL), x (B, n) f32 with n = the layout's
// padded n, coefT (K+1, eta) f32, acc (B, eta, n) f32 output, Ts
// (K, ceil(B / TB), n, TB) scratch for t_1..t_K, f32 in cheb_sweep_f32 and
// bf16 in cheb_sweep_bf16.  TB, the signals per tile, is 1, 2, 4 or 8 in
// f32 and 2, 4 or 8 in bf16.  K >= 1.  Writes the grid size used to
// *grid_out.  Returns the launch's cudaError_t: a cooperative launch the
// card refuses is reported, never run partially or retried another way.
#define CHEB_SWEEP_CASE(TYPE, TILE)                                       \
  case TILE:                                                            \
    return launch<TYPE, TILE>(values, columns, offsets, widths, x, coefT, \
                              acc, Ts, n_slices, n, B, K, eta, alpha,     \
                              static_cast<cudaStream_t>(stream),          \
                              static_cast<int*>(grid_out));

int cheb_sweep_f32(const void* values, const void* columns,
                   const void* offsets, const void* widths, const void* x,
                   const void* coefT, void* acc, void* Ts, int n_slices,
                   long long n, int B, int TB, int K, int eta, float alpha,
                   void* stream, void* grid_out) {
  switch (TB) {
    CHEB_SWEEP_CASE(float, 1)
    CHEB_SWEEP_CASE(float, 2)
    CHEB_SWEEP_CASE(float, 4)
    CHEB_SWEEP_CASE(float, 8)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int cheb_sweep_bf16(const void* values, const void* columns,
                    const void* offsets, const void* widths, const void* x,
                    const void* coefT, void* acc, void* Ts, int n_slices,
                    long long n, int B, int TB, int K, int eta, float alpha,
                    void* stream, void* grid_out) {
  switch (TB) {
    CHEB_SWEEP_CASE(__nv_bfloat16, 2)
    CHEB_SWEEP_CASE(__nv_bfloat16, 4)
    CHEB_SWEEP_CASE(__nv_bfloat16, 8)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef CHEB_SWEEP_CASE

}  // extern "C"
