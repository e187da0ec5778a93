// Whole (accelerated-)Jacobi solve for Hopper: all rounds of Eq. (24) /
// Eq. (25) on den(P) x = b in one cooperative launch.  Per round t
//
//     h      = den(P) x                 (Horner: deg(den) SpMVs)
//     x_next = w_t (x + inv_d (b - h)) - s_t x_prev
//
// for a (B, n) batch, P in the sliced-ELL row layout
// (core/graph.py::SlicedELL), monomial coefficients den (low degree first)
// and an (n_iters, 2) table of (w_t, s_t), starting from x = x_prev = x0.
//
// Replaces: src/repro/kernels/cheb_sweep.py::jacobi_sweep (body
// _jacobi_sweep_kernel, in-kernel SpMV _spmv_into).  The TPU kernel ran
// every round on one core with x, x_prev, h and the SpMV product in VMEM,
// multiplied (8, 128) Block-ELL tiles and wrote the Horner accumulator in
// place right after a SpMV had read all of it.  Here each SpMV reads all
// rows of its source, written by every SM in the step before, so steps
// are separated by a grid-wide barrier (cooperative_groups::this_grid()
// .sync()) and the iterates live in device memory, where the 50 MB L2
// decides whether they stay on chip (the footprint guard in
// repro_torch/kernels/ops.py).
//
// What bounds it on this card: per SpMV, its gathers from the L2 and one
// barrier.  The least work is the structure read once (8 B per
// non-zero), b, x0 and D^-1 read and x written once, and per round
// deg(den) (2 nnz B + 2 B n) + 6 B n operations: 0.015 ms at n = 16384,
// B = 64, 20 rounds of deg(den) = 1 (operations, at the 67 TFLOP/s f32
// peak).
//
// What the design does about it (sliced_ell_sweep.cuh):
//   - the SpMV reads the sliced-ELL layout (~1.4 stored entries per
//     non-zero where the (8, 128) tile stored ~44): a warp owns a 32-row
//     slice, one coalesced load of values and one of columns per slot,
//     each pair reused for TB signals held in registers; no shared memory;
//   - the iterates x (U / V) and the Horner partial sums (H0 / H1) are
//     the kernel's own scratch, stored signal-minor, so a gather of one
//     column for TB signals is one vector load; round 0 gathers x0 in the
//     caller's layout, and the last round writes x there;
//   - a fixed work decomposition (Walk) gives each warp the same
//     (slice, signal tile) items in every step.  Horner step m of a round
//     computes the warp's rows of h_m = P h_{m-1} + den[D-m] x, with
//     h_0 = den[D] x folded into the first SpMV (it reads x and scales the
//     product), so x is never copied.  h ping-pongs between H0 and H1:
//     step m writes one and the next step reads it, one barrier per SpMV.
//     The last step keeps its rows of h in registers and applies the
//     update to the same rows.  x_next goes into the buffer of x_prev: a
//     lane reads its own rows of x_prev just before it overwrites them,
//     and no other lane reads x_prev, so U / V rotate with no extra
//     barrier (x0 is the read-only input: round 0 writes U, round 1
//     writes V, then x_next lands where x_prev was).  One barrier after
//     each SpMV step, i.e. deg(den) per round; with deg(den) = 0 there is
//     no SpMV and no barrier, since every lane then only touches its own
//     rows.
// f32 mode: f32 throughout, plain FFMA (no TF32).
//
// bf16 mode (the JAX kernel's scratch_dtype="bf16"): the layout's bf16
// values copy and the Horner buffers H0 / H1 are bf16; x (U / V, x0), b,
// D^-1, the weight table and the update are f32.  Each Horner step sums
// its SpMV in f32, adds den[D-m] x in f32 and rounds the partial sum once
// to bf16 (stored, or kept in a register by the last step); x_prev enters
// the update rounded to bf16, as the TPU kernel kept it in bf16 scratch.
// The first SpMV reads x itself (h_0 = den[D] x is folded into it), so h_0
// is never rounded.  x_prev is the previous x, which the U / V rotation
// keeps in f32 anyway: a separate bf16 copy would only add a buffer.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sliced_ell_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::CallerRows;
using repro::MinorRows;

// A round's x or x_prev: x0 in the caller's layout, or a signal-minor
// scratch buffer.
struct Iterate {
  const float* p;
  bool caller;  // p is x0, (B, n)
};

template <int TB>
__device__ __forceinline__ void own_rows(const Iterate& it, long long tile,
                                         long long b0n, long long n, int nb,
                                         long long row, float (&v)[TB]) {
  if (it.caller)
    CallerRows<float, TB>{it.p + b0n, n, nb}(row, v);
  else
    repro::load_row<float, TB>(it.p + tile + row * TB, v);
}

template <typename T, int TB>
__global__ void __launch_bounds__(repro::kThreads)
jacobi_sweep_kernel(const T* __restrict__ values,
                    const int* __restrict__ columns,
                    const int* __restrict__ offsets,
                    const int* __restrict__ widths,
                    const float* __restrict__ rhs,
                    const float* __restrict__ inv_d, long long d_stride,
                    const float* __restrict__ x0,
                    const float* __restrict__ table, float* U, float* V,
                    T* H0, T* H1, float* __restrict__ out, int n_slices,
                    long long n, int B, int n_iters, int D) {
  cg::grid_group grid = cg::this_grid();
  const int n_tiles = (B + TB - 1) / TB;
  const repro::Walk walk(n_slices, n_tiles);
  const int lane = threadIdx.x % 32;
  const float* den = table;         // (D + 1,), low degree first
  const float* ws = table + D + 1;  // (n_iters, 2)
  for (int t = 0; t < n_iters; ++t) {
    const Iterate x{t == 0 ? x0 : ((t & 1) ? U : V), t == 0};
    const Iterate xp{t <= 1 ? x0 : ((t & 1) ? V : U), t <= 1};
    float* dst = (t & 1) ? V : U;  // == xp's buffer from round 2 on
    const bool final_round = t == n_iters - 1;
    const float w = ws[2 * t], s = ws[2 * t + 1];
    const T* src = nullptr;        // the Horner buffer the SpMV reads
    for (int m = (D == 0 ? 0 : 1); m <= D; ++m) {
      const bool last = m == D;
      T* hdst = (m & 1) ? H0 : H1;
      const float scale = m == 1 ? den[D] : 1.f;
      const float c = den[D - m];
      for (long long item = walk.warp; item < walk.items;
           item += walk.n_warps) {
        const int slice = static_cast<int>(item % n_slices);
        const int bt = static_cast<int>(item / n_slices);
        const int b0 = bt * TB;
        const int nb = B - b0 < TB ? B - b0 : TB;
        const long long tile = static_cast<long long>(bt) * n * TB;
        const long long b0n = static_cast<long long>(b0) * n;
        float pt[TB];
        if (m == 1 && x.caller)  // h_0 = den[D] x: the SpMV reads x
          repro::slice_spmv<TB>(values, columns, offsets[slice],
                                widths[slice], lane,
                                CallerRows<float, TB>{x.p + b0n, n, nb}, pt);
        else if (m == 1)
          repro::slice_spmv<TB>(values, columns, offsets[slice],
                                widths[slice], lane,
                                MinorRows<float, TB>{x.p + tile}, pt);
        else if (m > 1)
          repro::slice_spmv<TB>(values, columns, offsets[slice],
                                widths[slice], lane,
                                MinorRows<T, TB>{src + tile}, pt);
        const long long row =
            static_cast<long long>(slice) * repro::kSliceRows + lane;
        if (row >= n) continue;  // a partly filled last slice
        float xv[TB], h[TB];
        own_rows<TB>(x, tile, b0n, n, nb, row, xv);
        // Horner step m (with D = 0: h = den[0] x, no SpMV)
#pragma unroll
        for (int i = 0; i < TB; ++i)
          h[i] = repro::round_to<T>(D > 0 ? scale * pt[i] + c * xv[i]
                                          : c * xv[i]);
        if (!last) {
          repro::store_row<T, TB>(hdst + tile + row * TB, h);
          continue;
        }
        float xpv[TB], nx[TB];
        own_rows<TB>(xp, tile, b0n, n, nb, row, xpv);
#pragma unroll
        for (int i = 0; i < TB; ++i) {
          const bool live = i < nb;
          const float bv = live ? rhs[b0n + i * n + row] : 0.f;
          const float dv =
              live ? inv_d[(b0 + i) * d_stride + row] : 0.f;
          nx[i] = w * (xv[i] + dv * (bv - h[i])) -
                  s * repro::round_to<T>(xpv[i]);
          if (final_round && live) out[b0n + i * n + row] = nx[i];
        }
        if (!final_round) repro::store_row<float, TB>(dst + tile + row * TB,
                                                     nx);
      }
      src = hdst;
      if (D > 0 && !(last && final_round))
        grid.sync();  // this step's rows complete before the next SpMV
    }
  }
}

template <typename T, int TB>
int launch(const void* values, const void* columns, const void* offsets,
           const void* widths, const void* rhs, const void* inv_d,
           long long d_stride, const void* x0, const void* table, void* U,
           void* V, void* H0, void* H1, void* out, int n_slices, long long n,
           int B, int n_iters, int D, cudaStream_t stream, int* grid_out) {
  auto kernel = jacobi_sweep_kernel<T, TB>;
  const long long items =
      static_cast<long long>(n_slices) * ((B + TB - 1) / TB);
  int err = repro::coop_grid(kernel, items, grid_out);
  if (err) return err;
  void* args[] = {&values, &columns, &offsets, &widths, &rhs, &inv_d,
                  &d_stride, &x0, &table, &U, &V, &H0, &H1, &out,
                  &n_slices, &n, &B, &n_iters, &D};
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

// values (stored,) f32 in jacobi_sweep_f32 and the layout's bf16 copy in
// jacobi_sweep_bf16, columns (stored,) int32, offsets / widths
// (n_slices,) int32 (core/graph.py::SlicedELL); rhs and x0 (B, n) f32
// with n = the layout's padded n, inv_d (B, n) with d_stride = n or (n,)
// with d_stride = 0, table = [den (D + 1), (w_t, s_t) (n_iters, 2)] f32;
// U, V (ceil(B / TB), n, TB) f32 scratch, H0, H1 the same shape, f32 in
// jacobi_sweep_f32 and bf16 in jacobi_sweep_bf16; out (B, n) f32, x after
// n_iters >= 1 rounds.  TB, the signals per tile, is 1, 2, 4 or 8 in f32
// and 2, 4 or 8 in bf16.  Writes the grid size used to *grid_out.
// Returns the launch's cudaError_t: a cooperative launch the card refuses
// is reported, never run partially or retried another way.
#define JACOBI_SWEEP_CASE(TYPE, TILE)                                      \
  case TILE:                                                             \
    return launch<TYPE, TILE>(values, columns, offsets, widths, rhs,      \
                              inv_d, d_stride, x0, table, U, V, H0, H1,   \
                              out, n_slices, n, B, n_iters, D,            \
                              static_cast<cudaStream_t>(stream),          \
                              static_cast<int*>(grid_out));

int jacobi_sweep_f32(const void* values, const void* columns,
                     const void* offsets, const void* widths,
                     const void* rhs, const void* inv_d, long long d_stride,
                     const void* x0, const void* table, void* U, void* V,
                     void* H0, void* H1, void* out, int n_slices,
                     long long n, int B, int TB, int n_iters, int D,
                     void* stream, void* grid_out) {
  switch (TB) {
    JACOBI_SWEEP_CASE(float, 1)
    JACOBI_SWEEP_CASE(float, 2)
    JACOBI_SWEEP_CASE(float, 4)
    JACOBI_SWEEP_CASE(float, 8)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int jacobi_sweep_bf16(const void* values, const void* columns,
                      const void* offsets, const void* widths,
                      const void* rhs, const void* inv_d, long long d_stride,
                      const void* x0, const void* table, void* U, void* V,
                      void* H0, void* H1, void* out, int n_slices,
                      long long n, int B, int TB, int n_iters, int D,
                      void* stream, void* grid_out) {
  switch (TB) {
    JACOBI_SWEEP_CASE(__nv_bfloat16, 2)
    JACOBI_SWEEP_CASE(__nv_bfloat16, 4)
    JACOBI_SWEEP_CASE(__nv_bfloat16, 8)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef JACOBI_SWEEP_CASE

}  // extern "C"
