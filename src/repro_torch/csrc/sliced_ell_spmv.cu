// Sliced-ELL SpMV for Hopper: Y = A X^T on a (B, n) row-major batch of
// signals, one launch per matvec, for any B >= 1 and any n (the last
// 32-row slice may be partly filled).
//
// Replaces: src/repro/kernels/bcsr_spmv.py::block_ell_spmv and
// ::block_ell_spmv_batched.  The TPU kernels multiplied whole (8, 128)
// Block-ELL tiles, the shape of the TPU's vector unit.  On a strip-sorted
// sensor graph the neighbours of a row block spread over many column
// blocks, so that layout stores ~44 entries per non-zero (n = 16384);
// this kernel reads the sliced-ELL row layout (core/graph.py::SlicedELL),
// ~1.4 stored entries per non-zero, and never touches a zero tile.
//
// What bounds it on this card: bytes.  The product needs each non-zero
// once (value and column, 8 B), x read once and y written once:
// nnz * 8 + 2 * B * n * 4 bytes, 3.31 us at 3.35 TB/s for the smoke
// graph (337116 non-zeros, n = 16384) at B = 64, against 2 * nnz * B
// operations (0.64 us at the 67 TFLOP/s f32 peak).  The yardstick is one
// cuSPARSE CSR product (torch.sparse.mm): 0.0438 ms at B = 64 on an
// H100 80GB HBM3 at 700 W.  Inside the SM the limit is the gather of x:
// the 32 lanes of a slot read 32 scattered columns.
//
// What the design does about it:
//   - the lanes of a warp own the 32 rows of a slice; a slot of a slice is
//     32 consecutive values and 32 consecutive columns, one 128-byte load
//     each, and the padding past a row's last entry is value 0 at the
//     row's own column;
//   - each thread keeps TB signals' accumulators in registers and reuses
//     each (value, column) pair it loads for all of them, so the structure
//     is read once per tile of TB signals, not once per signal;
//   - the gathers of x read through L1 and L2: at B = 64 x is 4 MiB, and
//     the rows of a strip-sorted graph that share a block have nearby
//     columns;
//   - y is stored coalesced (the 32 lanes write 32 consecutive rows);
//   - the grid runs over (groups of kWarps slices, tiles of TB signals),
//     striding over the tiles when there are more than 65535.
// Arithmetic is f32 FFMA in increasing column order per row: no tensor
// core, so no TF32.  Each row is summed by one thread in a fixed order, so
// two launches on the same inputs give the same bits.
//
// The rectangular, accumulating entry (sliced_ell_spmv_acc_f32) serves
// the couplings of a general partition's shard: Y += C R, where C has n
// rows (Y's length) and n_cols columns (R's length, the concatenated
// tiles received from the other shards).  It is bound by bytes as well:
// nnz_C * 8 + B * (n_cols + 2 n) * 4.  C is far sparser than a shard's
// own block (most rows hold no cut edge), so a slice with no entry
// returns before it touches Y.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                  // slices per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGridY = 65535;

// y (B, n) = A x or, with ACC, y += A x, for x (B, n_cols).
template <int TB, bool ACC>
__global__ void __launch_bounds__(kThreads)
sliced_ell_spmv_kernel(const float* __restrict__ values,
                       const int* __restrict__ columns,
                       const int* __restrict__ offsets,
                       const int* __restrict__ widths,
                       const float* __restrict__ x, float* __restrict__ y,
                       int n_slices, long long n, long long n_cols, int B) {
  const int slice = blockIdx.x * kWarps + threadIdx.x / 32;
  if (slice >= n_slices) return;
  const int lane = threadIdx.x % 32;
  const int width = widths[slice];
  if (ACC && width == 0) return;   // y += 0
  const float* v = values + offsets[slice] + lane;
  const int* c = columns + offsets[slice] + lane;
  const long long row = static_cast<long long>(slice) * 32 + lane;
  const int n_bt = (B + TB - 1) / TB;
  for (int bt = blockIdx.y; bt < n_bt; bt += gridDim.y) {
    const int b0 = bt * TB;
    const int nb = B - b0 < TB ? B - b0 : TB;
    const float* xb = x + b0 * n_cols;
    float acc[TB];
#pragma unroll
    for (int t = 0; t < TB; ++t) acc[t] = 0.f;
    if (nb == TB) {
#pragma unroll 2
      for (int j = 0; j < width; ++j) {
        const float a = v[32 * j];
        const long long col = c[32 * j];
#pragma unroll
        for (int t = 0; t < TB; ++t)
          acc[t] = fmaf(a, xb[t * n_cols + col], acc[t]);
      }
    } else {  // the ragged last tile of signals
      for (int j = 0; j < width; ++j) {
        const float a = v[32 * j];
        const long long col = c[32 * j];
#pragma unroll
        for (int t = 0; t < TB; ++t)
          if (t < nb) acc[t] = fmaf(a, xb[t * n_cols + col], acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      if (t < nb && row < n) {
        float* out = y + (b0 + t) * n + row;
        *out = ACC ? *out + acc[t] : acc[t];
      }
    }
  }
}

template <int TB, bool ACC>
int launch(const float* values, const int* columns, const int* offsets,
           const int* widths, const float* x, float* y, int n_slices,
           long long n, long long n_cols, int B, cudaStream_t stream) {
  const int n_bt = (B + TB - 1) / TB;
  const dim3 grid((n_slices + kWarps - 1) / kWarps,
                  n_bt < kMaxGridY ? n_bt : kMaxGridY);
  sliced_ell_spmv_kernel<TB, ACC><<<grid, kThreads, 0, stream>>>(
      values, columns, offsets, widths, x, y, n_slices, n, n_cols, B);
  return static_cast<int>(cudaGetLastError());
}

// signals per thread, from the batch
template <bool ACC>
int dispatch(const void* values, const void* columns, const void* offsets,
             const void* widths, const void* x, void* y, int n_slices,
             long long n, long long n_cols, int B, void* stream) {
  auto v = static_cast<const float*>(values);
  auto c = static_cast<const int*>(columns);
  auto o = static_cast<const int*>(offsets);
  auto w = static_cast<const int*>(widths);
  auto xp = static_cast<const float*>(x);
  auto yp = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (B >= 16)
    return launch<8, ACC>(v, c, o, w, xp, yp, n_slices, n, n_cols, B, s);
  if (B >= 2)
    return launch<2, ACC>(v, c, o, w, xp, yp, n_slices, n, n_cols, B, s);
  return launch<1, ACC>(v, c, o, w, xp, yp, n_slices, n, n_cols, B, s);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// values / columns (stored,) f32 / int32, offsets / widths (n_slices,)
// int32 (core/graph.py::SlicedELL), x and y (B, n) with n_slices =
// ceil(n / 32).  Returns the launch's cudaError_t.
int sliced_ell_spmv_f32(const void* values, const void* columns,
                        const void* offsets, const void* widths,
                        const void* x, void* y, int n_slices, long long n,
                        int B, void* stream) {
  return dispatch<false>(values, columns, offsets, widths, x, y, n_slices,
                         n, n, B, stream);
}

// y += A x for a layout of n rows and n_cols columns: x (B, n_cols),
// y (B, n).
int sliced_ell_spmv_acc_f32(const void* values, const void* columns,
                            const void* offsets, const void* widths,
                            const void* x, void* y, int n_slices,
                            long long n, long long n_cols, int B,
                            void* stream) {
  return dispatch<true>(values, columns, offsets, widths, x, y, n_slices,
                        n, n_cols, B, stream);
}

}  // extern "C"
