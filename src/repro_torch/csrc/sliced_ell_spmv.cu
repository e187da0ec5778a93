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
// The second entry, coupling_spmv_f32, is the couplings' kernel; its note
// stands above it.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                  // slices per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGridY = 65535;

// y (B, n) = A x for x (B, n_cols).
template <int TB>
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
        y[(b0 + t) * n + row] = acc[t];
      }
    }
  }
}

template <int TB>
int launch(const float* values, const int* columns, const int* offsets,
           const int* widths, const float* x, float* y, int n_slices,
           long long n, long long n_cols, int B, cudaStream_t stream) {
  const int n_bt = (B + TB - 1) / TB;
  const dim3 grid((n_slices + kWarps - 1) / kWarps,
                  n_bt < kMaxGridY ? n_bt : kMaxGridY);
  sliced_ell_spmv_kernel<TB><<<grid, kThreads, 0, stream>>>(
      values, columns, offsets, widths, x, y, n_slices, n, n_cols, B);
  return static_cast<int>(cudaGetLastError());
}

// signals per thread, from the batch
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
    return launch<8>(v, c, o, w, xp, yp, n_slices, n, n_cols, B, s);
  if (B >= 2)
    return launch<2>(v, c, o, w, xp, yp, n_slices, n, n_cols, B, s);
  return launch<1>(v, c, o, w, xp, yp, n_slices, n, n_cols, B, s);
}

// ---------------------------------------------------------------------------
// The couplings of a general partition's shard: y += C r.
//
// Replaces: no Pallas kernel.  The JAX package adds a shard's couplings with
// one scatter per ring offset, y.at[..., rows].add(vals * take(rv, cols))
// (src/repro/dist/partition.py:783-785); the port first served them with an
// accumulating instance of the SpMV above, over every row of the shard.
//
// C holds the cut edges from the shard's rows to the tiles it receives, one
// (B, h_k) tile per ring offset k.  Its layout (kernels/bcsr_spmv.py::
// CouplingLayout, packed once per plan on the card) keeps only the m rows
// of y that hold an entry, as a sorted int32 map (compacted row i is row
// rows[i] of y), and slices those rows in 32s; each stored column names its
// tile and its column there, (local << kTileBits) | k, and each slice's
// offset and width sit side by side.
//
// What bounds it on this card: bytes.  nnz * 8 (value and column) + B *
// (sum_k h_k + 2 m) * 4 (the tiles read once, y read and written at the
// rows that hold an entry): 0.00334 ms at the community graph's rank 0
// (nnz 54879, 60918 columns, m 53563, B 16), where the operations take a
// tenth of that.  y moves in 32-byte sectors, though, and those m rows lie
// in 17399 of its 31250 sectors per signal, so y alone costs ~18 MB and
// the bound over sectors is ~0.0066 ms; each entry's B gathers are B
// sectors of the tile (a tile's signals are h_k apart).  The launch is
// short: ~1700 slices.
//
// What the design does about it:
//   - the grid covers the compacted slices only, never a slice without an
//     entry; a lane owns one compacted row and stores y at rows[i];
//   - a batch of up to 16 signals is one tile of TB = 16 registers, so C's
//     structure is read once at B = 16 (larger batches, such as the
//     adjoint's B eta = 112, take tiles of 8);
//   - a slice's offset and width are one 8-byte load, and y's old values
//     are loaded before the row's sum, so their latency hides under it;
//   - the gathers dominate (TB of them per entry, h_k apart in a tile's
//     rows), so a lane skips the slots past its row's last entry (value
//     0: the layout keeps no zero entry) and gathers for real ones only;
//   - the tiles are read where they arrived: a table of up to kMaxTiles
//     (pointer, row stride) pairs, passed by value as a kernel parameter
//     and staged in shared memory, so no round joins them into one tensor
//     (a joined r is the same table over column slices of r).
// Arithmetic: each row's entries are summed from 0 in increasing column
// order in f32 FFMA (no tensor core, so no TF32), then added to y's old
// value; one thread per row and no atomics, so two launches on the same
// inputs give the same bits, and for finite tiles those of the accumulating
// SpMV instance this entry replaced: the rows' sums run over the same
// entries in the same order, and that instance's padding added 0 x r to
// them (it differs only where a sum is -0).  A
// partition with more than kMaxTiles offsets is launched once per group of
// kMaxTiles consecutive offsets, in offset order, each group with its own
// compacted layout (kernels/bcsr_spmv.py::tile_groups): y then takes the
// groups' row sums in turn, ((y + s_0) + s_1) + ..., which may differ from
// y + (s_0 + s_1 + ...) in the last bits.

constexpr int kMaxTiles = 32;  // the tile table's capacity
constexpr int kTileBits = 5;   // a stored column is (local << 5) | tile

struct TileTable {
  const float* ptr[kMaxTiles];
  long long stride[kMaxTiles];  // elements from one signal's row to the next
};

template <int TB>
__global__ void __launch_bounds__(kThreads)
coupling_spmv_kernel(const float* __restrict__ values,
                     const int* __restrict__ columns,
                     const int2* __restrict__ slices,
                     const int* __restrict__ rows, const TileTable table,
                     float* __restrict__ y, int n_slices, int m, long long n,
                     int B) {
  __shared__ const float* s_ptr[kMaxTiles];
  __shared__ long long s_stride[kMaxTiles];
  if (threadIdx.x < kMaxTiles) {
#pragma unroll
    for (int k = 0; k < kMaxTiles; ++k) {  // static indices: no local copy
      if (threadIdx.x == k) {
        s_ptr[k] = table.ptr[k];
        s_stride[k] = table.stride[k];
      }
    }
  }
  __syncthreads();
  const int slice = blockIdx.x * kWarps + threadIdx.x / 32;
  if (slice >= n_slices) return;
  const int lane = threadIdx.x % 32;
  const int2 ow = slices[slice];  // (offset, width)
  const float* v = values + ow.x + lane;
  const int* c = columns + ow.x + lane;
  const int i = slice * 32 + lane;
  const bool live = i < m;  // lanes past m in the last slice store nothing
  const long long row = live ? rows[i] : 0;
  const int n_bt = (B + TB - 1) / TB;
  for (int bt = blockIdx.y; bt < n_bt; bt += gridDim.y) {
    const int b0 = bt * TB;
    const int nb = B - b0 < TB ? B - b0 : TB;
    float* yb = y + b0 * n + row;
    float old[TB], acc[TB];
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      old[t] = live && t < nb ? yb[t * n] : 0.f;
      acc[t] = 0.f;
    }
    if (nb == TB) {
#pragma unroll 2
      for (int j = 0; j < ow.y; ++j) {
        const float a = v[32 * j];
        if (a == 0.f) continue;  // padding: no gathers
        const int e = c[32 * j];
        const int k = e & (kMaxTiles - 1);
        const long long st = s_stride[k];
        const float* x = s_ptr[k] + b0 * st + (e >> kTileBits);
#pragma unroll
        for (int t = 0; t < TB; ++t) acc[t] = fmaf(a, x[t * st], acc[t]);
      }
    } else {  // the ragged last tile of signals
      for (int j = 0; j < ow.y; ++j) {
        const float a = v[32 * j];
        if (a == 0.f) continue;
        const int e = c[32 * j];
        const int k = e & (kMaxTiles - 1);
        const long long st = s_stride[k];
        const float* x = s_ptr[k] + b0 * st + (e >> kTileBits);
#pragma unroll
        for (int t = 0; t < TB; ++t)
          if (t < nb) acc[t] = fmaf(a, x[t * st], acc[t]);
      }
    }
    if (live) {
#pragma unroll
      for (int t = 0; t < TB; ++t)
        if (t < nb) yb[t * n] = old[t] + acc[t];
    }
  }
}

template <int TB>
int launch_coupling(const float* values, const int* columns,
                    const int2* slices, const int* rows,
                    const TileTable& table, float* y, int n_slices, int m,
                    long long n, int B, unsigned gx, unsigned gy,
                    cudaStream_t stream) {
  coupling_spmv_kernel<TB><<<dim3(gx, gy), kThreads, 0, stream>>>(
      values, columns, slices, rows, table, y, n_slices, m, n, B);
  return static_cast<int>(cudaGetLastError());
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
  return dispatch(values, columns, offsets, widths, x, y, n_slices, n, n,
                  B, stream);
}

// One coupling launch's arguments, filled by the wrapper
// (kernels/bcsr_spmv.py::_CouplingArgs, field for field): the group's
// compacted layout (values / columns (stored,) f32 / int32, slices
// (n_slices, 2) int32 (offset, width), rows (m,) int32 into y (B, n)), its
// n_tiles <= 32 tiles at tile_ptrs[k] with rows tile_strides[k] elements
// apart, tb (1, 4, 8 or 16) signals per thread and the grid (gx, gy)
// from kernels/bcsr_spmv.py::coupling_launch.  One pointer crosses from
// Python per launch, so the call costs the host little.
struct CouplingArgs {
  const void* values;
  const void* columns;
  const void* slices;
  const void* rows;
  void* y;
  void* stream;
  long long n;
  int n_slices;
  int m;
  int B;
  int tb;
  int n_tiles;
  unsigned gx;
  unsigned gy;
  const void* tile_ptrs[kMaxTiles];
  long long tile_strides[kMaxTiles];
};

// y += C r for one group of a compacted coupling layout (see the note
// above coupling_spmv_kernel).  Returns the launch's cudaError_t.
int coupling_spmv_f32(const CouplingArgs* a) {
  if (a->n_tiles < 1 || a->n_tiles > kMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  TileTable table{};
  for (int k = 0; k < a->n_tiles; ++k) {
    table.ptr[k] = static_cast<const float*>(a->tile_ptrs[k]);
    table.stride[k] = a->tile_strides[k];
  }
  auto v = static_cast<const float*>(a->values);
  auto c = static_cast<const int*>(a->columns);
  auto sl = static_cast<const int2*>(a->slices);
  auto r = static_cast<const int*>(a->rows);
  auto yp = static_cast<float*>(a->y);
  auto s = static_cast<cudaStream_t>(a->stream);
  switch (a->tb) {
    case 16:
      return launch_coupling<16>(v, c, sl, r, table, yp, a->n_slices, a->m,
                                 a->n, a->B, a->gx, a->gy, s);
    case 8:
      return launch_coupling<8>(v, c, sl, r, table, yp, a->n_slices, a->m,
                                a->n, a->B, a->gx, a->gy, s);
    case 4:
      return launch_coupling<4>(v, c, sl, r, table, yp, a->n_slices, a->m,
                                a->n, a->B, a->gx, a->gy, s);
    case 1:
      return launch_coupling<1>(v, c, sl, r, table, yp, a->n_slices, a->m,
                                a->n, a->B, a->gx, a->gy, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
