// Flash (online-softmax) attention forward for Hopper, causal or full,
// with grouped-query heads:
//
//     o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / g, j])
//                  v[b, h / g, j],        g = Hq / Hkv,
//
// over the columns j <= i when causal (top-left aligned, as the TPU
// kernel masks it), every j < Sk otherwise.  Two kernels: a bf16
// tensor-core kernel for D = 64 and 128 (the LM's heads), and an f32 FFMA
// kernel for f32 inputs and every other head dim.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel).  The TPU kernel walked a (batch, q head, q block,
// k block) grid in order on one core, carried the running max, sum and
// accumulator in VMEM scratch across the k blocks and skipped k blocks
// above the diagonal.  Here the k loop runs inside one thread block, the
// running state lives in registers, and the k tiles above the diagonal
// are never visited.  Unlike the TPU kernel, which asserts that Sq and Sk
// are multiples of its 128-row blocks, both take any Sq and Sk: they
// zero-fill the rows of a ragged tail tile and mask its columns.
//
// What bounds it on this card: operations.  At the starcoder2-3b layer
// shape (B = 2, Hq = 24, Hkv = 2, S = 4096, D = 128, causal) one launch
// does ~2.1e11 multiply-adds-as-two, 0.21 ms at the 989 TFLOP/s bf16
// tensor-core peak and 3.1 ms at the 67 TFLOP/s of the CUDA cores, while
// its ~109 MB of inputs and output take 0.033 ms at 3.35 TB/s.  The
// yardstick is scaled_dot_product_attention: 0.359 ms at that shape on an
// H100 80GB HBM3 at 700 W.
//
// Tensor-core kernel (namespace tc), after FlashAttention-3's layout:
//   - one block of 288 threads per (batch, q head, 128-row q tile): two
//     consumer warpgroups of 64 q rows and one producer warp, ~160 KiB of
//     shared memory at D = 128 (one block per SM);
//   - the producer loads the q tile once and each 128 x D K and V tile by
//     TMA (128-byte swizzle, (64 column, 128 row) boxes, rows past S read
//     as zeros) into a two-stage ring, with full / empty mbarriers;
//   - S = Q K^T is wgmma m64n128k16 from shared memory with f32
//     accumulators (64 registers a thread); the online softmax runs on
//     the accumulator fragment (row max and sum over the quad that shares
//     a row, exp2 with the scale folded in);
//   - P is rounded to bf16 in registers, where the score fragment of 16
//     columns is exactly wgmma's register A fragment, and O += P V is
//     wgmma m64nDk16 with V read N-major through its descriptor;
//   - only the diagonal tile and a ragged last tile are masked; the
//     heaviest q tiles launch first, and the q heads of one GQA group run
//     next to each other so their K and V stay in L2.
//   Numerics: m, l and O stay f32; P is bf16 before P V (the TPU kernel
//   keeps P in f32); a masked probability is exactly 0 and the l > 0
//   guard stays.  Every mbarrier wait traps after ~8 s rather than hang.
//
// FFMA kernel (namespace fp32, flash_attention_ffma_kernel): f32
// arithmetic on the CUDA cores from bf16 or f32 inputs (no tensor core, so
// no TF32), output in q's type, any head dim D from 1 to 256.  What bounds
// it: operations.  At (B 1, Hq 24, Hkv 2, S 1000, D 128, f32, causal) one
// launch does 4 B Hq D S (S + 1) / 2 = 6.15e9 flop, 0.092 ms at the
// 67 TFLOP/s of the CUDA cores, against 26 MB of inputs and output
// (0.008 ms at 3.35 TB/s).  So the design keeps the FFMA pipes fed: every
// shared-memory load serves many FFMAs, and little else waits in line.
//   - Tiles.  D runs on the smallest instantiated width DP in {16, 32,
//     64, 128, 256} with D <= DP; the columns past D are zero in shared
//     memory and are not written out, and the d loop stops at D rounded
//     up to 16 bytes.  One block of 256 threads (8 warps) per (batch,
//     q head, q tile) of BQ = 128 rows, K / V tiles of BK = 64 keys; at
//     DP = 256, BQ = 64 and BK = 32 (the f32 tiles would not fit).
//     Shared memory with f32 inputs: 58624, 83456, 133120, 232448 (all of
//     the 227 KB a block may have) and 209408 bytes at DP = 16 .. 256, so
//     one block per SM at DP >= 64 and two at DP <= 32 (there the
//     launch bound caps the registers at 128).
//   - Threads.  Thread t owns TM = 8 q rows (row group t / CG) and TN
//     consecutive score columns (t % CG) TN of the tile (CG = 16 threads
//     per row group, TN = 4; at DP = 256, CG = 32 and TN = 1), then the
//     TD = DP / CG output dims of its rows.  A row group's CG threads are
//     one warp's half (or all of it), so the row max is CG-lane shuffles
//     once per tile, the row sums stay per thread until the end, and the
//     probabilities P pass through shared memory written and read by that
//     warp alone (__syncwarp).
//   - S = Q K^T as outer products of an 8 x 4 register micro-tile: per d,
//     two broadcast 16-byte loads of the thread's 8 rows of Q^T and one of
//     its 4 columns of K^T feed 32 FFMAs.  Q^T is staged once per block as
//     f32 with scale * log2(e) folded in; K^T is made per tile from the
//     copied rows (widened from bf16 there) by all threads, lanes on
//     consecutive keys, so both sides of the transpose are conflict-free.
//     (cp.async moves 16-byte pieces of a row, so it cannot transpose.)
//   - P V as a second outer product: P is stored key-major (16-byte chunks
//     XOR-swizzled by the key, conflict-free both ways); per key a thread
//     reads its 8 rows of P and its TD dims of V for 8 TD FFMAs.  No
//     shuffles.
//   - Loads.  Each tile's K rows land in one copy buffer and its V rows in
//     a 2-stage ring, by 16-byte cp.async (bf16 stays bf16 in flight; rows
//     past Sk zero-filled), a thread copying a fixed 16-byte column of
//     every (256 / chunks per row)-th row.  Tile kt + 1 is copied while
//     tile kt is computed; two __syncthreads per tile (the copies have
//     landed; K^T is built).  Views whose rows do not start on 16 bytes,
//     and a partial last 16 bytes of D, take an element-wise copy in the
//     same kernel.
//   - The grid.  Blocks go heaviest q tiles first (the q heads of one GQA
//     group next to each other).  When the grid is too small or too
//     uneven for the card (the mean K tiles per resident block slot is
//     below the longest q tile's), the K tiles of each q tile are cut
//     into runs of that mean, one block each: every block of a cut q tile
//     leaves its m, l and unnormalised O in a scratch slot, and the last
//     to finish (an atomic count) merges the slots in run order, so the
//     result does not depend on which finishes last.  One launch either
//     way.
//   - Softmax.  exp2 (ex2.approx) of scores already in log2 units; only a
//     warp's diagonal tiles and the ragged last tile are masked; a warp
//     skips a tile whose keys all lie right of its rows, and rows past
//     Sq.
// Numerics: m, l and O are f32; a masked score is -1e30 and its
// probability exactly 0; a row with no unmasked column keeps l = 0 and
// writes 0 (the TPU kernel's l > 0 guard).
#include <cuda.h>   // CUtensorMap (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <dlfcn.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Element strides (batch, head, seq) of q, k, v and o; the last axis is
// contiguous.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

}  // namespace

namespace fp32 {

constexpr int kThreads = 256;
constexpr int kTM = 8;   // q rows per thread

// The tile shape of one instantiated width DP.
template <int DP>
struct Tile {
  static constexpr int BQ = DP <= 128 ? 128 : 64;   // q rows per block
  static constexpr int BK = DP <= 128 ? 64 : 32;    // keys per K / V tile
  static constexpr int RG = BQ / kTM;               // row groups
  static constexpr int CG = kThreads / RG;          // threads per row group
  static constexpr int TN = BK / CG;                // score columns a thread
  static constexpr int TD = DP / CG;                // output dims a thread
  static constexpr int QLD = BQ + 4;                // Q^T row (one d), f32
  static_assert(CG <= 32 && 32 % CG == 0, "a row group within one warp");
  static_assert(TN >= 1 && TD >= 1, "every thread owns columns and dims");
};

// Shared memory of one block, in elements of each buffer.
template <typename T, int DP>
struct Layout {
  using Tl = Tile<DP>;
  static constexpr int VE = 16 / sizeof(T);   // elements in 16 bytes
  static constexpr int KLD = DP + VE;         // K row as copied (T), padded
  static constexpr int Q = DP * Tl::QLD;      // f32: Q^T, scaled
  static constexpr int KT = DP * Tl::BK;      // f32: K^T
  static constexpr int P = Tl::BK * Tl::BQ;   // f32: P, key-major
  static constexpr int KR = Tl::BK * KLD;     // T: K as copied
  static constexpr int V = 2 * Tl::BK * DP;   // T: two stages
  static constexpr size_t bytes =
      sizeof(float) * (Q + KT + P) + sizeof(T) * (KR + V);
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float lo_bf16(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// N consecutive elements of shared memory (N * sizeof(T) <= 16 bytes,
// aligned to that size) as f32.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    out[0] = lo_bf16(t.x); out[1] = hi_bf16(t.x);
    out[2] = lo_bf16(t.y); out[3] = hi_bf16(t.y);
    out[4] = lo_bf16(t.z); out[5] = hi_bf16(t.z);
    out[6] = lo_bf16(t.w); out[7] = hi_bf16(t.w);
  } else if constexpr (N == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    out[0] = lo_bf16(t.x); out[1] = hi_bf16(t.x);
    out[2] = lo_bf16(t.y); out[3] = hi_bf16(t.y);
  } else if constexpr (N == 2) {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
    out[0] = lo_bf16(t); out[1] = hi_bf16(t);
  } else {
    out[0] = __bfloat162float(p[0]);
  }
}

// N elements to global memory as one vector store (the caller checks
// alignment).
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 1) {
    p[0] = __float2bfloat16_rn(v[0]);
  } else {
    __nv_bfloat162 t[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      t[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    if constexpr (N == 8)
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(t);
    else if constexpr (N == 4)
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(t);
    else
      *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(t);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows k0 .. k0 + BK - 1 of one (batch, KV head) of K or V into a (BK, ld)
// tile of T: the columns below D rounded up to 16 bytes (the rest are not
// written), rows past Sk as zeros.  Thread t copies the 16-byte chunk
// t % CPR of rows t / CPR + i (256 / CPR): by cp.async when `vec` (every
// row starts on 16 bytes) and the chunk lies inside D, else element by
// element.
template <typename T, int DP, int BK>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src,
                                          long long sseq, int k0, int Sk,
                                          int D, bool vec) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int CPR = DP / VE;               // 16-byte chunks in a row
  constexpr int RSTEP = kThreads / CPR;      // rows between its copies
  constexpr int NI = (BK + RSTEP - 1) / RSTEP;
  static_assert(kThreads % CPR == 0, "whole rows per pass");
  const int c = threadIdx.x % CPR, r0 = threadIdx.x / CPR;
  if (c * VE >= D) return;
  if (vec && (c + 1) * VE <= D) {
    const T* s = src + static_cast<long long>(k0 + r0) * sseq + c * VE;
    const long long step = RSTEP * sseq;
#pragma unroll
    for (int i = 0; i < NI; ++i, s += step) {
      const int r = r0 + i * RSTEP;
      if (BK % RSTEP == 0 || r < BK) {
        const bool ok = k0 + r < Sk;
        cp_async16(dst + r * ld + c * VE, ok ? s : src, ok ? 16 : 0);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int r = r0 + i * RSTEP;
      if (BK % RSTEP != 0 && r >= BK) break;
      const bool ok = k0 + r < Sk;
      const T* s = src + static_cast<long long>(k0 + r) * sseq + c * VE;
#pragma unroll
      for (int t = 0; t < VE; ++t)
        dst[r * ld + c * VE + t] = ok && c * VE + t < D ? s[t] : T(0.f);
    }
  }
}

// The 16 bytes (VE elements of T) of a row at s: one 16-byte load when
// `vec` and all of them lie below D (cols >= VE), else element by element
// with the columns at or past `cols` as zeros.
template <typename T>
__device__ __forceinline__ uint4 load_piece(const T* s, int cols, bool vec) {
  constexpr int VE = 16 / sizeof(T);
  if (vec && cols >= VE) return __ldg(reinterpret_cast<const uint4*>(s));
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  T* t = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < VE; ++j)
    if (j < cols) t[j] = s[j];
  return u;
}

// K tiles that q tile qt visits: none right of its last row when causal.
__host__ __device__ __forceinline__ int k_tiles(int qt, int BQ, int BK,
                                                int Sq, int Sk, int causal) {
  const int n = (Sk + BK - 1) / BK;
  if (!causal) return n;
  const int last = (qt * BQ + BQ < Sq ? qt * BQ + BQ : Sq) - 1;
  return n < last / BK + 1 ? n : last / BK + 1;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, DP <= 32 ? 2 : 1)
flash_attention_ffma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            Strides st, int D, int Hq, int group, int Sq,
                            int Sk, int n_qt, int n_bh, float scale_log2,
                            int causal, int vec, int ovec, int chunk,
                            int* __restrict__ counters,
                            float* __restrict__ partials) {
  using Tl = Tile<DP>;
  using L = Layout<T, DP>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, CG = Tl::CG, TN = Tl::TN,
                TD = Tl::TD, QLD = Tl::QLD, VE = L::VE, KLD = L::KLD;
  constexpr int CH = TD < VE ? TD : VE;   // dims of V per load
  constexpr int NC = TD / CH;             // loads of V per key
  constexpr int WROWS = 32 / CG * kTM;    // q rows of one warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qt = reinterpret_cast<float*>(smem_raw);   // (DP, QLD)
  float* Kt = Qt + L::Q;                            // (DP, BK)
  float* Ps = Kt + L::KT;                           // (BK, BQ)
  T* Kr = reinterpret_cast<T*>(Ps + L::P);          // (BK, KLD)
  T* Vs = Kr + L::KR;                               // 2 x (BK, DP)

  // This block's work: K tiles [kt0, kt1) of q tile qt of (batch, head)
  // bh, part `part` of the q tile's `parts` runs of `chunk` K tiles.
  // Blocks go heaviest q tiles first, parts in order, (batch, head) last.
  int bid = blockIdx.x, qt = n_qt - 1, parts = 1, part = 0;
  const int kt_max = k_tiles(n_qt - 1, BQ, BK, Sq, Sk, causal);
  int n_kt = kt_max;
  if (chunk >= kt_max) {
    qt -= bid / n_bh;
    bid %= n_bh;
    n_kt = k_tiles(qt, BQ, BK, Sq, Sk, causal);
  } else {
    for (;; --qt) {
      n_kt = k_tiles(qt, BQ, BK, Sq, Sk, causal);
      parts = (n_kt + chunk - 1) / chunk;
      if (bid < parts * n_bh) break;
      bid -= parts * n_bh;
    }
    part = bid / n_bh;
    bid %= n_bh;
  }
  const int bh = bid;
  const int kt0 = part * chunk;
  const int kt1 = kt0 + chunk < n_kt ? kt0 + chunk : n_kt;
  const int b = bh / Hq, h = bh % Hq, hk = h / group;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const int w_row0 = q0 + tid / 32 * WROWS;      // this warp's first q row
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];

  copy_tile<T, DP, BK>(Kr, KLD, kb, st.k[2], kt0 * BK, Sk, D, vec);
  copy_tile<T, DP, BK>(Vs + (kt0 & 1) * BK * DP, DP, vb, st.v[2], kt0 * BK,
                       Sk, D, vec);
  cp_async_commit();

  // V's columns past D (rounded up to 16 bytes), which no copy writes and
  // P V reads (K's are never read: the d loop stops at dz)
  const int dz = (D + VE - 1) / VE * VE;
  {
    // Q^T once, as f32 with scale * log2(e) folded in: thread t takes the
    // 16-byte pieces (row e % BQ, piece e / BQ) of e = t + 256 i, every
    // load in flight before the first store; lanes on consecutive rows
    // make the transposed stores conflict-free
    constexpr int NQ = BQ * (DP / VE) / kThreads;
    uint4 piece[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int e = tid + i * kThreads, r = e % BQ, c = e / BQ;
      piece[i] = make_uint4(0u, 0u, 0u, 0u);
      if (c * VE < dz && q0 + r < Sq)
        piece[i] = load_piece(
            qb + static_cast<long long>(q0 + r) * st.q[2] + c * VE,
            D - c * VE, vec);
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int e = tid + i * kThreads, r = e % BQ, c = e / BQ;
      if (c * VE >= dz) continue;
      float f[VE];
      load_f32<VE>(reinterpret_cast<const T*>(&piece[i]), f);
#pragma unroll
      for (int u = 0; u < VE; ++u)
        Qt[(c * VE + u) * QLD + r] = f[u] * scale_log2;
    }
  }
  if (dz < DP) {
    for (int e = tid; e < 2 * BK * DP; e += kThreads)
      if (e % DP >= dz) Vs[e] = T(0.f);
  }

  float m[kTM], l[kTM], acc[kTM][TD];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < TD; ++t) acc[i][t] = 0.f;
  }
  const float* qcol = Qt + rg * kTM;   // + d QLD: this thread's 8 rows at d
  const float* kcol = Kt + cg * TN;    // + d BK: its TN columns at d

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    const T* Vt = Vs + (kt & 1) * BK * DP;
    cp_async_wait_all();
    __syncthreads();   // K and V of tile kt are in; every warp is done
                       // with tile kt - 1
    if (kt + 1 < kt1)
      copy_tile<T, DP, BK>(Vs + ((kt + 1) & 1) * BK * DP, DP, vb, st.v[2],
                           k0 + BK, Sk, D, vec);
    // K^T of the chunks below dz, widened to f32: lanes take consecutive
    // keys
    for (int e = tid; e < BK * (dz / VE); e += kThreads) {
      const int r = e % BK, c = e / BK;
      float t[VE];
      load_f32<VE>(Kr + r * KLD + c * VE, t);
#pragma unroll
      for (int u = 0; u < VE; ++u) Kt[(c * VE + u) * BK + r] = t[u];
    }
    __syncthreads();   // K^T is complete and the copy buffer free
    if (kt + 1 < kt1)
      copy_tile<T, DP, BK>(Kr, KLD, kb, st.k[2], k0 + BK, Sk, D, vec);
    cp_async_commit();   // K and V of tile kt + 1 fly during this one

    // a warp whose rows all lie left of the tile (causal), or past Sq,
    // has nothing to add
    const bool skip = (causal && k0 > w_row0 + WROWS - 1) || w_row0 >= Sq;
    // the warp's diagonal tiles (causal) and the ragged last tile
    const bool masked = (causal && k0 + BK - 1 > w_row0) || k0 + BK > Sk;
    if (skip) continue;
    // S = Q K^T (log2 units) as outer products over d: per d, this
    // thread's 8 rows of Q^T and TN columns of K^T
    float sc[kTM][TN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < dz; d0 += 4) {
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float* qd = qcol + (d0 + dd) * QLD;
        const float4 qa = *reinterpret_cast<const float4*>(qd);
        const float4 qb4 = *reinterpret_cast<const float4*>(qd + 4);
        const float a[kTM] = {qa.x, qa.y, qa.z, qa.w,
                              qb4.x, qb4.y, qb4.z, qb4.w};
        float kk[TN];
        load_f32<TN>(kcol + (d0 + dd) * BK, kk);
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
      }
    }
    if (masked) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int row = q0 + rg * kTM + i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = k0 + cg * TN + j;
          if (col >= Sk || (causal && col > row)) sc[i][j] = kNegInf;
        }
      }
    }

    // online softmax: the row max over the row group's CG lanes, the
    // sums kept per thread; sc becomes P
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mx = fmaxf(mx, sc[i][j]);
#pragma unroll
      for (int off = CG / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float p = fast_exp2(sc[i][j] - m_new);
        if (masked && sc[i][j] == kNegInf) p = 0.f;
        sc[i][j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int t = 0; t < TD; ++t) acc[i][t] *= corr;
    }

    // P to shared memory, key-major: key j holds the rows as 16-byte
    // chunks, chunk c at position c ^ ((j / TN) & 7)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int key = cg * TN + j, sw = cg & 7;
      float* pj = Ps + key * BQ;
      *reinterpret_cast<float4*>(pj + ((2 * rg) ^ sw) * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      *reinterpret_cast<float4*>(pj + ((2 * rg + 1) ^ sw) * 4) =
          make_float4(sc[4][j], sc[5][j], sc[6][j], sc[7][j]);
    }
    __syncwarp();   // a row group's P is written and read by its own warp

    // acc += P V: per key, this thread's 8 rows of P and TD dims of V
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      const float* pj = Ps + j * BQ;
      const int sw = (j / TN) & 7;
      const float4 pa =
          *reinterpret_cast<const float4*>(pj + ((2 * rg) ^ sw) * 4);
      const float4 pb =
          *reinterpret_cast<const float4*>(pj + ((2 * rg + 1) ^ sw) * 4);
      const float p[kTM] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vv[TD];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        load_f32<CH>(Vt + j * DP + (c * CG + cg) * CH, vv + c * CH);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int t = 0; t < TD; ++t) acc[i][t] = fmaf(p[i], vv[t], acc[i][t]);
    }
    __syncwarp();   // P is read before the next tile overwrites it
  }

  // the row sums over the row group
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int off = CG / 2; off > 0; off /= 2)
      l[i] += __shfl_xor_sync(kFull, l[i], off);

  if (parts > 1) {
    // One part of a split q tile: leave m, l and the unnormalised acc in
    // this part's slot (BQ m, BQ l, BQ x DP acc); the last part of the q
    // tile to finish merges every slot, in part order, and stores.
    const size_t slot = static_cast<size_t>(BQ) * (DP + 2);
    const int pmax = (kt_max + chunk - 1) / chunk;
    float* base = partials + static_cast<size_t>(qt * n_bh + bh) * pmax * slot;
    float* mine = base + part * slot;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = rg * kTM + i;
      if (cg == 0) {
        mine[r] = m[i];
        mine[BQ + r] = l[i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int t = 0; t < CH; ++t)
          mine[2 * BQ + r * DP + (c * CG + cg) * CH + t] = acc[i][c * CH + t];
    }
    __threadfence();   // every thread's part of the slot is visible ...
    __syncthreads();   // ... before the count says so
    int last = 0;
    if (tid == 0) last = atomicAdd(counters + qt * n_bh + bh, 1) == parts - 1;
    if (!__syncthreads_or(last)) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = rg * kTM + i;
      float mx = kNegInf;
      for (int p = 0; p < parts; ++p)
        mx = fmaxf(mx, __ldcg(base + p * slot + r));
      l[i] = 0.f;
#pragma unroll
      for (int t = 0; t < TD; ++t) acc[i][t] = 0.f;
      for (int p = 0; p < parts; ++p) {
        const float* sp = base + p * slot;
        const float w = fast_exp2(__ldcg(sp + r) - mx);
        l[i] = fmaf(w, __ldcg(sp + BQ + r), l[i]);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int t = 0; t < CH; ++t)
            acc[i][c * CH + t] = fmaf(
                w, __ldcg(sp + 2 * BQ + r * DP + (c * CG + cg) * CH + t),
                acc[i][c * CH + t]);
      }
    }
  }

  // the l > 0 guard and the stores
  T* ob = o + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
    const int row = q0 + rg * kTM + i;
    if (row >= Sq) continue;
    T* orow = ob + static_cast<long long>(row) * st.o[2];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d0 = (c * CG + cg) * CH;
      float out[CH];
#pragma unroll
      for (int t = 0; t < CH; ++t) out[t] = acc[i][c * CH + t] * inv;
      if (ovec && d0 + CH <= D) {
        store_vec<CH>(orow + d0, out);
      } else {
#pragma unroll
        for (int t = 0; t < CH; ++t)
          if (d0 + t < D) store(orow + d0 + t, out[t]);
      }
    }
  }
}

// Whether a view's rows all start on 16 bytes: its base does and each of
// its (batch, head, seq) strides is a whole number of 16 bytes.
template <typename T>
bool rows_aligned(const void* p, const long long* s) {
  constexpr long long VE = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[0] % VE == 0
         && s[1] % VE == 0 && s[2] % VE == 0;
}

// How a launch splits the K tiles of its q tiles over blocks: `chunk` K
// tiles a block (no q tile split when chunk >= the most K tiles of any),
// the blocks, and the scratch a split needs (a counter per (q tile,
// batch, head) and a slot of BQ (DP + 2) floats per part).  The chunk is
// the mean K tiles per resident block slot of the card (at least 2), so
// that a grid too small or too uneven for the SMs has no block much
// longer than that mean.
struct Split {
  int chunk;
  long long blocks, counters, partials;
};

// Blocks of a launch that cuts each q tile's K tiles into runs of chunk.
template <int DP>
long long grid_blocks(long long n_bh, int Sq, int Sk, int causal,
                      int chunk) {
  using Tl = Tile<DP>;
  long long blocks = 0;
  for (int qt = 0; qt * Tl::BQ < Sq; ++qt)
    blocks += (k_tiles(qt, Tl::BQ, Tl::BK, Sq, Sk, causal) + chunk - 1)
              / chunk;
  return blocks * n_bh;
}

template <typename T, int DP>
int split(int B, int Hq, int Sq, int Sk, int causal, Split* out) {
  using Tl = Tile<DP>;
  auto kern = flash_attention_ffma_kernel<T, DP>;
  const int smem = static_cast<int>(Layout<T, DP>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (Sq + Tl::BQ - 1) / Tl::BQ;
  const long long n_bh = static_cast<long long>(B) * Hq;
  const int kt_max = k_tiles(n_qt - 1, Tl::BQ, Tl::BK, Sq, Sk, causal);
  long long work = 0;
  for (int qt = 0; qt < n_qt; ++qt)
    work += k_tiles(qt, Tl::BQ, Tl::BK, Sq, Sk, causal);
  work *= n_bh;
  const long long slots =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  long long chunk = (work + slots - 1) / slots;   // the mean
  chunk = chunk < 2 ? 2 : chunk;
  *out = Split{kt_max, n_qt * n_bh, 0, 0};
  if (chunk >= kt_max) return static_cast<int>(cudaSuccess);
  out->chunk = static_cast<int>(chunk);
  out->blocks = grid_blocks<DP>(n_bh, Sq, Sk, causal, out->chunk);
  out->counters = n_qt * n_bh;
  out->partials = out->counters * ((kt_max + out->chunk - 1) / out->chunk)
                  * Tl::BQ * (DP + 2);
  return static_cast<int>(cudaSuccess);
}

template <typename T, int DP>
int launch(int D, const void* q, const void* k, const void* v, void* o,
           const Strides& st, int B, int Hq, int Hkv, int Sq, int Sk,
           float scale, int causal, int chunk, void* counters,
           void* partials, cudaStream_t stream) {
  using Tl = Tile<DP>;
  const size_t smem = Layout<T, DP>::bytes;
  auto kern = flash_attention_ffma_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (Sq + Tl::BQ - 1) / Tl::BQ;
  const int n_bh = B * Hq;
  const int kt_max = k_tiles(n_qt - 1, Tl::BQ, Tl::BK, Sq, Sk, causal);
  if (chunk < 1 || (chunk < kt_max && (counters == nullptr
                                       || partials == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = grid_blocks<DP>(n_bh, Sq, Sk, causal, chunk);
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = rows_aligned<T>(q, st.q) && rows_aligned<T>(k, st.k)
                  && rows_aligned<T>(v, st.v);
  const int ovec = rows_aligned<T>(o, st.o);
  const float kLog2e = 1.4426950408889634f;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, D, Hq, Hq / Hkv, Sq,
      Sk, n_qt, n_bh, scale * kLog2e, causal, vec, ovec, chunk,
      static_cast<int*>(counters), static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, DP>) for the smallest instantiated width
// DP >= D; cudaErrorInvalidValue outside 1 <= D <= 256.
template <typename F>
int with_width(int D, F&& f) {
  if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 16) return f(std::integral_constant<int, 16>{});
  if (D <= 32) return f(std::integral_constant<int, 32>{});
  if (D <= 64) return f(std::integral_constant<int, 64>{});
  if (D <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

template <typename T>
int by_dim(int D, const void* q, const void* k, const void* v, void* o,
           const Strides& st, int B, int Hq, int Hkv, int Sq, int Sk,
           float scale, int causal, int chunk, void* counters,
           void* partials, cudaStream_t stream) {
  return with_width(D, [&](auto w) {
    return launch<T, decltype(w)::value>(D, q, k, v, o, st, B, Hq, Hkv, Sq,
                                         Sk, scale, causal, chunk, counters,
                                         partials, stream);
  });
}

// Registers per thread, shared memory bytes, resident blocks per SM, q
// rows per block and keys per tile of the instance that serves head dim D.
template <typename T>
int info(int D, int* out) {
  return with_width(D, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    auto kern = flash_attention_ffma_kernel<T, DP>;
    const int smem = static_cast<int>(Layout<T, DP>::bytes);
    cudaFuncAttributes attr{};
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                          kThreads, smem);
    out[0] = attr.numRegs;
    out[1] = smem;
    out[2] = blocks;
    out[3] = Tile<DP>::BQ;
    out[4] = Tile<DP>::BK;
    return static_cast<int>(err);
  });
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel (wgmma, TMA, mbarriers), D in {64, 128}
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBM = 128;              // q rows per block: two warpgroups
constexpr int kBN = 128;              // k rows per tile
constexpr int kStages = 2;            // K / V ring depth
constexpr int kConsumerThreads = 256;  // warpgroups 0 and 1
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kPanelCols = 64;        // bf16 columns in one 128-byte row
constexpr int kConsumerWarps = kConsumerThreads / 32;
// A barrier wait longer than this many SM cycles (~8 s) is a fault:
// trap rather than hang the card.
constexpr long long kWaitLimit = 1LL << 34;

// Shared memory of one block.  Each tile is D / 64 panels of (rows, 64)
// bf16, 128-byte rows in TMA's 128-byte swizzle, every panel on a
// 1024-byte boundary, as the wgmma descriptors expect.
template <int D>
struct Smem {
  __nv_bfloat16 q[kBM * D];
  __nv_bfloat16 k[kStages][kBN * D];
  __nv_bfloat16 v[kStages][kBN * D];
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  long long t0 = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 < 0) t0 = now;
    else if (now - t0 > kWaitLimit) __trap();
  }
}

// One TMA box of a 4-D tensor map into shared memory, completion counted
// in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving register reads and writes of a wgmma
// accumulator across the asynchronous instructions.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// d[0:64] (+)= A(64 x 16, smem desc) * B(128 x 16, smem desc)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0:64] += A(64 x 16, registers) * B(16 x 128, smem desc, N-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:32] += A(64 x 16, registers) * B(16 x 64, smem desc, N-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n64(o, a, db);
}

// One block: 128 q rows of one (batch, q head), as two consumer
// warpgroups of 64 rows, and one producer warp that keeps TMA loads of
// the K / V tiles in flight through a two-stage ring.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                             const __grid_constant__ CUtensorMap tmk,
                             const __grid_constant__ CUtensorMap tmv,
                             __nv_bfloat16* __restrict__ o,
                             long long o_sb, long long o_sh, long long o_ss,
                             int Hq, int group, int Sq, int Sk, int n_qt,
                             int n_bh, float scale_log2, int causal) {
  constexpr int kPanels = D / kPanelCols;
  constexpr int kPanelBytes = kBM * 128;   // (128 rows, 64 cols) bf16
  constexpr uint32_t kTileBytes = kBN * D * 2;
  static_assert(kBM == kBN, "one panel size for q, k and v tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      smem_raw + ((1024 - (raw & 1023)) & 1023));

  const int bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;   // heaviest tiles first
  const int b = bh / Hq, h = bh % Hq, hk = h / group;
  const int q0 = qt * kBM;
  int n_kt = (Sk + kBN - 1) / kBN;
  if (causal && n_kt > qt + 1) n_kt = qt + 1;    // tiles right of the
                                                 // diagonal: all masked
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer: one thread issues every TMA load ----
    if (threadIdx.x != kConsumerThreads) return;
    mbar_expect_tx(&sm.q_full, kBM * D * 2);
    for (int p = 0; p < kPanels; ++p)
      tma_load_4d(sm.q + p * kBM * kPanelCols, &tmq, &sm.q_full,
                  p * kPanelCols, q0, h, b);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      if (kt >= kStages) mbar_wait(&sm.empty[s], (kt / kStages - 1) & 1);
      mbar_expect_tx(&sm.k_full[s], kTileBytes);
      for (int p = 0; p < kPanels; ++p)
        tma_load_4d(sm.k[s] + p * kBN * kPanelCols, &tmk, &sm.k_full[s],
                    p * kPanelCols, kt * kBN, hk, b);
      mbar_expect_tx(&sm.v_full[s], kTileBytes);
      for (int p = 0; p < kPanels; ++p)
        tma_load_4d(sm.v[s] + p * kBN * kPanelCols, &tmv, &sm.v_full[s],
                    p * kPanelCols, kt * kBN, hk, b);
    }
    return;
  }

  // ---- consumers: warpgroup g owns q rows q0 + 64 g .. q0 + 64 g + 63 ----
  const int g = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  // this thread's two rows of the accumulator fragments (r and r + 8)
  const int row0 = q0 + 64 * g + (t / 32) * 16 + lane / 4;
  const int col_in = 2 * (lane % 4);   // first column within an 8-column chunk
  const uint32_t q_base = smem_u32(sm.q) + g * 64 * 128;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(&sm.q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    const int parity = (kt / kStages) & 1;
    const int k0 = kt * kBN;

    // S = Q K^T: (64, 128) f32, D / 16 k-steps, both operands K-major
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    mbar_wait(&sm.k_full[s], parity);
    const uint32_t k_base = smem_u32(sm.k[s]);
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      wgmma_ss_n128(sc, desc_sw128(q_base + off, 16, 1024),
                    desc_sw128(k_base + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // mask the diagonal tile (causal) and the ragged last tile
    const bool masked = (causal && k0 + kBN - 1 > q0 + 64 * g)
                        || k0 + kBN > Sk;
    if (masked) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * i + col_in + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (col >= Sk || (causal && col > row)) sc[4 * i + e] = kNegInf;
        }
      }
    }

    // online softmax on the fragment: rows row0 (e < 2) and row0 + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float corr = exp2f((m[r] - mx) * scale_log2);
      const float msc = mx * scale_log2;
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(sc[4 * i + 2 * r + e], scale_log2,
                                     -msc));
          sc[4 * i + 2 * r + e] = p;
          sum += p;
        }
      }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * r] *= corr;
        acc[4 * j + 2 * r + 1] *= corr;
      }
    }

    // P in bf16 as wgmma's register A operand: the score fragment of
    // columns 16 kk .. 16 kk + 15 is the A fragment of k-step kk
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V: V (128 keys, D) is N-major; 8 k-steps of 16 keys
    mbar_wait(&sm.v_full[s], parity);
    const uint32_t v_base = smem_u32(sm.v[s]);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_pv<D>(acc, pa[kk],
                  desc_sw128(v_base + kk * 16 * 128, kPanelBytes, 1024));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);   // the stage may be refilled
  }

  // epilogue: row sums over the quad, the l > 0 guard, bf16 stores
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = ob + static_cast<long long>(row) * o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col_in) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                acc[4 * j + 2 * r + 1] * inv);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda.so.1 at run time: the
// library is not linked against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// (D, S, H, B) bf16 view with element strides (seq, head, batch), read in
// (64, 128) boxes with the 128-byte swizzle; rows past S read as zeros.
bool make_map(CUtensorMap* map, const void* base, int D, int S, int H, int B,
              long long ss, long long sh, long long sb) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kPanelCols, kBN, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int Hq, int Hkv, int Sq, int Sk,
           float scale, int causal, cudaStream_t stream) {
  CUtensorMap tmq, tmk, tmv;
  if (!make_map(&tmq, q, D, Sq, Hq, B, st[2], st[1], st[0])
      || !make_map(&tmk, k, D, Sk, Hkv, B, st[5], st[4], st[3])
      || !make_map(&tmv, v, D, Sk, Hkv, B, st[8], st[7], st[6]))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(Smem<D>) + 1024;   // + alignment slack
  auto kern = flash_attention_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (Sq + kBM - 1) / kBM;
  const int n_bh = B * Hq;
  const long long blocks = static_cast<long long>(n_qt) * n_bh;
  const float kLog2e = 1.4426950408889634f;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      tmq, tmk, tmv, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11],
      Hq, Hq / Hkv, Sq, Sk, n_qt, n_bh, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// How flash_attention_fwd splits this call's K tiles over blocks on the
// current card: out[4] = the chunk to pass it, the blocks it launches,
// and the int32 counters (zeroed) and f32 partials it needs (0 and 0 when
// no q tile is split).  Returns the queries' cudaError_t.
int flash_attention_fwd_split(int bf16, int D, int B, int Hq, int Sq,
                              int Sk, int causal, long long* out) {
  fp32::Split sp{};
  const int err = fp32::with_width(D, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    return bf16 ? fp32::split<__nv_bfloat16, DP>(B, Hq, Sq, Sk, causal, &sp)
                : fp32::split<float, DP>(B, Hq, Sq, Sk, causal, &sp);
  });
  out[0] = sp.chunk;
  out[1] = sp.blocks;
  out[2] = sp.counters;
  out[3] = sp.partials;
  return err;
}

// q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), o (B, Hq, Sq, D), all of one
// element type (bf16 = 0: f32, 1: bf16), each addressed through its
// (batch, head, seq) element strides in strides[12] (q, k, v, o) with a
// contiguous last axis.  1 <= D <= 256, Hq % Hkv == 0, Sq, Sk >= 1; chunk,
// counters and partials as flash_attention_fwd_split gives them.  Returns
// the launch's cudaError_t (cudaErrorInvalidValue for a D past 256, 2^31
// blocks or more, or a split without its scratch).
int flash_attention_fwd(int bf16, int D, const void* q, const void* k,
                        const void* v, void* o, const long long* strides,
                        int B, int Hq, int Hkv, int Sq, int Sk, float scale,
                        int causal, int chunk, void* counters, void* partials,
                        void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fp32::by_dim<__nv_bfloat16>(D, q, k, v, o, st, B, Hq, Hkv, Sq,
                                       Sk, scale, causal, chunk, counters,
                                       partials, s);
  return fp32::by_dim<float>(D, q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale,
                             causal, chunk, counters, partials, s);
}

// The FFMA kernel that serves head dim D for f32 (bf16 = 0) or bf16
// inputs: out[5] = registers per thread, dynamic shared memory bytes,
// resident blocks per SM, q rows per block, keys per K / V tile.  Returns
// the queries' cudaError_t.
int flash_attention_ffma_info(int bf16, int D, int* out) {
  return bf16 ? fp32::info<__nv_bfloat16>(D, out) : fp32::info<float>(D, out);
}

// The bf16 tensor-core kernel: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D),
// o (B, Hq, Sq, D), addressed as above, D in {64, 128}.  Every (batch,
// head, seq) stride of q, k and v is a positive multiple of 8 elements,
// in any order, and q, k, v start on 16 bytes (TMA's rules; the caller
// checks); scale > 0.  Returns the launch's cudaError_t (cudaErrorInvalidValue
// when a tensor map cannot be made).
int flash_attention_wgmma_fwd(int D, const void* q, const void* k,
                              const void* v, void* o,
                              const long long* strides, int B, int Hq,
                              int Hkv, int Sq, int Sk, float scale,
                              int causal, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return tc::launch<64>(q, k, v, o, strides, B, Hq, Hkv, Sq, Sk, scale,
                            causal, s);
    case 128:
      return tc::launch<128>(q, k, v, o, strides, B, Hq, Hkv, Sq, Sk, scale,
                             causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
