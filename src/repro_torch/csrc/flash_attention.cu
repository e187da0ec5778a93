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
// FFMA kernel: f32 throughout from bf16 or f32 inputs (no tensor core, so
// no TF32 in the f32 instance), output in q's type.  A masked score is
// -1e30 and its probability exactly 0; a row with no unmasked column
// keeps l = 0 and writes 0 (the TPU kernel's l > 0 guard).  One thread
// block of 256 threads (8 warps) per (batch, q head, 64-row q tile); the
// heaviest (last) q tiles are scheduled first so the short causal tiles
// fill the tail.  The q tile and each 64-row K / V tile are staged in
// shared memory as f32 (K rows padded to D + 4 floats so the float4
// column reads of a warp hit distinct banks).  Warp w owns q rows
// 8w .. 8w + 7; for the scores lane l computes the columns l and l + 32 of
// those rows (16 dot products of length D, q read as float4 broadcasts),
// then the row max and sum are warp shuffles, and for P V each lane owns
// D / 32 output dimensions (all D of them for D < 32 on the first D lanes)
// and takes the probabilities from the lanes that hold them by shuffle.
// ~97 KB of shared memory at D = 128 leaves room for two blocks per SM.
#include <cuda.h>   // CUtensorMap (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <dlfcn.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;                       // q rows per thread block
constexpr int kBK = 64;                       // k rows per tile
constexpr int kThreads = 256;
constexpr int kRows = kBQ / (kThreads / 32);  // q rows per warp: 8
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Element strides (batch, head, seq) of q, k, v and o; the last axis is
// contiguous.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int DPT>
__device__ __forceinline__ void load_dims(const float* p, float (&out)[DPT]) {
  if constexpr (DPT == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (DPT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides st, int Hq, int group, int Sq, int Sk,
                       int n_qt, int n_bh, float scale, int causal) {
  constexpr int KLD = D + 4;                  // padded K row (floats)
  constexpr int DPT = D >= 32 ? D / 32 : 1;   // output dims per lane
  constexpr int DL = D / DPT;                 // lanes that own dims
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // (kBQ, D)
  float* Ks = Qs + kBQ * D;        // (kBK, KLD)
  float* Vs = Ks + kBK * KLD;      // (kBK, D)

  const int bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;
  const int b = bh / Hq, h = bh % Hq, hk = h / group;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * kRows;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    Qs[e] = q0 + r < Sq
                ? to_f32(qb[static_cast<long long>(q0 + r) * st.q[2] + c])
                : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPT; ++t) acc[i][t] = 0.f;
  }

  int n_kt = (Sk + kBK - 1) / kBK;
  if (causal) {  // k tiles right of the tile's last row are fully masked
    const int last = (q0 + kBQ - 1) / kBK + 1;
    n_kt = n_kt < last ? n_kt : last;
  }
  const int dim0 = lane < DL ? lane * DPT : 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is no longer read (Q staged)
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool ok = k0 + r < Sk;
      const long long row = k0 + r;
      Ks[r * KLD + c] = ok ? to_f32(kb[row * st.k[2] + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f32(vb[row * st.v[2] + c]) : 0.f;
    }
    __syncthreads();

    // scores of rows r0 .. r0 + 7, columns lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k0v = *reinterpret_cast<const float4*>(Ks + lane * KLD + d);
      const float4 k1v =
          *reinterpret_cast<const float4*>(Ks + (lane + 32) * KLD + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (r0 + i) * D + d);
        s[i][0] = fmaf(qv.x, k0v.x, s[i][0]);
        s[i][0] = fmaf(qv.y, k0v.y, s[i][0]);
        s[i][0] = fmaf(qv.z, k0v.z, s[i][0]);
        s[i][0] = fmaf(qv.w, k0v.w, s[i][0]);
        s[i][1] = fmaf(qv.x, k1v.x, s[i][1]);
        s[i][1] = fmaf(qv.y, k1v.y, s[i][1]);
        s[i][1] = fmaf(qv.z, k1v.z, s[i][1]);
        s[i][1] = fmaf(qv.w, k1v.w, s[i][1]);
      }
    }

    // mask, online softmax; s becomes the probabilities
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + r0 + i;
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = k0 + lane + 32 * c;
        ok[c] = col < Sk && (!causal || col <= row);
        s[i][c] = ok[c] ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[i][c] = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        sum += s[i][c];
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(kFull, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < DPT; ++t) acc[i][t] *= corr;
    }

    // acc += P V: probability of column j from the lane that holds it
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        float vv[DPT];
        load_dims<DPT>(Vs + (c * 32 + jj) * D + dim0, vv);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = __shfl_sync(kFull, s[i][c], jj);
#pragma unroll
          for (int t = 0; t < DPT; ++t) acc[i][t] = fmaf(p, vv[t], acc[i][t]);
        }
      }
    }
  }

  if (lane >= DL) return;
  T* ob = o + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Sq) continue;
    const float denom = l[i] > 0.f ? l[i] : 1.f;
    T* orow = ob + static_cast<long long>(row) * st.o[2] + dim0;
#pragma unroll
    for (int t = 0; t < DPT; ++t) store(orow + t, acc[i][t] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int B, int Hq, int Hkv, int Sq, int Sk,
           float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * D + kBK * (D + 4) + kBK * D);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int n_bh = B * Hq;
  const long long blocks = static_cast<long long>(n_qt) * n_bh;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, Hq, Hq / Hkv, Sq, Sk,
      n_qt, n_bh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_dim(int D, const void* q, const void* k, const void* v, void* o,
           const Strides& st, int B, int Hq, int Hkv, int Sq, int Sk,
           float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale, causal,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale,
                            causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

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

// q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), o (B, Hq, Sq, D), all of one
// element type (bf16 = 0: f32, 1: bf16), each addressed through its
// (batch, head, seq) element strides in strides[12] (q, k, v, o) with a
// contiguous last axis.  D in {16, 32, 64, 128}, Hq % Hkv == 0, Sq, Sk
// >= 1.  Returns the launch's cudaError_t.
int flash_attention_fwd(int bf16, int D, const void* q, const void* k,
                        const void* v, void* o, const long long* strides,
                        int B, int Hq, int Hkv, int Sq, int Sk, float scale,
                        int causal, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return by_dim<__nv_bfloat16>(D, q, k, v, o, st, B, Hq, Hkv, Sq, Sk,
                                 scale, causal, s);
  return by_dim<float>(D, q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale, causal,
                       s);
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
