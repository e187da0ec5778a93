// Flash (online-softmax) attention forward for Hopper, causal or full,
// with grouped-query heads:
//
//     o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / g, j])
//                  v[b, h / g, j],        g = Hq / Hkv,
//
// over the columns j <= i when causal (top-left aligned, as the TPU
// kernel masks it), every j < Sk otherwise.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel).  The TPU kernel walked a (batch, q head, q block,
// k block) grid in order on one core, carried the running max, sum and
// accumulator in VMEM scratch across the k blocks and skipped k blocks
// above the diagonal.  Here the k loop runs inside one thread block, the
// running state lives in registers, and the k tiles above the diagonal
// are never visited.  Unlike the TPU kernel, which asserts that Sq and Sk
// are multiples of its 128-row blocks, this one takes any Sq and Sk: it
// zero-fills the rows of a ragged tail tile and masks its columns.
//
// Numerics: f32 throughout from bf16 or f32 inputs (plain FFMA: no
// tensor core, so no TF32 in the f32 instance), output in q's type.  A
// masked score is -1e30 and its probability exactly 0; a row with no
// unmasked column keeps l = 0 and writes 0 (the TPU kernel's l > 0 guard).
//
// What bounds it on this card: operations.  At the starcoder2-3b layer
// shape (B = 2, Hq = 24, Hkv = 2, S = 4096, D = 128, causal) one launch
// does ~2.1e11 multiply-adds-as-two, 0.21 ms at the bf16 tensor-core peak
// and 3.1 ms at the 67 TFLOP/s of the CUDA cores this kernel uses, while
// its ~109 MB of inputs and output take 0.033 ms at 3.35 TB/s.  Tensor
// cores (wgmma), TMA and warp specialisation are a later step.
//
// Design: one thread block of 256 threads (8 warps) per (batch, q head,
// 64-row q tile); the heaviest (last) q tiles are scheduled first so the
// short causal tiles fill the tail.  The q tile and each 64-row K / V tile
// are staged in shared memory as f32 (K rows padded to D + 4 floats so the
// float4 column reads of a warp hit distinct banks).  Warp w owns q rows
// 8w .. 8w + 7; for the scores lane l computes the columns l and l + 32 of
// those rows (16 dot products of length D, q read as float4 broadcasts),
// then the row max and sum are warp shuffles, and for P V each lane owns
// D / 32 output dimensions (all D of them for D < 32 on the first D lanes)
// and takes the probabilities from the lanes that hold them by shuffle.
// ~97 KB of shared memory at D = 128 leaves room for two blocks per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // extern "C"
