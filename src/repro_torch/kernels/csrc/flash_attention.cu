// K5 flash_attention: blocked attention forward with an online softmax,
// causal and sliding-window masks, and GQA by index.
//   o[b, h, i] = softmax_j(mask(scale q[b, h, i] . k[b, g(h), j])) v[b, g(h), j]
// with g(h) = h / (Hq / Hkv), query i at absolute position i + offset
// (offset = Sk - Sq, the unpadded one), key j visible when j < Sk and
//   causal:  j <= i + offset,     window > 0:  j > i + offset - window.
// Inputs are float or bf16 (T); scores, the running (m, l) and the output
// accumulator are f32; the output is written in T.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:101
// flash_attention_pallas (body _make_kernel, :37). Its backward stays the
// plain version's VJP, as in repro (ops.py there and here).
//
// What bounds it on the H100: operations. At the llama3-8b prefill
// (Sq = Sk = 8192, 32 query heads over 8 KV heads, D = 128, causal) one
// layer does 4 Hq D (live (q, k) pairs) ~ 5.5e11 FLOP against ~168 MB of
// q/k/v/o: ~0.56 ms on the bf16 tensor cores, ~8 ms on the f32 FMA pipes
// that this kernel uses.
//
// Design: the TPU kernel walked a (B Hq, Sq/bq, Sk/bk) grid whose key axis
// ran in order, carrying (m, l, acc) in VMEM scratch between grid steps,
// with tensors padded to whole blocks. Here one block of 256 threads owns
// one 64-row query tile of one (batch, query head) and loops over the key
// tiles itself, so (m, l, acc) stay in registers. Each key/value tile is
// loaded into shared memory once (16-byte / 8-byte vector reads, converted
// to f32; rows past Sk zero-filled), then every thread computes a 4 x 4
// patch of the 64 x 64 score tile (rows ty + 16 i, keys tx + 16 j) from
// float4 reads of padded rows, masks it, updates its rows' (m, l) with
// max/sum reductions over the 16 lanes of its half-warp, writes p to
// shared memory and accumulates 4 rows x D/16 columns of p v. Key tiles
// wholly outside the causal/window band are skipped by the same test as
// kernel.py:56-64 (causal: k_lo <= q_hi; window: k_hi > q_lo - window).
// Ragged lengths are bounds checks, not padding, so the band's offset is
// the unpadded one by construction and a bidirectional call may be ragged
// too. Query tiles are launched latest first (they carry the most live
// key tiles under a causal mask). SIMT f32 FMAs throughout: wgmma, TMA
// and warp-specialised pipelining are later work.
//
// A row with no visible key at all (only possible when Sq > Sk under a
// causal mask) follows the TPU kernel's rule: 0 when no key tile of its
// query tile is live; when its query tile straddles position 0, the mean
// of the rows of key tile 0 of v (rows past Sk counted as 0), since its
// scores there are all -1e30 and so exp(s - m) = 1. The tile is 64 rows
// here and 128 there, so the two agree on the rule, not on the values.
// The plain version gives the mean of all of v there instead.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kBlockQ = 64;             // dispatch.FLASH_BLOCK_Q
constexpr int kBlockK = 64;             // dispatch.FLASH_BLOCK_K
constexpr int kPad = 4;                 // dispatch.FLASH_PAD (f32 per row)
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// Must match repro_torch.kernels.dispatch.flash_attention_smem_bytes:
// Q and K tiles at row pitch D + kPad, the V tile at pitch D and the
// probabilities at pitch kBlockK + kPad, all f32.
inline size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)kBlockQ * (D + kPad) + (size_t)kBlockK * (D + kPad) +
          (size_t)kBlockK * D + (size_t)kBlockQ * (kBlockK + kPad));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Rows [r0, r0 + 64) of a (rows_total, D) slice with row stride `stride`
// into `dst` (f32, row pitch `pitch`); rows at or past rows_total are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* src, long long stride,
                                          int r0, int rows_total) {
  constexpr int kVec = D / 4;
  for (int e = threadIdx.x; e < kBlockK * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows_total) x = load4(src + (long long)(r0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * pitch + c) = x;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Strides {                        // elements, d stride is 1
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                 int Sq, int Sk, Strides st, int causal, int window,
                 int offset, float scale) {
  static_assert(kBlockQ == kBlockK, "load_tile serves both tiles");
  static_assert(D % 16 == 0, "16 lanes split the head dimension");
  constexpr int kQP = D + kPad;         // pitch of the Q and K tiles
  constexpr int kPP = kBlockK + kPad;   // pitch of the probability tile
  constexpr int kDPT = D / 16;          // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * kQP;
  float* Vs = Ks + kBlockK * kQP;
  float* Ps = Vs + kBlockK * D;

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + hk * st.kh;
  const T* vb = v + b * st.vb + hk * st.vh;
  T* ob = o + (long long)bh * Sq * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const int q0 = iq * kBlockQ;
  load_tile<T, D>(Qs, kQP, qb, st.qs, q0, Sq);

  float m[4], l[4], acc[4][kDPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPT; ++c) acc[i][c] = 0.f;
  }

  const int q_lo = q0 + offset;
  const int q_hi = q_lo + kBlockQ - 1;
  const int n_kt = (Sk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_lo = kt * kBlockK, k_hi = k_lo + kBlockK - 1;
    if (causal && k_lo > q_hi) break;               // and every later tile
    if (window > 0 && k_hi <= q_lo - window) continue;
    __syncthreads();                    // the last tile's reads are done
    load_tile<T, D>(Ks, kQP, kb, st.ks, k_lo, Sk);
    load_tile<T, D>(Vs, D, vb, st.vs, k_lo, Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * kQP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * kQP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_lo + tx + 16 * j;
        bool live = kpos < Sk;
        if (causal) live = live && kpos <= qpos;
        if (window > 0) live = live && kpos > qpos - window;
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kPP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPP + kk];
#pragma unroll
      for (int c = 0; c < kDPT; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDPT; ++c)
      store1(ob + (long long)row * D + tx + 16 * c, acc[i][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, int B, int Hq,
                   int Hkv, int Sq, int Sk, const Strides& st, int causal,
                   int window, int offset, float scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * Hq);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, Hq, Hkv, Sq, Sk, st, causal, window, offset, scale);
  return cudaGetLastError();
}

template <typename T>
int flash_fwd(const T* q, const T* k, const T* v, T* o, int B, int Hq,
              int Hkv, int Sq, int Sk, int D, const Strides& st, int causal,
              int window, int offset, float scale, int device,
              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 ||
      (long long)B * Hq > 65535 || window < 0)
    return cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal,
                           window, offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal,
                           window, offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal,
                            window, offset, scale, stream);
    case 160:                           // stablelm-12b
      return launch<T, 160>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal,
                            window, offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_block_q() { return kBlockQ; }
extern "C" int flash_attention_block_k() { return kBlockK; }
extern "C" long long flash_attention_smem_bytes(int D) {
  return (long long)smem_bytes(D);
}

// Strides are in elements: (batch, head, sequence) for q, k and v; the
// head dimension is contiguous. o is contiguous (B, Hq, Sq, D).
extern "C" int flash_attention_f32(
    const float* q, const float* k, const float* v, float* o, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long vb, long long vh,
    long long vs, int causal, int window, int offset, float scale,
    int device, void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs};
  return flash_fwd<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, causal,
                          window, offset, scale, device,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long vb, long long vh,
    long long vs, int causal, int window, int offset, float scale,
    int device, void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs};
  return flash_fwd<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      B, Hq, Hkv, Sq, Sk, D, st, causal, window, offset, scale, device,
      static_cast<cudaStream_t>(stream));
}
