// K5 flash_attention: blocked attention forward with an online softmax,
// causal and sliding-window masks, and GQA by index.
//   o[b, h, i] = softmax_j(mask(scale q[b, h, i] . k[b, g(h), j])) v[b, g(h), j]
// with g(h) = h / (Hq / Hkv), query i at absolute position i + offset
// (offset = Sk - Sq, the unpadded one), key j visible when j < Sk and
//   causal:  j <= i + offset,     window > 0:  j > i + offset - window.
// Scores, the running (m, l) and the output accumulator are f32; the
// output is written in the input type.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:101
// flash_attention_pallas (body _make_kernel, :37). Its backward stays the
// plain version's VJP, as in repro (ops.py there and here).
//
// What bounds it on the H100: operations. At the llama3-8b prefill
// (Sq = Sk = 8192, 32 query heads over 8 KV heads, D = 128, causal) one
// layer does 4 Hq D (live (q, k) pairs) ~ 5.5e11 FLOP against ~168 MB of
// q/k/v/o: ~0.56 ms on the bf16 tensor cores; at stablelm-12b's (D = 160)
// ~6.9e11 FLOP, ~0.69 ms. Both products run on the tensor cores at every
// serving head dimension; the f32 simt body is ~25x slower (~26 ms at
// stablelm-12b's shape).
//
// Two bodies, routed by type and head dimension
// (repro_torch.kernels.dispatch.flash_attention_route):
//
// * wgmma (bf16 at D = 64, 128 and 160: the serving type of every config):
//   one block of three warpgroups per 128-row query tile and (batch,
//   query head). Warpgroup 0 is the producer: it gives up registers
//   (setmaxnreg) and one thread issues TMA loads, Q once, then the K and V
//   tiles (128 keys each) of exactly the live key tiles round a ring of
//   two stages; full barriers count the TMA bytes, and K and V each have
//   their own empty barriers, so a K stage is refilled as soon as its
//   Q K^T is done. Warpgroups 1 and 2 each own 64 query rows. Each turn
//   issues S = Q K^T of tile i (wgmma m64n128k16, both operands K-major
//   in shared memory) and O += P V of tile i - 1 (P in bf16 registers as
//   the A operand, V MN-major through the transpose flag); the softmax of
//   tile i runs while P V of tile i - 1 is still on the tensor cores, and
//   the two consumers take turns at issuing (ping-pong on named
//   barriers), so one's softmax overlaps the other's products. Softmax:
//   the running max of the raw scores and the sum by quad shuffles in the
//   accumulator layout, one FFMA (the scale folded into log2(e)) and one
//   ex2 per score, O in f32 registers rescaled by alpha. Only the tiles
//   that straddle the causal diagonal, the window's edge or Sk are
//   masked (to -inf: keys past Sk, which TMA fills with zeros, would
//   score 0); the rest skip the mask. The head dimension sits in panels
//   that fit it exactly: 128-byte panels of 64 columns (128-byte swizzle),
//   then, at D = 160, one 64-byte tail panel of 32 (64-byte swizzle; a
//   tensor map of its own): Q K^T takes 8 k16 steps in the panels and 2 in
//   the tail, P V an m64n128k16 over the panels and an m64n32k16 over the
//   tail. Padding D to 192 would need 246,856 bytes of shared memory (over
//   a block's 232,448) and spend a fifth of both products on zeros; the
//   tail keeps D = 160 at 205,896 bytes with the D = 128 tiles, and a
//   consumer thread at acc[80], sc[64] and pa[32] under its 240 registers.
// * simt (f32 at every D, and bf16 at D = 16 and 32): one block of 256
//   threads per 64-row query tile loops over 64-row key tiles loaded into
//   shared memory as f32 (rows past Sk zero-filled); every thread computes
//   a 4 x 4 patch of the score tile with f32 FMAs, masks it, updates its
//   rows' (m, l) over the 16 lanes of its half-warp and accumulates 4 rows
//   x D/16 columns of p v. f32 stays here because TF32 products would not
//   meet its bars.
//
// Both: the TPU kernel walked a (B Hq, Sq/bq, Sk/bk) grid whose key axis
// ran in order, carrying (m, l, acc) in VMEM scratch between grid steps,
// with tensors padded to whole blocks. Here a block loops over the key
// tiles itself, so (m, l, acc) stay in registers. Key tiles wholly
// outside the causal/window band are skipped by the same test as
// kernel.py:56-64 (causal: k_lo <= q_hi; window: k_hi > q_lo - window).
// Ragged lengths are bounds checks, not padding, so the band's offset is
// the unpadded one by construction and a bidirectional call may be ragged
// too. Query tiles are launched latest first (they carry the most live
// key tiles under a causal mask).
//
// A row with no visible key at all (only possible when Sq > Sk under a
// causal mask): the wgmma body masks to -inf and scales a row whose max
// is still -inf against 0, so such a row has probabilities 0, l = 0 and
// output 0, whatever the tiles. The simt body follows the TPU kernel's
// rule, which depends on the tile: 0 when no key tile of its query tile
// is live; when its query tile straddles position 0, the mean of the rows
// of key tile 0 of v (rows past Sk counted as 0), since its scores there
// are all -1e30 and so exp(s - m) = 1. Its tiles are 64 rows where the
// Pallas kernel's are 128 (once Sq and Sk exceed 64), so the two agree
// on the rule, not on the values. The plain version gives the mean of all
// of v there instead.
#include "common.cuh"

#include <cuda_bf16.h>

#include "sm90.cuh"

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
    case 16:                            // the smoke configs
      return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal,
                           window, offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal,
                           window, offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal,
                           window, offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal,
                            window, offset, scale, stream);
    case 160:                           // stablelm-12b (bf16: forced only)
      return launch<T, 160>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal,
                            window, offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The wgmma body (bf16, D = 64, 128 and 160)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBlockQ = 128;            // dispatch.FLASH_WGMMA_BLOCK_Q
constexpr int kBlockK = 128;            // dispatch.FLASH_WGMMA_BLOCK_K
constexpr int kStages = 2;              // dispatch.FLASH_WGMMA_STAGES
constexpr int kThreads = 384;           // producer + two consumers
constexpr int kConsumerThreads = 256;
// The head dimension in panels: whole 128-byte panels of 64 bf16, then
// (D % 64 = 32, stablelm-12b's D = 160) one 64-byte tail panel of 32.
constexpr int kPanelCols = 64;          // dispatch.FLASH_WGMMA_PANEL_COLS
constexpr int kRowBytes = 128;
constexpr int kTailCols = 32;           // dispatch.FLASH_WGMMA_TAIL_COLS
constexpr int kTailRowBytes = 64;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kTurnBar = 1;             // named barriers 1, 2: the turns

// Must match repro_torch.kernels.dispatch.flash_attention_smem_bytes(D,
// "wgmma"): 1024 bytes of slack to align the buffers, Q, the K and V
// rings, and the barriers (full_q, then full_k, full_v, empty_k and
// empty_v per stage).
inline size_t smem_bytes(int D) {
  return 1024 + 2 * (size_t)D * (kBlockQ + 2 * kStages * kBlockK) +
         8 * (1 + 4 * kStages);
}

// Live key tiles [lo, hi) of the query tile whose rows sit at positions
// [q_lo, q_hi]: kernel.py:56-64's test solved for the tile index.
__device__ __forceinline__ void live_tiles(int q_lo, int q_hi, int Sk,
                                           int causal, int window, int* lo,
                                           int* hi) {
  int a = 0, e = (Sk + kBlockK - 1) / kBlockK;
  if (causal) e = q_hi < 0 ? 0 : min(e, q_hi / kBlockK + 1);
  if (window > 0 && q_lo - window + 1 > 0) a = (q_lo - window + 1) / kBlockK;
  *lo = a;
  *hi = max(a, e);
}

// Does key tile kt hold a (query, key) pair of this query tile that the
// mask hides? Only then is the tile masked.
__device__ __forceinline__ bool needs_mask(int kt, int q_lo, int q_hi,
                                           int Sk, int causal, int window) {
  const int k_lo = kt * kBlockK, k_hi = k_lo + kBlockK - 1;
  return k_hi >= Sk || (causal && k_hi > q_lo) ||
         (window > 0 && k_lo <= q_hi - window);
}

// 2^x on the special-function unit alone: exp2f without fast-math adds
// instructions around it to keep subnormal results, and a probability
// below 2^-126 of the row's largest is 0 for the sums here.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One k16 step of O += P V over the whole head dimension: N = 64 or 128
// over the 128-byte panels (desc_v), then N = 32 over the tail (desc_t,
// D = 160 only). The accumulator's columns follow the panels, so the
// tail's 16 values a thread sit after the first 64.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v, uint64_t desc_t);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v, uint64_t) {
  sm90::wgmma_m64n64k16_rs_tb(o, a, desc_v, 1);
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_v, uint64_t) {
  sm90::wgmma_m64n128k16_rs_tb(o, a, desc_v, 1);
}

template <>
__device__ __forceinline__ void wgmma_pv<160>(float (&o)[80],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_v,
                                              uint64_t desc_t) {
  sm90::wgmma_m64n128k16_rs_tb(*reinterpret_cast<float(*)[64]>(o), a,
                               desc_v, 1);
  sm90::wgmma_m64n32k16_rs_tb(*reinterpret_cast<float(*)[16]>(o + 64), a,
                              desc_t, 1);
}

// Issues S = Q K^T for consumer cw's 64 rows: D / 16 steps of k16 over
// the head dimension, both operands K-major in shared memory, four in
// each 128-byte panel, then two in the 64-byte tail. Qs and Kst are
// tiles of kBlockQ and kBlockK rows laid out panel after panel.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBlockK / 2],
                                         const uint8_t* Qs, int cw,
                                         const uint8_t* Kst) {
  constexpr int kSteps = D / kPanelCols * 4;
  const uint8_t* Qw = Qs + cw * 64 * kRowBytes;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int panel = kk / 4, col = (kk % 4) * 32;   // bytes into the row
    sm90::wgmma_m64n128k16_ss(
        sc, sm90::desc_sw128(Qw + panel * kBlockQ * kRowBytes + col, 16, 1024),
        sm90::desc_sw128(Kst + panel * kBlockK * kRowBytes + col, 16, 1024),
        kk > 0);
  }
  if constexpr (D % kPanelCols != 0) {
    const uint8_t* Qt = Qs + (D / kPanelCols) * kBlockQ * kRowBytes +
                        cw * 64 * kTailRowBytes;
    const uint8_t* Kt = Kst + (D / kPanelCols) * kBlockK * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < kTailCols / 16; ++kk)
      sm90::wgmma_m64n128k16_ss(
          sc, sm90::desc_sw64(Qt + kk * 32, 16, 512),
          sm90::desc_sw64(Kt + kk * 32, 16, 512), kSteps + kk > 0);
  }
}

// Issues O += P V: P from registers, V's rows (the reduction axis)
// MN-major in shared memory, 16 keys per step.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[kBlockK / 16][4],
                                         const uint8_t* Vst) {
  const uint8_t* Vt = Vst + (D / kPanelCols) * kBlockK * kRowBytes;
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
    wgmma_pv<D>(acc, pa[kk],
                sm90::desc_sw128(Vst + kk * 16 * kRowBytes,
                                 kBlockK * kRowBytes, 1024),
                sm90::desc_sw64(Vt + kk * 16 * kTailRowBytes,
                                kBlockK * kTailRowBytes, 512));
}

// The raw scores of key tile kt, in place, become probabilities
// 2^(s scale log2(e) - m scale log2(e)) against the updated running
// max m of the raw scores (one FFMA and one ex2 each; -inf where the
// mask hides the pair, only on the tiles that need it). A row that has
// seen no visible key yet keeps m = -inf and scales against 0, so its
// probabilities are 0. l takes their partial row sums (each thread's
// columns; summed over the quad at the end) and alpha the factor by
// which the earlier sums shrink.
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kBlockK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int kt, int q_lo, int q_hi, int row0, int col0, int Sk, int causal,
    int window, float scale_log2) {
  if (needs_mask(kt, q_lo, q_hi, Sk, causal, window)) {
#pragma unroll
    for (int e = 0; e < kBlockK / 2; ++e) {
      const int qpos = q_lo + row0 + 8 * ((e / 2) % 2);
      const int kpos = kt * kBlockK + 8 * (e / 4) + col0 + e % 2;
      bool live = kpos < Sk;
      if (causal) live = live && kpos <= qpos;
      if (window > 0) live = live && kpos > qpos - window;
      if (!live) sc[e] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f}, ms[2];
#pragma unroll
  for (int e = 0; e < kBlockK / 2; ++e)
    mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], sc[e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    ms[r] = (mx[r] == -INFINITY ? 0.f : mx[r]) * scale_log2;
    alpha[r] = ex2_ftz(m[r] * scale_log2 - ms[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int e = 0; e < kBlockK / 2; ++e) {
    sc[e] = ex2_ftz(fmaf(sc[e], scale_log2, -ms[(e / 2) % 2]));
    rs[(e / 2) % 2] += sc[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
}

// P in bf16 as the register A operand of the m64nNk16 steps.
__device__ __forceinline__ void pack_p(const float (&sc)[kBlockK / 2],
                                       uint32_t (&pa)[kBlockK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
}

// tmap_qt, tmap_kt and tmap_vt load the tail panel (D % 64 = 32); at D =
// 64 and 128 they are not read.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tmap_q,
                const __grid_constant__ CUtensorMap tmap_k,
                const __grid_constant__ CUtensorMap tmap_v,
                const __grid_constant__ CUtensorMap tmap_qt,
                const __grid_constant__ CUtensorMap tmap_kt,
                const __grid_constant__ CUtensorMap tmap_vt,
                __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Sq,
                int Sk, int causal, int window, int offset,
                float scale_log2, int pingpong) {
  static_assert(D % kPanelCols == 0 || D % kPanelCols == kTailCols,
                "whole 128-byte panels, then at most one 64-byte tail");
  constexpr int kPanels = D / kPanelCols;
  constexpr bool kTail = D % kPanelCols != 0;
  constexpr uint32_t kQBytes = kBlockQ * D * 2;
  constexpr uint32_t kKVBytes = kBlockK * D * 2;   // one K or V tile
  constexpr uint32_t kQPanel = kBlockQ * kRowBytes;
  constexpr uint32_t kKVPanel = kBlockK * kRowBytes;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + kQBytes;                      // stage s at s * kKVBytes
  uint8_t* Vs = Ks + kStages * kKVBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(Vs + kStages * kKVBytes);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  const int bh = blockIdx.x;
  const int iq = gridDim.y - 1 - blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = iq * kBlockQ;
  const int q_lo = q0 + offset, q_hi = q_lo + kBlockQ - 1;
  int kt_lo, kt_hi;
  live_tiles(q_lo, q_hi, Sk, causal, window, &kt_lo, &kt_hi);
  const int n_tiles = kt_hi - kt_lo;

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty_k[s], kConsumerThreads);
      sm90::mbar_init(&empty_v[s], kConsumerThreads);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full.
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tensormap(&tmap_q);
      sm90::prefetch_tensormap(&tmap_k);
      sm90::prefetch_tensormap(&tmap_v);
      if constexpr (kTail) {
        sm90::prefetch_tensormap(&tmap_qt);
        sm90::prefetch_tensormap(&tmap_kt);
        sm90::prefetch_tensormap(&tmap_vt);
      }
      sm90::mbar_expect_tx(full_q, kQBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        sm90::tma_load_4d(Qs + p * kQPanel, &tmap_q, full_q, p * kPanelCols,
                          q0, h, b);
      if constexpr (kTail)
        sm90::tma_load_4d(Qs + kPanels * kQPanel, &tmap_qt, full_q,
                          kPanels * kPanelCols, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        const int k0 = (kt_lo + i) * kBlockK;
        sm90::mbar_wait(&empty_k[s], parity);
        sm90::mbar_expect_tx(&full_k[s], kKVBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          sm90::tma_load_4d(Ks + s * kKVBytes + p * kKVPanel, &tmap_k,
                            &full_k[s], p * kPanelCols, k0, hk, b);
        if constexpr (kTail)
          sm90::tma_load_4d(Ks + s * kKVBytes + kPanels * kKVPanel, &tmap_kt,
                            &full_k[s], kPanels * kPanelCols, k0, hk, b);
        sm90::mbar_wait(&empty_v[s], parity);
        sm90::mbar_expect_tx(&full_v[s], kKVBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          sm90::tma_load_4d(Vs + s * kKVBytes + p * kKVPanel, &tmap_v,
                            &full_v[s], p * kPanelCols, k0, hk, b);
        if constexpr (kTail)
          sm90::tma_load_4d(Vs + s * kKVBytes + kPanels * kKVPanel, &tmap_vt,
                            &full_v[s], kPanels * kPanelCols, k0, hk, b);
      }
    }
  } else {
    // Consumer warpgroups: cw owns rows [64 cw, 64 cw + 64) of the tile.
    // Each turn issues S = Q K^T of tile i and O += P V of tile i - 1
    // together; the softmax of tile i then runs while P V of tile i - 1
    // is still on the tensor cores. With `pingpong` the two consumers take
    // turns at issuing, so one's softmax overlaps the other's products.
    sm90::reg_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = 64 * cw + 16 * warp + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    auto turn_begin = [&] {
      if (pingpong) sm90::named_bar_sync(kTurnBar + cw, kConsumerThreads);
    };
    auto turn_end = [&] {
      if (pingpong)
        sm90::named_bar_arrive(kTurnBar + 1 - cw, kConsumerThreads);
    };

    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    float sc[kBlockK / 2];
    uint32_t pa[kBlockK / 16][4];

    sm90::mbar_wait(full_q, 0);
    if (n_tiles > 0) {
      if (pingpong && cw == 1)                      // consumer 0 goes first
        sm90::named_bar_arrive(kTurnBar, kConsumerThreads);
      sm90::mbar_wait(&full_k[0], 0);
      turn_begin();
      sm90::wgmma_fence();
      issue_qk<D>(sc, Qs, cw, Ks);
      sm90::wgmma_commit();
      turn_end();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::mbar_arrive(&empty_k[0]);
      softmax_tile(sc, m, l, alpha, kt_lo, q_lo, q_hi, row0, col0, Sk,
                   causal, window, scale_log2);
      pack_p(sc, pa);
      for (int i = 1; i < n_tiles; ++i) {
        const int s = i % kStages, sp = (i - 1) % kStages;
        sm90::mbar_wait(&full_k[s], (i / kStages) & 1);
        sm90::mbar_wait(&full_v[sp], ((i - 1) / kStages) & 1);
        turn_begin();
        sm90::wgmma_fence();
        sm90::fence_regs(acc);
        issue_qk<D>(sc, Qs, cw, Ks + s * kKVBytes);
        sm90::wgmma_commit();
        issue_pv<D>(acc, pa, Vs + sp * kKVBytes);
        sm90::wgmma_commit();
        turn_end();
        sm90::wgmma_wait<1>();                      // S of tile i
        sm90::fence_regs(sc);
        sm90::mbar_arrive(&empty_k[s]);
        softmax_tile(sc, m, l, alpha, kt_lo + i, q_lo, q_hi, row0, col0, Sk,
                     causal, window, scale_log2);
        sm90::wgmma_wait<0>();                      // P V of tile i - 1
        sm90::fence_regs(acc);
        sm90::fence_regs(pa);
        sm90::mbar_arrive(&empty_v[sp]);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e / 2) % 2];
        pack_p(sc, pa);
      }
      const int sl = (n_tiles - 1) % kStages;
      sm90::mbar_wait(&full_v[sl], ((n_tiles - 1) / kStages) & 1);
      turn_begin();
      sm90::wgmma_fence();
      sm90::fence_regs(acc);
      issue_pv<D>(acc, pa, Vs + sl * kKVBytes);
      sm90::wgmma_commit();
      turn_end();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
      sm90::mbar_arrive(&empty_v[sl]);
    }

    // Epilogue: each row's sum over its quad, then o = acc / max(l, 1e-30).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* ob = o + (size_t)bh * Sq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 8 * r;
      if (row >= Sq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + 8 * j +
                                           col0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / l[r],
                                  acc[4 * j + 2 * r + 1] / l[r]);
    }
  }
}

// A (B, H, S, D) bf16 operand with element strides (sb, sh, ss) and a
// contiguous D as a rank-4 tensor map (D, S, H, B) of `rows`-row boxes:
// 64 columns in the 128-byte swizzle (the panels), or 32 in the 64-byte
// swizzle (the tail).
inline cudaError_t map_bhsd(CUtensorMap* map, const void* base, int B,
                            int H, int S, int D, long long sb, long long sh,
                            long long ss, int rows, bool tail) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(tail ? kTailCols : kPanelCols),
                             (cuuint32_t)rows, 1, 1};
  return sm90::encode_bf16(map, base, 4, dims, strides, box,
                           tail ? CU_TENSOR_MAP_SWIZZLE_64B
                                : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* o, int B, int Hq,
                   int Hkv, int Sq, int Sk, const Strides& st, int causal,
                   int window, int offset, float scale, int pingpong,
                   cudaStream_t stream) {
  // The panels' maps, then (D % 64 = 32) the tail's.
  auto maps = [&](bool tail, CUtensorMap* mq, CUtensorMap* mk,
                  CUtensorMap* mv) {
    cudaError_t e = map_bhsd(mq, q, B, Hq, Sq, D, st.qb, st.qh, st.qs,
                             kBlockQ, tail);
    if (e == cudaSuccess)
      e = map_bhsd(mk, k, B, Hkv, Sk, D, st.kb, st.kh, st.ks, kBlockK, tail);
    if (e == cudaSuccess)
      e = map_bhsd(mv, v, B, Hkv, Sk, D, st.vb, st.vh, st.vs, kBlockK, tail);
    return e;
  };
  CUtensorMap tq, tk, tv, tqt{}, tkt{}, tvt{};
  cudaError_t err = maps(false, &tq, &tk, &tv);
  if (err == cudaSuccess && D % kPanelCols != 0)
    err = maps(true, &tqt, &tkt, &tvt);
  if (err != cudaSuccess) return err;
  const size_t bytes = smem_bytes(D);
  err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + kBlockQ - 1) / kBlockQ);
  flash_fwd_wgmma<D><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, tqt, tkt, tvt, o, Hq, Hkv, Sq, Sk, causal, window, offset,
      scale * kLog2e, pingpong);
  return cudaGetLastError();
}

int flash_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
              const __nv_bfloat16* v, __nv_bfloat16* o, int B, int Hq,
              int Hkv, int Sq, int Sk, int D, const Strides& st, int causal,
              int window, int offset, float scale, int pingpong, int device,
              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 ||
      (Sq + kBlockQ - 1) / kBlockQ > 65535 || window < 0)
    return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal, window,
                        offset, scale, pingpong, stream);
    case 128:
      return launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal, window,
                         offset, scale, pingpong, stream);
    case 160:                           // stablelm-12b
      return launch<160>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal, window,
                         offset, scale, pingpong, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

extern "C" int flash_attention_block_q() { return kBlockQ; }
extern "C" int flash_attention_block_k() { return kBlockK; }
extern "C" long long flash_attention_smem_bytes(int D) {
  return (long long)smem_bytes(D);
}
extern "C" int flash_attention_wgmma_block_q() { return wg::kBlockQ; }
extern "C" int flash_attention_wgmma_block_k() { return wg::kBlockK; }
extern "C" int flash_attention_wgmma_stages() { return wg::kStages; }
extern "C" long long flash_attention_wgmma_smem_bytes(int D) {
  return (long long)wg::smem_bytes(D);
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

// The wgmma body (bf16, D = 64, 128 or 160). The arguments of
// flash_attention_bf16 and `pingpong` (1: the consumers take turns at
// issuing their products); TMA also needs the (batch, head, sequence)
// strides to be multiples of 8 and the starts 16-byte aligned.
extern "C" int flash_attention_bf16_wgmma(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long vb, long long vh,
    long long vs, int causal, int window, int offset, float scale,
    int pingpong, int device, void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs};
  return wg::flash_fwd(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      B, Hq, Hkv, Sq, Sk, D, st, causal, window, offset, scale, pingpong,
      device, static_cast<cudaStream_t>(stream));
}
