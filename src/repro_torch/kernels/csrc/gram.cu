// K1 gram: out = x^T [y | v^T] for x (m, p), y (m, qy) and k vectors v
// (k, m), row-major, accumulated in f32 (float) or f64 (double). With
// k = 0 it is x^T y; the solvers' fused call passes x = y = Y and the k
// projection vectors, so [Y | v^T] is never built in memory.
//
// Replaces src/repro/kernels/gram/kernel.py:48 gram_t_pallas (body
// _gram_kernel, :31): the fused Gram + projection block Y^T [Y | ytil |
// ztil] of every SA outer iteration (paper Alg. 2 lines 11-12).
//
// What bounds it on the H100: on the main path m = 400,000, p = 128, k =
// 2, q = 130. Y and the vectors read once are 0.208 GB, 0.062 ms at 3.35
// TB/s. G is symmetric, so the function needs 8,512 of the 16,640
// entries; at f32 accuracy on the tensor cores each is three TF32
// products (3xTF32) over m, 20.4 GFLOP, 0.041 ms at 494.7 TFLOP/s: bytes
// bound it. All 2 m p q = 13.3 GFLOP on the f32 FMA pipes (67 TFLOP/s)
// would take 0.199 ms.
//
// Two bodies, chosen by repro_torch.kernels.dispatch.gram_route:
//
// * wgmma (f32 where TMA can describe x and y, k <= 8): split-K over m,
//   one block of 640 threads per (128-row tile of p, tile of q, range of
//   m), one block on every SM. A producer warp loads raw 32-row slices of
//   x and y by TMA into a ring, and copies the same 32 rows of each
//   vector beside them by cp.async; two transform warpgroups split each
//   value a into hi = tf32(a) and lo = a - hi and write both,
//   transposed (K-major: m along the row) and 128-byte swizzled, into a
//   second ring; two consumer warpgroups (64 rows of the output each)
//   accumulate hi.lo + lo.hi + hi.hi with wgmma m64nNk8 tf32, the small
//   terms first, so a product carries ~2^-22 relative error instead of
//   1xTF32's 2^-11. wgmma takes tf32 only K-major, and the split passes
//   through registers anyway, so the transpose costs nothing extra. Every
//   2 stages a consumer folds its accumulator into f32 running sums in
//   registers (setmaxnreg gives the consumers 168): the tensor cores'
//   accumulation loses low bits at every step, which over a whole split
//   of ~3,000 rows grew to ~3e-5 of a sum of squares. When x and y are
//   one tensor and one tile holds the whole output (the solvers' call), A
//   is the first p rows of B's buffer, so Y is read from device memory
//   once, and the tile's symmetric 128 x 128 block is computed once: the
//   second consumer takes columns 64-135 only, the first mirrors its
//   columns 64-127.
// * simt (f64, and f32 shapes the wgmma body cannot take): split-K over
//   m, (64, 64) output tiles held in registers (4 x 4 per thread, fed by
//   16-byte shared-memory loads of 32-row slices of x and [y | v^T]).
//
// Both write one partial per range of m; a second kernel sums the
// partials in a fixed order: no float atomics, so results are identical
// run to run.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kTileP = 64;
constexpr int kTileQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]);

template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

template <>
__device__ __forceinline__ void load4<double>(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ v, long long ldv,
                    T* __restrict__ partial, int m, int p, int qy, int q,
                    int rows_per_split) {
  __shared__ __align__(16) T xs[kBlockK][kTileP];
  __shared__ __align__(16) T ys[kBlockK][kTileQ];
  const int p0 = blockIdx.x * kTileP;
  const int q0 = blockIdx.y * kTileQ;
  const int m0 = blockIdx.z * rows_per_split;
  const int m1 = min(m, m0 + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // Does this tile of q reach the vectors' columns?
  const bool vec_tile = q0 + kTileQ > qy && q > qy;

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int mb = m0; mb < m1; mb += kBlockK) {
#pragma unroll
    for (int e = tid; e < kBlockK * kTileP; e += kThreads) {
      const int r = e / kTileP, c = e % kTileP;
      const int gm = mb + r, gp = p0 + c;
      xs[r][c] = (gm < m1 && gp < p) ? x[(size_t)gm * p + gp] : T(0);
    }
#pragma unroll
    for (int e = tid; e < kBlockK * kTileQ; e += kThreads) {
      const int r = e / kTileQ, c = e % kTileQ;
      const int gm = mb + r, gq = q0 + c;
      // Column gq of [y | v^T]: y's row gm, or vector gq - qy at gm.
      if (!vec_tile) {
        ys[r][c] = (gm < m1 && gq < qy) ? y[(size_t)gm * qy + gq] : T(0);
      } else {
        T val = T(0);
        if (gm < m1 && gq < qy)
          val = y[(size_t)gm * qy + gq];
        else if (gm < m1 && gq < q)
          val = v[(size_t)(gq - qy) * ldv + gm];
        ys[r][c] = val;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBlockK; ++k) {
      T a[4], b[4];
      load4(&xs[k][ty * 4], a);
      load4(&ys[k][tx * 4], b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  T* out = partial + (size_t)blockIdx.z * p * q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gp = p0 + ty * 4 + i;
    if (gp >= p) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gq = q0 + tx * 4 + j;
      if (gq < q) out[(size_t)gp * q + gq] = acc[i][j];
    }
  }
}

// out[e] = sum_k partial[k][e], k in order.
template <typename T>
__global__ void gram_reduce_kernel(const T* __restrict__ partial,
                                   T* __restrict__ out, int pq, int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pq) return;
  T acc = T(0);
  for (int k = 0; k < splits; ++k) acc += partial[(size_t)k * pq + e];
  out[e] = acc;
}

template <typename T>
cudaError_t reduce(const T* partial, T* out, int pq, int splits,
                   cudaStream_t stream) {
  gram_reduce_kernel<T><<<(pq + 255) / 256, 256, 0, stream>>>(
      partial, out, pq, splits);
  return cudaGetLastError();
}

template <typename T>
int gram_simt(const T* x, int p, const T* y, int qy, const T* v,
              long long ldv, int k, T* partial, T* out, int m, int splits,
              int rows_per_split, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int q = qy + k;
  const dim3 grid((p + kTileP - 1) / kTileP, (q + kTileQ - 1) / kTileQ,
                  splits);
  gram_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      x, y, v, ldv, partial, m, p, qy, q, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(partial, out, p * q, splits, stream);
}


namespace wg {

constexpr int kTileP = 128;     // dispatch.GRAM_WGMMA_TILE_P: 2 x 64 rows
constexpr int kBlockK = 32;     // rows of m per stage: one 128-byte row
constexpr int kMaxVecs = 8;     // dispatch.GRAM_WGMMA_MAX_VECS: k <= 8
constexpr int kXThreads = 256;  // two transform warpgroups
// Transform WGs, two consumer WGs, a producer WG (one warp of it works).
constexpr int kThreads = kXThreads + 256 + 128;
constexpr int kRowBytes = 128;
// Stages between folds of a consumer's wgmma accumulator into f32
// running sums in registers: the tensor cores' own accumulation then sums
// at most kFold * kBlockK = 64 rows of m.
constexpr int kFold = 2;
// Registers a thread after setmaxnreg. A block launches with 96 a
// thread (65,536 / 640, down to a multiple of 8), and setmaxnreg only
// moves registers within the block's launch allocation: the consumers'
// increase waits for the others' decrease, and must fit in what they
// give back.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kProducerRegs = 24;
constexpr int kXRegs = 56;
constexpr int kConsumerRegs = 168;
static_assert(128 * kProducerRegs + kXThreads * kXRegs +
                  256 * kConsumerRegs <= kThreads * kLaunchRegs,
              "setmaxnreg would wait forever");

// dispatch.gram_tile_n: the narrowest wgmma width of the menu (24, 72,
// 136) that holds q, else 136 and several tiles of q.
__host__ __device__ constexpr int tile_n(int q) {
  return q <= 24 ? 24 : q <= 72 ? 72 : 136;
}

// A and B are one buffer when x and y are one tensor and one tile holds
// the whole output (dispatch.gram_wgmma_shared).
__host__ __device__ inline bool shares(bool same, int p, int q) {
  const int tn = tile_n(q);
  return same && p <= kTileP && q <= tn && tn >= 64 * ((p + 63) / 64);
}

// dispatch.gram_wgmma_raw_stages and gram_wgmma_op_stages: the rings are
// deeper where A shares B's buffer (half the bytes a stage).
__host__ __device__ constexpr int raw_stages(int shared) {
  return shared ? 4 : 2;
}
__host__ __device__ constexpr int op_stages(int shared) {
  return shared ? 3 : 2;
}

// Must match dispatch.gram_wgmma_smem_bytes: 1024 bytes of slack to align
// the buffers; for each of the rows transposed (B's tn, plus A's kTileP
// unless A shares B's buffer) 128 bytes each of tf32 hi and lo per op
// stage and 128 bytes of raw tile per raw stage, plus the k vectors' 32
// values (kMaxVecs rows of 128 bytes) per raw stage; then the barriers
// (full and empty per stage of each ring).
inline size_t smem_bytes(int tn, int shared) {
  const size_t rows = tn + (shared ? 0 : kTileP);
  const int rs = raw_stages(shared), os = op_stages(shared);
  return 1024 + os * 2 * rows * kRowBytes + rs * (rows + kMaxVecs) * kRowBytes +
         8 * 2 * (os + rs);
}

// Splits 4 values into hi = tf32(a) and lo = a - hi (exact in f32; the
// tensor cores read it as tf32, dropping its low 13 bits, so it needs no
// rounding of its own) and stores each as one 16-byte chunk at byte
// `off` of the hi and lo buffers.
__device__ __forceinline__ void split_store(const float (&v)[4],
                                            uint8_t* hi, uint8_t* lo,
                                            uint32_t off) {
  float4 h, l;
  h.x = sm90::cvt_rna_tf32(v[0]); l.x = v[0] - h.x;
  h.y = sm90::cvt_rna_tf32(v[1]); l.y = v[1] - h.y;
  h.z = sm90::cvt_rna_tf32(v[2]); l.z = v[2] - h.z;
  h.w = sm90::cvt_rna_tf32(v[3]); l.w = v[3] - h.w;
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) = l;
}

// Byte offset of values 4 j .. 4 j + 3 of K in row n of a K-major,
// 128-byte-swizzled operand.
__device__ __forceinline__ uint32_t swz(int n, int j) {
  return n * kRowBytes + ((j ^ (n & 7)) << 4);
}

// Transposes `rows` columns of one stage into the hi and lo buffers: row
// n is column c0 + n of [src | v^T], from the raw tile `raw` (32 rows of
// `pitch` floats, starting at column c0 of src, which is `src_cols`
// wide), or from the vectors' slice `vs` (32 values a vector; columns
// src_cols .. total - 1), or zero.
template <int kRows>
__device__ __forceinline__ void transpose_split(
    const float* raw, int pitch, int c0, int src_cols, int total,
    const float* vs, uint8_t* hi, uint8_t* lo, int t) {
#pragma unroll 2
  for (int task = t; task < kRows * (kBlockK / 4); task += kXThreads) {
    const int n = task % kRows, j = task / kRows;
    const int c = c0 + n;
    float val[4];
    if (c < src_cols) {
#pragma unroll
      for (int e = 0; e < 4; ++e) val[e] = raw[(4 * j + e) * pitch + c - c0];
    } else if (c < total) {
      const float4 w = *reinterpret_cast<const float4*>(
          vs + (c - src_cols) * kBlockK + 4 * j);
      val[0] = w.x; val[1] = w.y; val[2] = w.z; val[3] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) val[e] = 0.f;
    }
    split_store(val, hi, lo, swz(n, j));
  }
}

// One consumer warpgroup's share of a block: D (64 x N) = A B^T over the
// block's stages, A's 64 rows at `a_off` and B's N rows at `b_off` of
// each op stage's hi and lo buffers; hi.lo + lo.hi + hi.hi, the small
// terms first. Every kFold stages (the two warpgroups `phase` stages
// apart, so one keeps the tensor cores busy while the other folds) the
// accumulator is added into f32 running sums and started again.
// Writes D at (row0 + r, col0 + c) of the (p, q) partial `out`, and with
// `mirror` also at (col0 + c, row0 + r) for 64 <= col0 + c < p (the
// lower-left block of a symmetric tile that the other warpgroup skips).
template <int N>
__device__ __forceinline__ void consume(
    const uint8_t* ops, uint32_t op_bytes, uint32_t a_off, uint32_t b_off,
    uint64_t* op_full, uint64_t* op_empty, int n_steps, int os, int phase,
    float* out, int row0, int col0, int p, int q, bool mirror, int lt) {
  float acc[N / 2], sums[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = sums[e] = 0.f;
  bool fresh = true;            // acc holds nothing to keep
  int held = -1;                // op stage to release once its products end
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % os;
    sm90::mbar_wait(&op_full[s], (i / os) & 1);
    const uint8_t* hi = ops + 2 * s * op_bytes;
    const uint8_t* lo = hi + op_bytes;
    sm90::wgmma_fence();
    sm90::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBlockK / 8; ++kk) {
      const uint64_t ah = sm90::desc_sw128(hi + a_off + 32 * kk, 16, 1024);
      const uint64_t al = sm90::desc_sw128(lo + a_off + 32 * kk, 16, 1024);
      const uint64_t bh = sm90::desc_sw128(hi + b_off + 32 * kk, 16, 1024);
      const uint64_t bl = sm90::desc_sw128(lo + b_off + 32 * kk, 16, 1024);
      sm90::wgmma_tf32<N>(acc, ah, bl, kk > 0 || !fresh);
      sm90::wgmma_tf32<N>(acc, al, bh, 1);
      sm90::wgmma_tf32<N>(acc, ah, bh, 1);
    }
    sm90::wgmma_commit();
    fresh = false;
    if ((i + 1 + phase) % kFold == 0) {
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (held >= 0) sm90::mbar_arrive(&op_empty[held]);
      sm90::mbar_arrive(&op_empty[s]);
      held = -1;
#pragma unroll
      for (int e = 0; e < N / 2; ++e) sums[e] += acc[e];
      fresh = true;
    } else {
      sm90::wgmma_wait<1>();               // the previous stage's products
      sm90::fence_regs(acc);
      if (held >= 0) sm90::mbar_arrive(&op_empty[held]);
      held = s;
    }
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  // The accumulator layout of m64nNk8: thread (warp w, lane l) holds
  // acc[e] at row 16 w + l / 4 + 8 ((e / 2) % 2), column
  // 8 (e / 4) + 2 (l % 4) + e % 2.
  const int warp = lt / 32, lane = lt % 32;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const float val = sums[e] + (fresh ? 0.f : acc[e]);
    const int row = row0 + 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
    const int col = col0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
    if (row < p && col < q) out[(size_t)row * q + col] = val;
    if (mirror && col >= 64 && col < p) out[(size_t)col * q + row] = val;
  }
}

// One block: output rows [p0, p0 + 128), columns [q0, q0 + TN), over m
// rows [m0, m1). Threads 0-255 transform, 256-511 are the two consumer
// warpgroups, 512-543 the producer warp (its warpgroup's other warps
// leave at once). Where A shares B's buffer at TN = 136 the tile is
// symmetric in its first 128 columns: the second consumer computes only
// columns 64-135 and the first writes the mirror of its columns 64-127.
template <int TN>
__global__ void __launch_bounds__(kThreads, 1)
gram_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_y,
                  const __grid_constant__ CUtensorMap tmap_x,
                  const float* __restrict__ v, long long ldv,
                  float* __restrict__ partial, int m, int p, int qy, int q,
                  int rows_per_split, int pitch_y, int pitch_x,
                  int shared) {
  constexpr uint32_t kBBytes = TN * kRowBytes;
  const int rows = TN + (shared ? 0 : kTileP);   // transposed rows a stage
  const uint32_t op_bytes = rows * kRowBytes;      // hi or lo of a stage
  const uint32_t raw_bytes = (rows + kMaxVecs) * kRowBytes;
  const int rs = raw_stages(shared), os = op_stages(shared);
  const int q0 = blockIdx.x * TN;
  const int p0 = blockIdx.y * kTileP;
  const int m0 = blockIdx.z * rows_per_split;
  const int m1 = min(m, m0 + rows_per_split);
  const int n_steps = (m1 - m0 + kBlockK - 1) / kBlockK;
  const int k = q - qy;
  // Does this tile hold a column of the vectors?
  const bool has_v = k > 0 && q0 + TN > qy;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // Op stage s: hi at ops + 2 s op_bytes, lo op_bytes after it; B's rows
  // first, then A's. Raw stage s at raws + s raw_bytes: y's slice, then
  // x's, then the vectors'. Then the barriers.
  uint8_t* ops = base;
  uint8_t* raws = ops + 2 * os * op_bytes;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(raws + rs * raw_bytes);
  uint64_t* raw_empty = raw_full + rs;
  uint64_t* op_full = raw_empty + rs;
  uint64_t* op_empty = op_full + os;

  if (threadIdx.x == 0) {
    for (int s = 0; s < rs; ++s) {
      sm90::mbar_init(&raw_full[s], 1 + 32);   // the TMA's, and the warp's
      sm90::mbar_init(&raw_empty[s], kXThreads);
    }
    for (int s = 0; s < os; ++s) {
      sm90::mbar_init(&op_full[s], kXThreads);
      sm90::mbar_init(&op_empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kXThreads + 256) {
    // Producer warp: lane 0 keeps the raw ring full by TMA; every lane
    // copies one row's value of each vector beside it by cp.async, whose
    // completion arrives on the same barrier, so no lane waits for it.
    sm90::reg_dealloc<kProducerRegs>();
    const int lane = threadIdx.x - (kXThreads + 256);
    if (lane >= 32) return;
    if (lane == 0) {
      sm90::prefetch_tensormap(&tmap_y);
      if (!shared) sm90::prefetch_tensormap(&tmap_x);
    }
    const uint32_t bytes = kBlockK * 4 * (pitch_y + (shared ? 0 : pitch_x));
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % rs;
      uint8_t* raw = raws + s * raw_bytes;
      const int mr = m0 + i * kBlockK;
      sm90::mbar_wait(&raw_empty[s], ((i / rs) & 1) ^ 1);
      if (lane == 0) {
        sm90::mbar_expect_tx(&raw_full[s], bytes);
        sm90::tma_load_2d(raw, &tmap_y, &raw_full[s], q0, mr);
        if (!shared)
          sm90::tma_load_2d(raw + kBBytes, &tmap_x, &raw_full[s], p0, mr);
      }
      if (has_v) {
        float* vs = reinterpret_cast<float*>(raw + op_bytes);
        const int gm = mr + lane;
        for (int c = 0; c < k; ++c)
          sm90::cp_async_4(vs + c * kBlockK + lane,
                           gm < m ? v + (size_t)c * ldv + gm : v, gm < m);
      }
      sm90::cp_async_mbar_arrive(&raw_full[s]);
    }
  } else if (threadIdx.x < kXThreads) {
    // Transform: raw slices -> tf32 hi and lo, transposed and swizzled.
    sm90::reg_dealloc<kXRegs>();
    const int t = threadIdx.x;
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % rs, so = i % os;
      const uint8_t* raw = raws + s * raw_bytes;
      const float* rawf = reinterpret_cast<const float*>(raw);
      uint8_t* hi = ops + 2 * so * op_bytes;
      uint8_t* lo = hi + op_bytes;
      sm90::mbar_wait(&raw_full[s], (i / rs) & 1);
      sm90::mbar_wait(&op_empty[so], ((i / os) & 1) ^ 1);
      transpose_split<TN>(rawf, pitch_y, q0, qy, q,
                          reinterpret_cast<const float*>(raw + op_bytes),
                          hi, lo, t);
      if (!shared)
        transpose_split<kTileP>(rawf + TN * kBlockK, pitch_x, p0, p, p,
                                nullptr, hi + kBBytes, lo + kBBytes, t);
      sm90::mbar_arrive(&raw_empty[s]);
      sm90::fence_proxy_async_smem();
      sm90::mbar_arrive(&op_full[so]);
    }
  } else {
    // Consumers: warpgroup h owns output rows p0 + 64 h .. + 63.
    sm90::reg_alloc<kConsumerRegs>();
    const int ct = threadIdx.x - kXThreads;    // 0 .. 255
    const int h = ct / 128;
    float* out = partial + (size_t)blockIdx.z * p * q;
    const uint32_t a_off = (shared ? 0 : kBBytes) + 64 * h * kRowBytes;
    const int phase = h * (kFold / 2);
    if (p0 + 64 * h >= p) {
      // No rows of this tile: release each stage as it comes.
      for (int i = 0; i < n_steps; ++i) {
        sm90::mbar_wait(&op_full[i % os], (i / os) & 1);
        sm90::mbar_arrive(&op_empty[i % os]);
      }
      return;
    }
    if constexpr (TN == 136) {
      if (shared && h == 1) {
        consume<TN - 64>(ops, op_bytes, a_off, 64 * kRowBytes, op_full,
                         op_empty, n_steps, os, phase, out, p0 + 64,
                         q0 + 64, p, q, false, ct % 128);
        return;
      }
    }
    consume<TN>(ops, op_bytes, a_off, 0, op_full, op_empty, n_steps, os,
                phase, out, p0 + 64 * h, q0, p, q,
                shared && TN == 136 && h == 0, ct % 128);
  }
}

// A row-major (m, cols) f32 operand as a rank-2 tensor map (cols, m) of
// (box_cols, kBlockK) boxes.
inline cudaError_t map_rows(CUtensorMap* map, const float* base, int m,
                            int cols, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)kBlockK};
  return sm90::encode_f32(map, base, 2, dims, strides, box);
}

template <int TN>
cudaError_t launch(const float* x, int p, const float* y, int qy,
                   const float* v, long long ldv, int k, float* partial,
                   int m, int splits, int rows_per_split,
                   cudaStream_t stream) {
  const int q = qy + k;
  const int shared = shares(x == y && p == qy, p, q);
  // Box widths: the tile, or the whole operand where it is narrower.
  const int pitch_y = min(TN, qy), pitch_x = min(kTileP, p);
  CUtensorMap ty, tx;
  cudaError_t err = map_rows(&ty, y, m, qy, pitch_y);
  if (err == cudaSuccess)
    err = shared ? cudaSuccess : map_rows(&tx, x, m, p, pitch_x);
  if (err != cudaSuccess) return err;
  const size_t bytes = smem_bytes(TN, shared);
  err = cudaFuncSetAttribute(gram_wgmma_kernel<TN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((q + TN - 1) / TN, (p + kTileP - 1) / kTileP, splits);
  gram_wgmma_kernel<TN><<<grid, kThreads, bytes, stream>>>(
      ty, shared ? ty : tx, v, ldv, partial, m, p, qy, q, rows_per_split,
      pitch_y, pitch_x, shared);
  return cudaGetLastError();
}

int gram(const float* x, int p, const float* y, int qy, const float* v,
         long long ldv, int k, float* partial, float* out, int m, int splits,
         int rows_per_split, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int q = qy + k;
  if (m < 1 || p < 1 || qy < 1 || k < 0 || k > kMaxVecs ||
      (k > 0 && v == nullptr) || p % 4 || qy % 4 ||
      rows_per_split % kBlockK || splits < 1 || splits > 65535 ||
      (size_t)(splits - 1) * rows_per_split >= (size_t)m)
    return cudaErrorInvalidValue;
  switch (tile_n(q)) {
    case 24:
      err = launch<24>(x, p, y, qy, v, ldv, k, partial, m, splits,
                       rows_per_split, stream);
      break;
    case 72:
      err = launch<72>(x, p, y, qy, v, ldv, k, partial, m, splits,
                       rows_per_split, stream);
      break;
    default:
      err = launch<136>(x, p, y, qy, v, ldv, k, partial, m, splits,
                        rows_per_split, stream);
  }
  if (err != cudaSuccess) return err;
  return reduce(partial, out, p * q, splits, stream);
}

}  // namespace wg

}  // namespace

extern "C" int gram_wgmma_tile_p() { return wg::kTileP; }
extern "C" int gram_wgmma_block_k() { return wg::kBlockK; }
extern "C" int gram_wgmma_op_stages(int shared) {
  return wg::op_stages(shared);
}
extern "C" int gram_wgmma_raw_stages(int shared) {
  return wg::raw_stages(shared);
}
extern "C" int gram_wgmma_max_vecs() { return wg::kMaxVecs; }
extern "C" int gram_wgmma_tile_n(int q) { return wg::tile_n(q); }
extern "C" int gram_wgmma_shared(int same, int p, int q) {
  return wg::shares(same != 0, p, q);
}
extern "C" long long gram_wgmma_smem_bytes(int tile_n, int shared) {
  return (long long)wg::smem_bytes(tile_n, shared);
}

// out (p, qy + k) = x^T [y | v^T] for x (m, p), y (m, qy), v (k, m) with
// row stride ldv (v may be null when k = 0), through partial (splits, p,
// qy + k). The simt bodies take any shapes; the wgmma body needs p and qy
// multiples of 4, 16-byte aligned x and y (TMA), k <= 8 and
// rows_per_split a multiple of 32.
extern "C" int gram_simt_f32(const float* x, int p, const float* y, int qy,
                             const float* v, long long ldv, int k,
                             float* partial, float* out, int m, int splits,
                             int rows_per_split, int device, void* stream) {
  return gram_simt<float>(x, p, y, qy, v, ldv, k, partial, out, m, splits,
                          rows_per_split, device,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int gram_simt_f64(const double* x, int p, const double* y,
                             int qy, const double* v, long long ldv, int k,
                             double* partial, double* out, int m, int splits,
                             int rows_per_split, int device, void* stream) {
  return gram_simt<double>(x, p, y, qy, v, ldv, k, partial, out, m, splits,
                           rows_per_split, device,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int gram_wgmma_f32(const float* x, int p, const float* y, int qy,
                              const float* v, long long ldv, int k,
                              float* partial, float* out, int m, int splits,
                              int rows_per_split, int device,
                              void* stream) {
  return wg::gram(x, p, y, qy, v, ldv, k, partial, out, m, splits,
                  rows_per_split, device,
                  static_cast<cudaStream_t>(stream));
}
