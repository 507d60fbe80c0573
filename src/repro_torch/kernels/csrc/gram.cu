// K1 gram: out = x^T y for x (m, p) and y (m, q), row-major, one dtype T
// (float or double), accumulated in T.
//
// Replaces src/repro/kernels/gram/kernel.py:48 gram_t_pallas (body
// _gram_kernel, :31): the fused Gram + projection block Y^T [Y | ytil |
// ztil] of every SA outer iteration (paper Alg. 2 lines 11-12).
//
// What bounds it on the H100: on the main path m = 400,000, p = 128,
// q = 130, i.e. 2 m p q = 13.3 GFLOP against 0.41 GB read. At the 67
// TFLOP/s of f32 FMA outside the tensor cores that is 0.20 ms of compute
// against 0.12 ms of memory at 3.35 TB/s: compute-bound. TF32 tensor
// cores would be faster but keep ~3 decimal digits, and the solvers'
// parity tests need f32.
//
// Design: the TPU grid tiled the (p, q) output and ran the m reduction
// innermost with a VMEM accumulator. Tall and skinny, that grid would put
// 6 blocks on 132 SMs, so the m axis is split instead (split-K): block
// (i, j, k) reduces rows [k R, (k+1) R) into a 64 x 64 output tile held
// in registers (4 x 4 per thread, fed by 16-byte shared-memory loads of a
// 32-row slice of x and y) and writes it to partial[k]. A second kernel
// sums the partials over k in a fixed order: no float atomics, so results
// are identical run to run.
#include "common.cuh"

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
                    T* __restrict__ partial, int m, int p, int q,
                    int rows_per_split) {
  __shared__ __align__(16) T xs[kBlockK][kTileP];
  __shared__ __align__(16) T ys[kBlockK][kTileQ];
  const int p0 = blockIdx.x * kTileP;
  const int q0 = blockIdx.y * kTileQ;
  const int m0 = blockIdx.z * rows_per_split;
  const int m1 = min(m, m0 + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

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
      ys[r][c] = (gm < m1 && gq < q) ? y[(size_t)gm * q + gq] : T(0);
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
int gram_t(const T* x, const T* y, T* partial, T* out, int m, int p, int q,
           int splits, int rows_per_split, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((p + kTileP - 1) / kTileP, (q + kTileQ - 1) / kTileQ,
                  splits);
  gram_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      x, y, partial, m, p, q, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pq = p * q;
  gram_reduce_kernel<T><<<(pq + 255) / 256, 256, 0, stream>>>(
      partial, out, pq, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gram_t_f32(const float* x, const float* y, float* partial,
                          float* out, int m, int p, int q, int splits,
                          int rows_per_split, int device, void* stream) {
  return gram_t<float>(x, y, partial, out, m, p, q, splits, rows_per_split,
                       device, static_cast<cudaStream_t>(stream));
}

extern "C" int gram_t_f64(const double* x, const double* y, double* partial,
                          double* out, int m, int p, int q, int splits,
                          int rows_per_split, int device, void* stream) {
  return gram_t<double>(x, y, partial, out, m, p, q, splits, rows_per_split,
                        device, static_cast<cudaStream_t>(stream));
}
