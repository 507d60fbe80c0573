// K4 spmm: out = S D for S (R, C) in padded blocked-ELL form and D (C, Q)
// dense, row-major, one dtype T (float or double), accumulated in T:
//   out[r, q] = sum_{k < blocks[r] * ell_block} vals[r, k] D[idx[r, k], q].
// Slots at or past a row's active K-blocks hold zeros and are skipped.
//
// Replaces src/repro/kernels/spmm/kernel.py:62 ell_spmm_pallas (body
// _make_kernel, :40): the sparse solvers' fused products A_B^T [A_B | r]
// (Lasso, sampled columns) and Y [Y^T | x] (SVM, sampled rows).
//
// What bounds it on the H100: bytes, and in practice latency. On the
// paths R = s mu = 64 (SVM, news20.binary: ~455 slots per row, Q = 65) or
// 128 (Lasso, url: ~86 slots per row, Q = 130): a few MB of gathered D
// rows against a few MFLOP. D itself (352 MB and 1.25 GB there) is far
// larger than shared memory and is read from global memory and L2; only
// the R * K gathered rows are touched.
//
// Design: the Pallas kernel walked a (row, K-block) grid with D resident
// in VMEM and the indices in SMEM by scalar prefetch, with D's lanes padded
// to 128. Here one block owns one output row and a 256-wide tile of q
// (blockIdx.y), 8 warps deal the row's active slots among themselves 32 at
// a time: lane l loads slot base + l's index and value in one coalesced
// read (the block loads its own indices), then the warp walks the 32 slots
// with shuffles, each lane accumulating up to 8 q columns in registers
// from one coalesced read of D's row. No lane padding: the q edge is
// masked. The 8 warps' partial rows are summed in a fixed order through
// shared memory, so results are identical run to run.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQTile = 256;             // dispatch.SPMM_Q_TILE
constexpr int kPerLane = kQTile / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const T* __restrict__ vals, const int* __restrict__ idx,
                const int* __restrict__ blocks, const T* __restrict__ D,
                T* __restrict__ out, int K, int Q, int ell_block) {
  __shared__ T part[kWarps][kQTile];
  const int r = blockIdx.x;
  const int q0 = blockIdx.y * kQTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int active = min(blocks[r], K / ell_block) * ell_block;
  const T* vrow = vals + (size_t)r * K;
  const int* irow = idx + (size_t)r * K;
  const T* Dq = D + q0;

  T acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = T(0);

  for (int base = warp * 32; base < active; base += kWarps * 32) {
    const int k = base + lane;
    const int my_c = k < active ? irow[k] : 0;
    const T my_v = k < active ? vrow[k] : T(0);
    const int n = min(32, active - base);
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const int c = __shfl_sync(0xffffffffu, my_c, t);
      const T v = __shfl_sync(0xffffffffu, my_v, t);
      const T* drow = Dq + (size_t)c * Q;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int q = lane + 32 * i;
        if (q0 + q < Q) acc[i] += v * drow[q];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPerLane; ++i) part[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  for (int q = threadIdx.x; q < kQTile && q0 + q < Q; q += kThreads) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][q];
    out[(size_t)r * Q + q0 + q] = s;
  }
}

template <typename T>
int ell_spmm(const T* vals, const int* idx, const int* blocks, const T* D,
             T* out, int R, int K, int Q, int ell_block, int q_tiles,
             int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R < 1 || K < 1 || Q < 1 || ell_block < 1 || K % ell_block != 0 ||
      q_tiles < 1 || q_tiles > 65535 || (long long)q_tiles * kQTile < Q)
    return cudaErrorInvalidValue;
  const dim3 grid(R, q_tiles);
  ell_spmm_kernel<T><<<grid, kThreads, 0, stream>>>(vals, idx, blocks, D, out,
                                                     K, Q, ell_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" int spmm_q_tile() { return kQTile; }

extern "C" int ell_spmm_f32(const float* vals, const int* idx,
                            const int* blocks, const float* D, float* out,
                            int R, int K, int Q, int ell_block, int q_tiles,
                            int device, void* stream) {
  return ell_spmm<float>(vals, idx, blocks, D, out, R, K, Q, ell_block,
                         q_tiles, device, static_cast<cudaStream_t>(stream));
}

extern "C" int ell_spmm_f64(const double* vals, const int* idx,
                            const int* blocks, const double* D, double* out,
                            int R, int K, int Q, int ell_block, int q_tiles,
                            int device, void* stream) {
  return ell_spmm<double>(vals, idx, blocks, D, out, R, K, Q, ell_block,
                          q_tiles, device, static_cast<cudaStream_t>(stream));
}
