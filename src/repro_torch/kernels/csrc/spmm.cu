// K4 spmm: out = S D for S (R, C) in padded blocked-ELL form and D (C, Q)
// dense, row-major, one dtype T (float or double), accumulated in T:
//   out[r, q] = sum_{k < blocks[r] * ell_block} vals[r, k] D[idx[r, k], q].
// Slots at or past a row's active K-blocks hold zeros and are skipped; a
// row with no active block is written as zeros.
//
// Replaces src/repro/kernels/spmm/kernel.py:62 ell_spmm_pallas (body
// _make_kernel, :40): the sparse solvers' fused products A_B^T [A_B | r]
// (Lasso, sampled columns) and Y [Y^T | x] (SVM, sampled rows).
//
// What bounds it on the H100: bytes, and in practice the latency of
// scattered reads. On the paths R = s mu = 64 (SVM, news20.binary: ~455
// active slots per row, Q = 65, rows of D 260 B) or 128 (Lasso, url: ~86
// per row, Q = 130, rows of 520 B): 6-8 MB of gathered D rows against a
// few MFLOP, each slot one scattered read of a D row. D itself (352 MB
// and 1.25 GB there) is far larger than shared memory and L2.
//
// Design: the Pallas kernel walked a (row, K-block) grid with D resident
// in VMEM and the indices in SMEM by scalar prefetch. Here:
// * The work matches Q. A warp covers a tile of q in NG = ceil(Q/32)
//   column groups (a template parameter: 3 at Q = 65, 5 at Q = 130),
//   lane l holding columns l + 32 g; Q above kMaxColGroups groups takes
//   more tiles along grid y. The q edge is masked.
// * The grid fills the card. Each output row's K slots are split over a
//   cluster of `splits` blocks of kWarps warps (dispatch.spmm_plan picks
//   splits so the grid holds a few blocks per SM); every warp takes an
//   even, contiguous share of the K slots, cut at the row's active
//   slots (dispatch.spmm_worker_range mirrors it).
// * Memory stays busy. A warp loads 32 slots' (index, value) pairs in one
//   coalesced read (the block loads its own indices), then issues the
//   D-row reads of kInFlight(NG) slots into registers before it consumes
//   any, ~2 KB in flight per warp whatever NG.
// * The sum is the same from run to run. Each block sums its warps'
//   partial rows in warp order in shared memory; the cluster's blocks
//   then sum the blocks' rows in rank order through distributed shared
//   memory, each block a share of the columns. No atomics, no second
//   launch.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;               // dispatch.SPMM_WARPS
constexpr int kThreads = kWarps * 32;
constexpr int kMaxColGroups = 8;        // dispatch.SPMM_MAX_COL_GROUPS
constexpr int kQTile = kMaxColGroups * 32;
constexpr int kMaxSplits = 8;           // dispatch.SPMM_MAX_SPLITS

// Slots whose D rows a warp reads before it consumes any.
__host__ __device__ constexpr int kInFlight(int ng) {
  return ng >= 8 ? 2 : 16 / ng;
}

template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const T* __restrict__ vals, const int* __restrict__ idx,
                const int* __restrict__ blocks, const T* __restrict__ D,
                T* __restrict__ out, int K, int Q, int ell_block,
                int splits) {
  constexpr int QT = NG * 32;
  constexpr int U = kInFlight(NG);
  __shared__ T part[kWarps][QT];
  const int rank = blockIdx.x % splits;
  const size_t r = blockIdx.x / splits;
  const int q0 = blockIdx.y * QT;
  const int qn = min(QT, Q - q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long workers = (long long)splits * kWarps;
  const long long worker = (long long)rank * kWarps + warp;
  const int lo = (int)(worker * K / workers);
  const int hi = (int)((worker + 1) * K / workers);
  const int* irow = idx + r * K;
  const T* vrow = vals + r * K;
  const T* Dq = D + q0;
  // Read beside the first indices: nothing below waits for it until the
  // slots are masked.
  const int active = min(blocks[r], K / ell_block) * ell_block;

  T acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = T(0);

  for (int base = lo; base < hi && base < active; base += 32) {
    const int n = min(32, min(hi, active) - base);
    const int my_c = lane < n ? irow[base + lane] : 0;
    const T my_v = lane < n ? vrow[base + lane] : T(0);
    for (int t = 0; t < n; t += U) {
      T v[U];
      const T* drow[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = __shfl_sync(0xffffffffu, my_c, (t + u) & 31);
        const T w = __shfl_sync(0xffffffffu, my_v, (t + u) & 31);
        const bool live = t + u < n;
        v[u] = live ? w : T(0);
        drow[u] = live ? Dq + (size_t)c * Q : nullptr;
      }
      T d[U][NG];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int q = lane + 32 * g;
          d[u][g] = (drow[u] != nullptr && q < qn) ? drow[u][q] : T(0);
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < NG; ++g) acc[g] += v[u] * d[u][g];
    }
  }

#pragma unroll
  for (int g = 0; g < NG; ++g) part[warp][lane + 32 * g] = acc[g];
  __syncthreads();
  // The block's row, in warp order, into part[0]: column q is read and
  // written by thread q alone.
  for (int q = threadIdx.x; q < qn; q += kThreads) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][q];
    if (splits == 1)
      out[r * Q + q0 + q] = s;
    else
      part[0][q] = s;
  }
  if (splits == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // The cluster's rows in rank order; block `rank` writes its share of
  // the columns.
  for (int q = rank * kThreads + threadIdx.x; q < qn;
       q += splits * kThreads) {
    T s = T(0);
    for (int j = 0; j < splits; ++j)
      s += cluster.map_shared_rank(&part[0][0], j)[q];
    out[r * Q + q0 + q] = s;
  }
  // No block leaves while another still reads its shared memory.
  cluster.sync();
}

template <typename T, int NG>
cudaError_t launch(const T* vals, const int* idx, const int* blocks,
                   const T* D, T* out, int R, int K, int Q, int ell_block,
                   int q_tiles, int splits, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)R * splits, q_tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, ell_spmm_kernel<T, NG>, vals, idx, blocks,
                            D, out, K, Q, ell_block, splits);
}

template <typename T>
int ell_spmm(const T* vals, const int* idx, const int* blocks, const T* D,
             T* out, int R, int K, int Q, int ell_block, int col_groups,
             int q_tiles, int splits, int device, cudaStream_t stream) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R < 1 || K < 1 || Q < 1 || ell_block < 1 || K % ell_block != 0 ||
      col_groups < 1 || col_groups > kMaxColGroups || q_tiles < 1 ||
      q_tiles > 65535 || (long long)q_tiles * col_groups * 32 < Q ||
      (long long)(q_tiles - 1) * col_groups * 32 >= Q || splits < 1 ||
      splits > kMaxSplits || (long long)R * splits > 2147483647LL)
    return cudaErrorInvalidValue;
#define SPMM_CASE(ng)                                                     \
  case ng:                                                                \
    err = launch<T, ng>(vals, idx, blocks, D, out, R, K, Q, ell_block,    \
                        q_tiles, splits, stream);                         \
    break;
  switch (col_groups) {
    SPMM_CASE(1)
    SPMM_CASE(2)
    SPMM_CASE(3)
    SPMM_CASE(4)
    SPMM_CASE(5)
    SPMM_CASE(6)
    SPMM_CASE(7)
    SPMM_CASE(8)
  }
#undef SPMM_CASE
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int spmm_q_tile() { return kQTile; }
extern "C" int spmm_warps() { return kWarps; }
extern "C" int spmm_max_splits() { return kMaxSplits; }
extern "C" int spmm_in_flight(int col_groups) { return kInFlight(col_groups); }

// out (R, Q) = S D through the grid of dispatch.spmm_plan: col_groups
// column groups of 32 a warp (at most 8), q_tiles tiles along grid y,
// splits blocks (one cluster) per row.
extern "C" int ell_spmm_f32(const float* vals, const int* idx,
                            const int* blocks, const float* D, float* out,
                            int R, int K, int Q, int ell_block,
                            int col_groups, int q_tiles, int splits,
                            int device, void* stream) {
  return ell_spmm<float>(vals, idx, blocks, D, out, R, K, Q, ell_block,
                         col_groups, q_tiles, splits, device,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int ell_spmm_f64(const double* vals, const int* idx,
                            const int* blocks, const double* D, double* out,
                            int R, int K, int Q, int ell_block,
                            int col_groups, int q_tiles, int splits,
                            int device, void* stream) {
  return ell_spmm<double>(vals, idx, blocks, D, out, R, K, Q, ell_block,
                          col_groups, q_tiles, splits, device,
                          static_cast<cudaStream_t>(stream));
}
