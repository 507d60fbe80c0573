// K3 svm_inner: the s dependent inner steps of SA-BDCD for the linear SVM
// (paper Alg. 4 lines 11-20, generalized to blocks of mu rows), in one
// launch of one thread block. T is float or double; the compute type is T.
//
// Replaces src/repro/kernels/svm_inner/kernel.py:91 svm_inner_pallas
// (_make_kernel, :27), with K0 (src/repro/kernels/common.py:8
// power_iter_max_eig) as the device function power_iter_max_eig_warp.
//
// Inputs: G (s mu, s mu) with gamma on its diagonal, proj / b / a_vals
// (s, mu), idx (s, mu) int64. Outputs: theta (s, mu), delta (s,). Step j,
// row p of block j:
//   r     = proj[j,p] + sum_{t<j, q} G[j-block p, t-block q] b[t,q] th[t,q]
//   beta  = a_vals[j,p] + sum_{t<j, q} [idx[j,p] == idx[t,q]] th[t,q]
//   g     = b[j,p] r - 1 + gamma beta
//   lam_j = G_jj[0,0] at mu = 1, else lambda_max(G_jj) by power iteration
//   th    = |clip(beta - g) - beta| != 0 ? clip(beta - g / lam_j) - beta : 0
// with clip to [0, nu] (to [0, inf) when nu = inf), and
//   delta_j = sum_p th g + 1/2 (b th)^T G_jj (b th).
// No floor on lam_j: the plain version has none, and neither has this.
//
// What bounds it on the H100: neither bytes nor flops (at s = 64, mu = 1
// it reads 17 KB and does ~0.02 MFLOP) but latency: a chain of s
// dependent steps. The TPU kernel ran, per step, the masked GEMV, the
// power iteration, the collision gather and the update in sequence.
//
// Both bodies take off the chain what does not depend on it:
// lambda_max(G_jj), every diagonal block's power iteration at once, one
// warp per block (16 warps), before the chain; the dual increments, one
// warp per step, after it. dispatch.svm_inner_route picks the body.
//
// * warp (mu <= 32, s mu <= 256, its layout in shared memory): before the
//   chain the 16 warps stage G (8 loads in flight a thread): its columns
//   scaled by b, transposed (column c at s_GbT + c (s mu + 1), so a lane
//   reads its rows of one column without bank conflicts), and the
//   diagonal blocks unscaled; and 1 / lambda_max of each step. The chain
//   runs in warp 0 alone, right-looking, with no block barrier: lane l
//   owns rows l, l + 32, ... and keeps their running r (from proj) and
//   beta (from a_vals) in registers. At step j the lanes that own block
//   j's rows compute its mu thetas (a clip and a product with 1 /
//   lambda_max each, no branch) and broadcast them by shuffle; every
//   lane then adds G_b[row, j mu + p] th and [idx[row] == idx[j mu + p]]
//   th into its rows. At mu = 1 row j sits in the same register slot of
//   every lane, so the step needs no per-lane select. The critical path
//   of a step is the update, one shuffle and one FMA; the history is
//   stored after the step's loads, and theta goes to global memory after
//   the chain. The sums run in step order, where the plain version sums
//   a masked product, and g / lambda_max is g (1 / lambda_max): a
//   rounding apart, inside repro's bars.
// * block (mu > 32, or a warp layout beyond shared memory): the chain
//   keeps one warp per row of a block: a lane-strided dot of G's row with
//   the b * theta history and the collision sum over the j mu earlier
//   entries, a shuffle reduction, the clipped update in lane 0, and one
//   __syncthreads per step. G stays in shared memory when the whole
//   footprint fits (s mu up to 238 at f32, 167 at f64, at mu = 1),
//   loaded once with coalesced reads; above that the same body (template
//   G_SMEM = false) reads G's rows from global memory and L2.
//
// Host side: the opt-in to more than 48 KB of dynamic shared memory is
// set once per instance and card, not at every launch.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;              // dispatch.SVM_INNER_WARPS
constexpr int kThreads = kWarps * 32;
constexpr int kWarpMaxMu = 32;          // dispatch.SVM_INNER_WARP_MAX_MU
// dispatch.SVM_INNER_WARP_MAX_ROWS_PER_LANE
constexpr int kWarpMaxRowsPerLane = 8;
constexpr int kSmemPerBlock = 232448;   // dispatch.SMEM_PER_BLOCK
constexpr int kMaxDevices = 64;
// Loads of G each thread of the warp body issues before it stores any.
constexpr int kStage = 8;

enum Body { kBlockGlobal = 0, kBlockSmem = 1, kWarpBody = 2 };

// Must match repro_torch.kernels.dispatch.svm_inner_smem_bytes.
inline size_t smem_bytes(int s, int mu, int itemsize, bool g_smem) {
  const size_t smu = (size_t)s * mu;
  const size_t elems = (g_smem ? smu * smu : 0) + 3 * smu + (size_t)s +
                       (size_t)kWarps * 2 * mu;
  return smu * 8 + elems * itemsize;
}

// Must match repro_torch.kernels.dispatch.svm_inner_warp_smem_bytes.
inline size_t warp_smem_bytes(int s, int mu, int itemsize) {
  const size_t smu = (size_t)s * mu;
  const size_t elems = smu * (smu + 1) + smu * mu + 3 * smu + (size_t)s +
                       (size_t)kWarps * 2 * mu;
  return smu * 8 + elems * itemsize;
}

// clip(x, 0, nu), propagating NaN as the plain version's clamp does.
template <typename T>
__device__ __forceinline__ T clip(T x, T nu, bool finite_nu) {
  x = x < T(0) ? T(0) : x;
  return (finite_nu && x > nu) ? nu : x;
}

// delta_j = sum_p th g + 1/2 sum_p bt_p (G_jj bt)_p, one warp per step.
// Row p of G_jj is at Gd + (j mu + p) ld + j mu in the full matrix (row
// stride ld), or at Gd + j mu mu + p mu where the diagonal blocks are
// packed (diag_packed).
template <typename T>
__device__ __forceinline__ void dual_increments(
    const T* Gd, size_t ld, bool diag_packed, const T* s_th, const T* s_g,
    const T* s_bt, T* delta_out, int s, int mu, int warp, int lane) {
  for (int j = warp; j < s; j += kWarps) {
    T tg = T(0), quad = T(0);
    for (int p = lane; p < mu; p += 32) {
      const int row = j * mu + p;
      const T* Grow = diag_packed
          ? Gd + (size_t)j * mu * mu + (size_t)p * mu
          : Gd + (size_t)row * ld + (size_t)j * mu;
      T w = T(0);
      for (int q = 0; q < mu; ++q) w += Grow[q] * s_bt[j * mu + q];
      tg += s_th[row] * s_g[row];
      quad += s_bt[row] * w;
    }
    tg = warp_allreduce_sum(tg);
    quad = warp_allreduce_sum(quad);
    if (lane == 0) delta_out[j] = tg + T(0.5) * quad;
  }
}

template <typename T, bool G_SMEM>
__global__ void __launch_bounds__(kThreads)
svm_inner_kernel(const T* __restrict__ G, const T* __restrict__ proj,
                 const T* __restrict__ b_sel, const T* __restrict__ a_vals,
                 const int64_t* __restrict__ idx, T* __restrict__ theta_out,
                 T* __restrict__ delta_out, int s, int mu, T gamma, T nu,
                 bool finite_nu, int power_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int smu = s * mu;
  int64_t* s_idx = reinterpret_cast<int64_t*>(smem_raw);
  T* s_G = reinterpret_cast<T*>(s_idx + smu);
  T* s_th = s_G + (G_SMEM ? (size_t)smu * smu : 0);
  T* s_bt = s_th + smu;
  T* s_g = s_bt + smu;
  T* s_lam = s_g + smu;
  T* s_pw = s_lam + s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int k = tid; k < smu; k += kThreads) {
    s_idx[k] = idx[k];
    s_th[k] = T(0);
    s_bt[k] = T(0);
  }
  if (G_SMEM) {
    const size_t n = (size_t)smu * smu;
    for (size_t e = tid; e < n; e += kThreads) s_G[e] = G[e];
  }
  __syncthreads();
  const T* Gm = G_SMEM ? s_G : G;

  // lambda_max of every diagonal block: independent of the recurrence.
  for (int j = warp; j < s; j += kWarps) {
    const T* Gjj = Gm + (size_t)j * mu * smu + (size_t)j * mu;
    const T lam = (mu == 1)
        ? Gjj[0]
        : power_iter_max_eig_warp<T>(Gjj, smu, mu, power_iters,
                                     s_pw + (size_t)warp * 2 * mu, lane);
    if (lane == 0) s_lam[j] = lam;
  }
  __syncthreads();

  // The s dependent steps.
  for (int j = 0; j < s; ++j) {
    const int len = j * mu;
    for (int pr = warp; pr < mu; pr += kWarps) {
      const int row = j * mu + pr;
      const T* Grow = Gm + (size_t)row * smu;
      const int64_t me = s_idx[row];
      T cross = T(0), coll = T(0);
      for (int k = lane; k < len; k += 32) {
        cross += Grow[k] * s_bt[k];
        coll += (s_idx[k] == me) ? s_th[k] : T(0);
      }
      cross = warp_allreduce_sum(cross);
      coll = warp_allreduce_sum(coll);
      if (lane == 0) {
        const T bj = b_sel[row];
        const T beta = a_vals[row] + coll;
        const T g = bj * (proj[row] + cross) - T(1) + gamma * beta;
        const T gbar = fabs(clip(beta - g, nu, finite_nu) - beta);
        const T th = gbar != T(0)
            ? clip(beta - g / s_lam[j], nu, finite_nu) - beta
            : T(0);
        s_th[row] = th;
        s_bt[row] = bj * th;
        s_g[row] = g;
        theta_out[row] = th;
      }
    }
    __syncthreads();
  }

  dual_increments<T>(Gm, smu, false, s_th, s_g, s_bt, delta_out, s, mu,
                     warp, lane);
}

// The warp body; RPL (a power of two, at most kWarpMaxRowsPerLane) rows
// per lane cover s mu. One block a launch: up to 128 registers a thread.
template <typename T, int RPL>
__global__ void __launch_bounds__(kThreads, 1)
svm_inner_warp_kernel(const T* __restrict__ G, const T* __restrict__ proj,
                      const T* __restrict__ b_sel,
                      const T* __restrict__ a_vals,
                      const int64_t* __restrict__ idx,
                      T* __restrict__ theta_out, T* __restrict__ delta_out,
                      int s, int mu, T gamma, T nu, bool finite_nu,
                      int power_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int smu = s * mu;
  const int pitch = smu + 1;
  int64_t* s_idx = reinterpret_cast<int64_t*>(smem_raw);
  T* s_GbT = reinterpret_cast<T*>(s_idx + smu);
  T* s_D = s_GbT + (size_t)smu * pitch;
  T* s_th = s_D + (size_t)smu * mu;
  T* s_g = s_th + smu;
  T* s_bt = s_g + smu;
  T* s_rlam = s_bt + smu;                // 1 / lambda_max per step
  T* s_pw = s_rlam + s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Warp 0's rows, read while the block stages G: r from proj, beta from
  // a_vals, the label and the sampled id.
  T r_acc[RPL], beta[RPL], b_row[RPL];
  int64_t id_row[RPL];
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int row = lane + 32 * i;
      const bool in = row < smu;
      r_acc[i] = in ? proj[row] : T(0);
      beta[i] = in ? a_vals[row] : T(0);
      b_row[i] = in ? b_sel[row] : T(0);
      id_row[i] = in ? idx[row] : int64_t(-1);
    }
  }
  for (int k = tid; k < smu; k += kThreads) s_idx[k] = idx[k];
  // G read once, coalesced, kStage loads in flight a thread: its columns
  // scaled by b and transposed, and its diagonal blocks as they are.
  const int n = smu * smu;
  for (int e0 = tid; e0 < n; e0 += kThreads * kStage) {
    T gv[kStage], bv[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int e = e0 + k * kThreads;
      if (e < n) {
        gv[k] = G[e];
        bv[k] = b_sel[e % smu];
      }
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int e = e0 + k * kThreads;
      if (e < n) {
        const int row = e / smu, col = e - row * smu;
        s_GbT[(size_t)col * pitch + row] = gv[k] * bv[k];
        const int j = row / mu;
        if (col / mu == j)
          s_D[(size_t)j * mu * mu + (size_t)(row - j * mu) * mu +
              (col - j * mu)] = gv[k];
      }
    }
  }
  __syncthreads();

  for (int j = warp; j < s; j += kWarps) {
    const T* Gjj = s_D + (size_t)j * mu * mu;
    const T lam = (mu == 1)
        ? Gjj[0]
        : power_iter_max_eig_warp<T>(Gjj, mu, mu, power_iters,
                                     s_pw + (size_t)warp * 2 * mu, lane);
    if (lane == 0) s_rlam[j] = T(1) / lam;
  }
  __syncthreads();

  if (warp == 0 && mu == 1) {
    // Row j is lane j % 32's slot j / 32, the same slot in every lane.
    for (int j = 0; j < s; ++j) {
      const int slot = j >> 5;
      T r = T(0), be = T(0), bj = T(0);
#pragma unroll
      for (int i = 0; i < RPL; ++i)
        if (i == slot) {
          r = r_acc[i];
          be = beta[i];
          bj = b_row[i];
        }
      const T g = bj * r - T(1) + gamma * be;
      const T gbar = fabs(clip(be - g, nu, finite_nu) - be);
      const T step = clip(be - g * s_rlam[j], nu, finite_nu) - be;
      const T th = __shfl_sync(0xffffffffu, gbar != T(0) ? step : T(0),
                               j & 31);
      const int64_t idj = s_idx[j];
      const T* gcol = s_GbT + (size_t)j * pitch;
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const int row = lane + 32 * i;
        if (row < smu) {
          r_acc[i] += gcol[row] * th;
          beta[i] += (id_row[i] == idj) ? th : T(0);
        }
      }
      if (lane == (j & 31)) {
        s_th[j] = th;
        s_g[j] = g;
        s_bt[j] = bj * th;
      }
    }
  } else if (warp == 0) {
    for (int j = 0; j < s; ++j) {
      const int row0 = j * mu;
      // This lane's row of block j, if p < mu (mu <= 32: at most one).
      const int p = (lane - row0) & 31;
      const bool own = p < mu;
      const int myrow = row0 + p;
      const int slot = myrow >> 5;
      T r = T(0), be = T(0), bj = T(0);
#pragma unroll
      for (int i = 0; i < RPL; ++i)
        if (i == slot) {
          r = r_acc[i];
          be = beta[i];
          bj = b_row[i];
        }
      const T g = bj * r - T(1) + gamma * be;
      const T gbar = fabs(clip(be - g, nu, finite_nu) - be);
      const T step = clip(be - g * s_rlam[j], nu, finite_nu) - be;
      const T th = (own && gbar != T(0)) ? step : T(0);
      // The step stores its history only after the update's loads, so
      // the compiler may issue those loads ahead of the division.
      for (int q = 0; q < mu; ++q) {
        const int col = row0 + q;
        const T thq = __shfl_sync(0xffffffffu, th, col & 31);
        const int64_t idq = s_idx[col];
        const T* gcol = s_GbT + (size_t)col * pitch;
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
          const int row = lane + 32 * i;
          if (row < smu) {
            r_acc[i] += gcol[row] * thq;
            beta[i] += (id_row[i] == idq) ? thq : T(0);
          }
        }
      }
      if (own) {
        s_th[myrow] = th;
        s_g[myrow] = g;
        s_bt[myrow] = bj * th;
      }
    }
  }
  __syncthreads();

  for (int k = tid; k < smu; k += kThreads) theta_out[k] = s_th[k];
  dual_increments<T>(s_D, 0, true, s_th, s_g, s_bt, delta_out, s, mu, warp,
                     lane);
}

// Opt in to more than 48 KB of dynamic shared memory for `kernel`, once
// per card: `done` is the instance's own flag array.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int device, bool* done) {
  if (bytes <= 48 * 1024 || (device < kMaxDevices && done[device]))
    return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlock);
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

template <typename T, bool G_SMEM>
cudaError_t launch_block(const T* G, const T* proj, const T* b, const T* a,
                         const int64_t* idx, T* theta, T* delta, int s,
                         int mu, T gamma, T nu, int iters, int device,
                         cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const size_t bytes = smem_bytes(s, mu, sizeof(T), G_SMEM);
  if (bytes > (size_t)kSmemPerBlock) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(svm_inner_kernel<T, G_SMEM>, bytes, device,
                               done);
  if (err != cudaSuccess) return err;
  svm_inner_kernel<T, G_SMEM><<<1, kThreads, bytes, stream>>>(
      G, proj, b, a, idx, theta, delta, s, mu, gamma, nu, std::isfinite(nu),
      iters);
  return cudaGetLastError();
}

template <typename T, int RPL>
cudaError_t launch_warp(const T* G, const T* proj, const T* b, const T* a,
                        const int64_t* idx, T* theta, T* delta, int s, int mu,
                        T gamma, T nu, int iters, int device,
                        cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const size_t bytes = warp_smem_bytes(s, mu, sizeof(T));
  cudaError_t err = allow_smem(svm_inner_warp_kernel<T, RPL>, bytes, device,
                               done);
  if (err != cudaSuccess) return err;
  svm_inner_warp_kernel<T, RPL><<<1, kThreads, bytes, stream>>>(
      G, proj, b, a, idx, theta, delta, s, mu, gamma, nu, std::isfinite(nu),
      iters);
  return cudaGetLastError();
}

template <typename T>
int svm_inner(const T* G, const T* proj, const T* b, const T* a,
              const int64_t* idx, T* theta, T* delta, int s, int mu, T gamma,
              T nu, int iters, int body, int device, cudaStream_t stream) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (s < 1 || mu < 1) return cudaErrorInvalidValue;
  if (body == kBlockGlobal)
    return launch_block<T, false>(G, proj, b, a, idx, theta, delta, s, mu,
                                  gamma, nu, iters, device, stream);
  if (body == kBlockSmem)
    return launch_block<T, true>(G, proj, b, a, idx, theta, delta, s, mu,
                                 gamma, nu, iters, device, stream);
  const int smu = s * mu;
  if (body != kWarpBody || mu > kWarpMaxMu ||
      smu > 32 * kWarpMaxRowsPerLane ||
      warp_smem_bytes(s, mu, sizeof(T)) > (size_t)kSmemPerBlock)
    return cudaErrorInvalidValue;
  const int rows = (smu + 31) / 32;
  if (rows <= 1)
    return launch_warp<T, 1>(G, proj, b, a, idx, theta, delta, s, mu, gamma,
                             nu, iters, device, stream);
  if (rows <= 2)
    return launch_warp<T, 2>(G, proj, b, a, idx, theta, delta, s, mu, gamma,
                             nu, iters, device, stream);
  if (rows <= 4)
    return launch_warp<T, 4>(G, proj, b, a, idx, theta, delta, s, mu, gamma,
                             nu, iters, device, stream);
  return launch_warp<T, 8>(G, proj, b, a, idx, theta, delta, s, mu, gamma,
                           nu, iters, device, stream);
}

}  // namespace

extern "C" long long svm_inner_smem_bytes(int s, int mu, int itemsize,
                                          int g_in_smem) {
  return (long long)smem_bytes(s, mu, itemsize, g_in_smem != 0);
}

extern "C" long long svm_inner_warp_smem_bytes(int s, int mu, int itemsize) {
  return (long long)warp_smem_bytes(s, mu, itemsize);
}

// body: 0 the block body with G in global memory, 1 the block body with G
// in shared memory, 2 the warp body.
extern "C" int svm_inner_f32(const float* G, const float* proj,
                             const float* b, const float* a,
                             const int64_t* idx, float* theta, float* delta,
                             int s, int mu, float gamma, float nu, int iters,
                             int body, int device, void* stream) {
  return svm_inner<float>(G, proj, b, a, idx, theta, delta, s, mu, gamma, nu,
                          iters, body, device,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int svm_inner_f64(const double* G, const double* proj,
                             const double* b, const double* a,
                             const int64_t* idx, double* theta,
                             double* delta, int s, int mu, double gamma,
                             double nu, int iters, int body, int device,
                             void* stream) {
  return svm_inner<double>(G, proj, b, a, idx, theta, delta, s, mu, gamma,
                           nu, iters, body, device,
                           static_cast<cudaStream_t>(stream));
}
