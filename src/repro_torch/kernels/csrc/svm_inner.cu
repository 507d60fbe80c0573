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
// Design: lambda_max(G_jj) does not depend on the recurrence, so every
// diagonal block's power iteration runs first, in parallel, one warp per
// block (16 warps); the dual increments depend on theta but feed nothing,
// so they run after the chain, one warp per step. The chain keeps, per
// step, one warp per row of the block: a lane-strided dot of G's row with
// the b * theta history and the collision sum over the j mu earlier
// entries, a shuffle reduction, the clipped update in lane 0, and one
// __syncthreads. G stays in shared memory when the whole footprint fits
// (s mu up to 238 at f32, 167 at f64, at mu = 1), loaded once with
// coalesced reads; above that the same kernel (template G_SMEM = false)
// reads G's rows from global memory and L2.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;              // dispatch.SVM_INNER_WARPS
constexpr int kThreads = kWarps * 32;

// Must match repro_torch.kernels.dispatch.svm_inner_smem_bytes.
inline size_t smem_bytes(int s, int mu, int itemsize, bool g_smem) {
  const size_t smu = (size_t)s * mu;
  const size_t elems = (g_smem ? smu * smu : 0) + 3 * smu + (size_t)s +
                       (size_t)kWarps * 2 * mu;
  return smu * 8 + elems * itemsize;
}

// clip(x, 0, nu), propagating NaN as the plain version's clamp does.
template <typename T>
__device__ __forceinline__ T clip(T x, T nu, bool finite_nu) {
  x = x < T(0) ? T(0) : x;
  return (finite_nu && x > nu) ? nu : x;
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

  // delta_j = sum_p th g + 1/2 sum_p bt_p (G_jj bt)_p, one warp per step.
  for (int j = warp; j < s; j += kWarps) {
    T tg = T(0), quad = T(0);
    for (int p = lane; p < mu; p += 32) {
      const int row = j * mu + p;
      const T* Grow = Gm + (size_t)row * smu + (size_t)j * mu;
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
cudaError_t launch(const T* G, const T* proj, const T* b, const T* a,
                   const int64_t* idx, T* theta, T* delta, int s, int mu,
                   T gamma, T nu, int iters, cudaStream_t stream) {
  const size_t bytes = smem_bytes(s, mu, sizeof(T), G_SMEM);
  cudaError_t err = cudaFuncSetAttribute(
      svm_inner_kernel<T, G_SMEM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  svm_inner_kernel<T, G_SMEM><<<1, kThreads, bytes, stream>>>(
      G, proj, b, a, idx, theta, delta, s, mu, gamma, nu, std::isfinite(nu),
      iters);
  return cudaGetLastError();
}

template <typename T>
int svm_inner(const T* G, const T* proj, const T* b, const T* a,
              const int64_t* idx, T* theta, T* delta, int s, int mu, T gamma,
              T nu, int iters, int g_in_smem, int device,
              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return g_in_smem
      ? launch<T, true>(G, proj, b, a, idx, theta, delta, s, mu, gamma, nu,
                        iters, stream)
      : launch<T, false>(G, proj, b, a, idx, theta, delta, s, mu, gamma, nu,
                         iters, stream);
}

}  // namespace

extern "C" long long svm_inner_smem_bytes(int s, int mu, int itemsize,
                                          int g_in_smem) {
  return (long long)smem_bytes(s, mu, itemsize, g_in_smem != 0);
}

extern "C" int svm_inner_f32(const float* G, const float* proj,
                             const float* b, const float* a,
                             const int64_t* idx, float* theta, float* delta,
                             int s, int mu, float gamma, float nu, int iters,
                             int g_in_smem, int device, void* stream) {
  return svm_inner<float>(G, proj, b, a, idx, theta, delta, s, mu, gamma, nu,
                          iters, g_in_smem, device,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int svm_inner_f64(const double* G, const double* proj,
                             const double* b, const double* a,
                             const int64_t* idx, double* theta,
                             double* delta, int s, int mu, double gamma,
                             double nu, int iters, int g_in_smem, int device,
                             void* stream) {
  return svm_inner<double>(G, proj, b, a, idx, theta, delta, s, mu, gamma,
                           nu, iters, g_in_smem, device,
                           static_cast<cudaStream_t>(stream));
}
