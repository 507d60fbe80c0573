// K2 sa_inner: the s dependent inner steps of SA-accelerated BCD for the
// Lasso / elastic-net prox (paper Alg. 2 lines 13-22), in one launch of
// one thread block. T is float or double; the compute type is T.
//
// Replaces src/repro/kernels/sa_inner/kernel.py:91 sa_inner_pallas
// (_make_kernel, :32), with K0 (src/repro/kernels/common.py:8
// power_iter_max_eig) as the device function power_iter_max_eig_warp.
//
// Inputs: G (s mu, s mu), y_proj / z_proj / z_vals (s, mu), idx (s, mu)
// int64, th_prev / coefU (s,). Outputs: dz (s, mu), eta (s,). Step j:
//   r_j   = th_j^2 y_proj[j] + z_proj[j]
//           - sum_{t<j} (th_j^2 coefU[t] - 1) G[j-block, t-block] dz_t
//   eta_j = 1 / max(q th_j lambda_max(G_jj), tiny of T)
//   z_j   = z_vals[j] + sum_{t<j} [idx[j] == idx[t]] dz_t   (collisions)
//   dz_j  = S_{lam1 eta_j}(z_j - eta_j r_j) / (1 + 2 eta_j lam2) - z_j
//
// What bounds it on the H100: neither bytes nor flops (at s = 16, mu = 8
// it reads 65 KB and does ~0.1 MFLOP) but latency: a chain of dependent
// block-wide reductions. The TPU kernel ran s (power_iters + 3) of them.
//
// Design: lambda_max(G_jj) does not depend on the recurrence, so all s
// power iterations run first, in parallel, one warp per diagonal block
// (16 warps), and the chain keeps only the s steps' cross-term / collision
// sums: per step one warp per row of the block, a lane-strided dot over
// the j mu earlier entries, a shuffle reduction, the prox in lane 0, and
// one __syncthreads. G stays in shared memory when the whole footprint
// fits (s mu <= ~238 at f32, ~168 at f64; the main path's s mu = 128 uses
// 64 KB), loaded once with coalesced reads; above that the same kernel
// (template G_SMEM = false) reads G's rows from global memory and L2.
#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

// Must match repro_torch.kernels.dispatch.sa_inner_smem_bytes.
inline size_t smem_bytes(int s, int mu, int itemsize, bool g_smem) {
  const size_t smu = (size_t)s * mu;
  const size_t elems = (g_smem ? smu * smu : 0) + smu + 3 * (size_t)s +
                       (size_t)kWarps * 2 * mu;
  return smu * 8 + elems * itemsize;
}

template <typename T, bool G_SMEM>
__global__ void __launch_bounds__(kThreads)
sa_inner_kernel(const T* __restrict__ G, const T* __restrict__ y_proj,
                const T* __restrict__ z_proj, const T* __restrict__ z_vals,
                const int64_t* __restrict__ idx,
                const T* __restrict__ th_prev, const T* __restrict__ coefU,
                T* __restrict__ dz_out, T* __restrict__ eta_out, int s,
                int mu, T q, T lam1, T lam2, int power_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int smu = s * mu;
  int64_t* s_idx = reinterpret_cast<int64_t*>(smem_raw);
  T* s_G = reinterpret_cast<T*>(s_idx + smu);
  T* s_dz = s_G + (G_SMEM ? (size_t)smu * smu : 0);
  T* s_th = s_dz + smu;
  T* s_coefU = s_th + s;
  T* s_eta = s_coefU + s;
  T* s_pw = s_eta + s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int k = tid; k < smu; k += kThreads) {
    s_idx[k] = idx[k];
    s_dz[k] = T(0);
  }
  for (int t = tid; t < s; t += kThreads) {
    s_th[t] = th_prev[t];
    s_coefU[t] = coefU[t];
  }
  if (G_SMEM) {
    const size_t n = (size_t)smu * smu;
    for (size_t e = tid; e < n; e += kThreads) s_G[e] = G[e];
  }
  __syncthreads();
  const T* Gm = G_SMEM ? s_G : G;

  // eta_j for every step: independent of the recurrence.
  for (int j = warp; j < s; j += kWarps) {
    const T* Gjj = Gm + (size_t)j * mu * smu + (size_t)j * mu;
    const T lam = (mu == 1)
        ? Gjj[0]
        : power_iter_max_eig_warp<T>(Gjj, smu, mu, power_iters,
                                     s_pw + (size_t)warp * 2 * mu, lane);
    if (lane == 0) {
      const T eta = T(1) / max(q * s_th[j] * lam, tiny_of<T>());
      s_eta[j] = eta;
      eta_out[j] = eta;
    }
  }
  __syncthreads();

  // The s dependent steps.
  for (int j = 0; j < s; ++j) {
    const T thp2 = s_th[j] * s_th[j];
    const int len = j * mu;
    for (int pr = warp; pr < mu; pr += kWarps) {
      const int row = j * mu + pr;
      const T yp = y_proj[row], zp = z_proj[row], zv = z_vals[row];
      const T* Grow = Gm + (size_t)row * smu;
      const int64_t me = s_idx[row];
      T cross = T(0), coll = T(0);
      for (int k = lane; k < len; k += 32) {
        const T d = s_dz[k];
        cross += Grow[k] * ((thp2 * s_coefU[k / mu] - T(1)) * d);
        coll += (s_idx[k] == me) ? d : T(0);
      }
      cross = warp_allreduce_sum(cross);
      coll = warp_allreduce_sum(coll);
      if (lane == 0) {
        const T eta = s_eta[j];
        const T rj = thp2 * yp + zp - cross;
        const T zj = zv + coll;
        const T g = zj - eta * rj;
        const T mag = max(fabs(g) - lam1 * eta, T(0));
        const T shrunk = g > T(0) ? mag : (g < T(0) ? -mag : T(0));
        const T d = shrunk / (T(1) + T(2) * eta * lam2) - zj;
        s_dz[row] = d;
        dz_out[row] = d;
      }
    }
    __syncthreads();
  }
}

template <typename T, bool G_SMEM>
cudaError_t launch(const T* G, const T* yp, const T* zp, const T* zv,
                   const int64_t* idx, const T* th, const T* cu, T* dz,
                   T* eta, int s, int mu, T q, T lam1, T lam2, int iters,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(s, mu, sizeof(T), G_SMEM);
  cudaError_t err = cudaFuncSetAttribute(
      sa_inner_kernel<T, G_SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  sa_inner_kernel<T, G_SMEM><<<1, kThreads, bytes, stream>>>(
      G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q, lam1, lam2, iters);
  return cudaGetLastError();
}

template <typename T>
int sa_inner(const T* G, const T* yp, const T* zp, const T* zv,
             const int64_t* idx, const T* th, const T* cu, T* dz, T* eta,
             int s, int mu, T q, T lam1, T lam2, int iters, int g_in_smem,
             int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return g_in_smem
      ? launch<T, true>(G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q, lam1,
                        lam2, iters, stream)
      : launch<T, false>(G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q, lam1,
                         lam2, iters, stream);
}

// Not a solver kernel: a latency probe for the bound of sa_inner and
// svm_inner, whose inner steps form one dependent chain. Each of `steps`
// rounds is what every inner step of both kernels waits on at least once:
// a warp shuffle reduction, then one block barrier, in one block of the
// same 16 warps (the shared partials alternate between two buffers so
// one barrier a round suffices). chip_smoke.py times it at two step
// counts; their difference over the steps is one step's latency.
__global__ void __launch_bounds__(kThreads)
sync_step_probe_kernel(int steps, float* out) {
  __shared__ float part[2][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float v = threadIdx.x * 1e-3f;
  for (int i = 0; i < steps; ++i) {
    v = warp_allreduce_sum(v);
    if (lane == 0) part[i & 1][warp] = v;
    __syncthreads();
    v = part[i & 1][(warp + 1) % kWarps] * 0.5f + lane * 1e-3f;
  }
  if (threadIdx.x == 0) out[0] = v;
}

}  // namespace

extern "C" int sync_step_probe(int steps, float* out, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  sync_step_probe_kernel<<<1, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(steps, out);
  return cudaGetLastError();
}

extern "C" long long sa_inner_smem_bytes(int s, int mu, int itemsize,
                                         int g_in_smem) {
  return (long long)smem_bytes(s, mu, itemsize, g_in_smem != 0);
}

extern "C" int sa_inner_f32(const float* G, const float* yp, const float* zp,
                            const float* zv, const int64_t* idx,
                            const float* th, const float* cu, float* dz,
                            float* eta, int s, int mu, float q, float lam1,
                            float lam2, int iters, int g_in_smem, int device,
                            void* stream) {
  return sa_inner<float>(G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q, lam1,
                         lam2, iters, g_in_smem, device,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int sa_inner_f64(const double* G, const double* yp,
                            const double* zp, const double* zv,
                            const int64_t* idx, const double* th,
                            const double* cu, double* dz, double* eta, int s,
                            int mu, double q, double lam1, double lam2,
                            int iters, int g_in_smem, int device,
                            void* stream) {
  return sa_inner<double>(G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q, lam1,
                          lam2, iters, g_in_smem, device,
                          static_cast<cudaStream_t>(stream));
}
