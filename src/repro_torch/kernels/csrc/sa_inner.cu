// K2 sa_inner: the s dependent inner steps of SA-accelerated BCD for the
// Lasso / elastic-net prox (paper Alg. 2 lines 13-22), in one launch of
// one thread block. T is float or double; the compute type is T.
//
// Replaces src/repro/kernels/sa_inner/kernel.py:91 sa_inner_pallas
// (_make_kernel, :32), with K0 (src/repro/kernels/common.py:8
// power_iter_max_eig) as the device functions power_iter_max_eig_warp
// (block body) and power_iter_max_eig_group (warp body).
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
// it reads 65 KB and does ~0.1 MFLOP) but latency: the power iterations'
// 33 dependent rounds, then a chain of s dependent steps. The TPU kernel
// ran s (power_iters + 3) of them.
//
// Both bodies take lambda_max(G_jj) off the chain: it does not depend on
// the recurrence, so every block's power iteration runs at once before
// the chain. dispatch.sa_inner_route picks the body.
//
// * warp (mu <= 32, s mu <= 256, its layout in shared memory): the last
//   W warps run the power iterations, 32 / P blocks a warp (P the least
//   power of two >= mu), each block's columns in the registers of a
//   group of P lanes, read straight from global memory
//   (power_iter_max_eig_group), and write eta; at mu = 1 there is none
//   (W = 0). Meanwhile warps 1 .. 15 - W find each row's collisions (the
//   first and the next row with its id, by shuffles) and stage coefU and
//   G (kStage loads in flight a thread; its columns transposed, column c
//   at s_GT + c (s mu + 1), so a lane reads its rows of one column
//   without bank conflicts), and warp 0 reads its rows. One block barrier
//   starts the chain, which runs in warp 0 alone, right-looking, with no
//   further barrier: lane l owns rows l, l + 32, ... and keeps their th^2
//   and running r (from th^2 y_proj + z_proj) in registers. At step j the
//   lanes that own block j's rows add to z_vals the dz of the earlier
//   rows with the same id (a walk along the next-row links, in row order;
//   the warp skips it when no lane has one), compute their dz (the soft
//   threshold by selects) and broadcast the mu values by shuffle; every
//   lane then subtracts G[row, j mu + p] ((th_row^2 coefU_j - 1) dz_p)
//   from r of each of its rows, in step order, with no branch (rows done
//   or past s mu take updates no one reads). At mu = 1 row j sits in the
//   same register slot of every lane, so the step needs no per-lane
//   select. The owner lanes store each dz as it is computed (nothing
//   waits on a store). Each role of warp reaches the barrier from its own
//   branch, so the chain's row registers are not live through the power
//   iterations'. The sums run in step order where the block body sums a
//   row's history at once, and the prox multiplies by 1 / (1 + 2 eta
//   lam2) where the plain version divides: a rounding apart, inside
//   repro's bars. eta is the block body's, bit for bit.
// * block (mu > 32, or a warp layout beyond shared memory): one warp per
//   diagonal block runs its power iteration through shared memory; the
//   chain keeps one warp per row of a block: a lane-strided dot over the
//   j mu earlier entries, a shuffle reduction, the prox in lane 0, and
//   one __syncthreads per step. G stays in shared memory when the whole
//   footprint fits (s mu <= ~238 at f32, ~168 at f64), loaded once with
//   coalesced reads; above that the same body (template G_SMEM = false)
//   reads G's rows from global memory and L2.
//
// Host side: the opt-in to more than 48 KB of dynamic shared memory is
// set once per instance and card, not at every launch.
#include "common.cuh"

namespace {

constexpr int kWarps = 16;              // dispatch.SA_INNER_WARPS
constexpr int kThreads = kWarps * 32;
constexpr int kWarpMaxMu = 32;          // dispatch.SA_INNER_WARP_MAX_MU
// dispatch.SA_INNER_WARP_MAX_ROWS_PER_LANE
constexpr int kWarpMaxRowsPerLane = 8;
constexpr int kSmemPerBlock = 232448;   // dispatch.SMEM_PER_BLOCK
constexpr int kMaxDevices = 64;
// Loads of G each staging thread of the warp body issues before it
// stores any.
constexpr int kStage = 8;

enum Body { kBlockGlobal = 0, kBlockSmem = 1, kWarpBody = 2 };

// Must match repro_torch.kernels.dispatch.sa_inner_smem_bytes.
inline size_t smem_bytes(int s, int mu, int itemsize, bool g_smem) {
  const size_t smu = (size_t)s * mu;
  const size_t elems = (g_smem ? smu * smu : 0) + smu + 3 * (size_t)s +
                       (size_t)kWarps * 2 * mu;
  return smu * 8 + elems * itemsize;
}

// Must match repro_torch.kernels.dispatch.sa_inner_warp_smem_bytes.
inline size_t warp_smem_bytes(int s, int mu, int itemsize) {
  const size_t smu = (size_t)s * mu;
  return (smu * (smu + 2) + 2 * (size_t)s) * itemsize + smu * 4;
}

// Makes x be computed where it stands: the compiler may not move it past
// this point (to its use in the next step, on the chain).
__device__ __forceinline__ void settle(float& x) {
  asm volatile("" : "+f"(x));
}
__device__ __forceinline__ void settle(double& x) {
  asm volatile("" : "+d"(x));
}

// Does the warp body serve (s, mu)? Must match
// repro_torch.kernels.dispatch.sa_inner_route.
inline bool warp_fits(int s, int mu, int itemsize) {
  return mu <= kWarpMaxMu && s * mu <= 32 * kWarpMaxRowsPerLane &&
         warp_smem_bytes(s, mu, itemsize) <= (size_t)kSmemPerBlock;
}

// The least power of two >= mu: the lanes of one power-iteration group.
__host__ __device__ inline int group_width(int mu) {
  int p = 1;
  while (p < mu) p <<= 1;
  return p;
}

// Warps of the warp body that run power iterations (none at mu = 1).
__host__ __device__ inline int power_warps(int s, int mu) {
  return mu == 1 ? 0 : (s * group_width(mu) + 31) / 32;
}

template <typename T, bool G_SMEM>
__global__ void __launch_bounds__(kThreads, 1)
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

// eta of the blocks of power-iteration warp pw (32 / P blocks, one per
// group of P lanes), written to s_eta and eta_out.
template <typename T, int P>
__device__ __forceinline__ void warp_step_sizes(
    const T* G, int smu, int s, int mu, const T* th_prev, T q, int iters,
    int pw, int lane, T* s_eta, T* eta_out) {
  const int j = pw * (32 / P) + lane / P, c = lane % P;
  const bool live = j < s;
  const T lam = power_iter_max_eig_group<T, P>(
      G + (live ? (size_t)j * mu * smu + (size_t)j * mu : 0), smu, mu,
      iters, c, live);
  if (live && c == 0) {
    const T eta = T(1) / max(q * th_prev[j] * lam, tiny_of<T>());
    s_eta[j] = eta;
    eta_out[j] = eta;
  }
}

// The block barrier that ends the warp body's staging. Each role of
// warp (chain, staging, power iterations) reaches it from its own branch,
// so the registers of one role are not held live through another's.
__device__ __forceinline__ void staged_barrier() {
  asm volatile("bar.sync 0;" ::: "memory");
}

// The warp body's staging, by the `stagers` threads of warps 1.. (tid
// counted from warp 1): the rows' collisions, coefU (and, at mu = 1, eta
// from G_jj itself), and G.
template <typename T>
__device__ __forceinline__ void warp_body_stage(
    const T* __restrict__ G, const int64_t* __restrict__ idx,
    const T* __restrict__ th_prev, const T* __restrict__ coefU,
    T* __restrict__ eta_out, int s, int mu, T q, int tid, int stagers,
    T* s_GT, T* s_coefU, T* s_eta, int* s_coll) {
  const int smu = s * mu;
  // Each row's collisions: the first row with its id (itself if none is
  // earlier) in the low 16 bits, the next row with its id (s mu if none)
  // in the high 16 bits. A staging warp takes 32 rows, one a lane, and
  // meets the ids 32 at a time: one coalesced load, then shuffles.
  const int lane = tid & 31;
  for (int k0 = tid - lane; k0 < smu; k0 += stagers) {
    const int k = k0 + lane;
    const int64_t me = k < smu ? idx[k] : int64_t(-1);
    int first = k, next = smu;
    for (int c0 = 0; c0 < smu; c0 += 32) {
      const int64_t mine = c0 + lane < smu ? idx[c0 + lane] : int64_t(-1);
#pragma unroll 8
      for (int src = 0; src < 32; ++src) {
        const int64_t other = __shfl_sync(0xffffffffu, mine, src);
        const int k2 = c0 + src;
        const bool same = other == me && k2 < smu;
        first = same && k2 < first ? k2 : first;
        next = same && k2 > k && k2 < next ? k2 : next;
      }
    }
    if (k < smu) s_coll[k] = first | (next << 16);
  }
  for (int t = tid; t < s; t += stagers) {
    s_coefU[t] = coefU[t];
    if (mu == 1) {
      const T eta = T(1) / max(q * th_prev[t] * G[(size_t)t * smu + t],
                               tiny_of<T>());
      s_eta[t] = eta;
      eta_out[t] = eta;
    }
  }
  // G read once, coalesced, kStage loads in flight a thread, stored with
  // its columns transposed. Element e = row smu + col; a thread's next
  // one is `stagers` on: (row, col) advances by (drow, dcol), one carry.
  const int pitch = smu + 1, n = smu * smu;
  const int drow = stagers / smu, dcol = stagers - drow * smu;
  int row = tid / smu, col = tid - row * smu;
  for (int e0 = tid; e0 < n; e0 += stagers * kStage) {
    T gv[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int e = e0 + k * stagers;
      if (e < n) gv[k] = G[e];
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      if (e0 + k * stagers < n) s_GT[(size_t)col * pitch + row] = gv[k];
      row += drow;
      col += dcol;
      if (col >= smu) {
        col -= smu;
        ++row;
      }
    }
  }
}

// The warp body; RPL (a power of two, at most kWarpMaxRowsPerLane) rows
// per lane cover s mu. One block a launch: up to 128 registers a thread.
template <typename T, int RPL>
__global__ void __launch_bounds__(kThreads, 1)
sa_inner_warp_kernel(const T* __restrict__ G, const T* __restrict__ y_proj,
                     const T* __restrict__ z_proj,
                     const T* __restrict__ z_vals,
                     const int64_t* __restrict__ idx,
                     const T* __restrict__ th_prev,
                     const T* __restrict__ coefU, T* __restrict__ dz_out,
                     T* __restrict__ eta_out, int s, int mu, T q, T lam1,
                     T lam2, int power_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int smu = s * mu;
  const int pitch = smu + 1;
  T* s_GT = reinterpret_cast<T*>(smem_raw);
  T* s_coefU = s_GT + (size_t)smu * pitch;
  T* s_eta = s_coefU + s;
  T* s_dz = s_eta + s;
  int* s_coll = reinterpret_cast<int*>(s_dz + smu);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stagers = (kWarps - power_warps(s, mu)) * 32;
  // Columns of a step's update unrolled together (fewer where the rows'
  // registers are many).
  constexpr int kUnroll = sizeof(T) * RPL <= 16 ? 8
                          : sizeof(T) * RPL <= 32 ? 4 : 2;

  if (warp != 0) {
    if (tid < stagers) {
      warp_body_stage<T>(G, idx, th_prev, coefU, eta_out, s, mu, q,
                         tid - 32, stagers - 32, s_GT, s_coefU, s_eta,
                         s_coll);
    } else {
      const int pw = warp - stagers / 32;
      switch (group_width(mu)) {
        case 2: warp_step_sizes<T, 2>(G, smu, s, mu, th_prev, q,
                                      power_iters, pw, lane, s_eta,
                                      eta_out); break;
        case 4: warp_step_sizes<T, 4>(G, smu, s, mu, th_prev, q,
                                      power_iters, pw, lane, s_eta,
                                      eta_out); break;
        case 8: warp_step_sizes<T, 8>(G, smu, s, mu, th_prev, q,
                                      power_iters, pw, lane, s_eta,
                                      eta_out); break;
        case 16: warp_step_sizes<T, 16>(G, smu, s, mu, th_prev, q,
                                        power_iters, pw, lane, s_eta,
                                        eta_out); break;
        default: warp_step_sizes<T, 32>(G, smu, s, mu, th_prev, q,
                                        power_iters, pw, lane, s_eta,
                                        eta_out);
      }
    }
    staged_barrier();
    return;
  }

  // Warp 0's rows, read while warps 1.. stage: th^2 of the row's step, r
  // from th^2 y_proj + z_proj, z from z_vals. (Warp 0 does not stage:
  // with its rows live it would hold few loads in flight.)
  T r_acc[RPL], zv[RPL], thp2[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int row = lane + 32 * i;
    const bool in = row < smu;
    const T th = in ? th_prev[row / mu] : T(0);
    thp2[i] = th * th;
    r_acc[i] = in ? thp2[i] * y_proj[row] + z_proj[row] : T(0);
    zv[i] = in ? z_vals[row] : T(0);
  }
  staged_barrier();
  // The first row with each row's id (a row past s mu: none).
  int first[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i)
    first[i] = lane + 32 * i < smu ? s_coll[lane + 32 * i] & 0xffff : smu;

  // This step's and (during the update) the next step's constants.
  T eta = s_eta[0], cu = s_coefU[0];
  T rden = T(1) / (T(1) + T(2) * eta * lam2);
  for (int j = 0; j < s; ++j) {
    const int row0 = j * mu;
    // This lane's row of block j, if p < mu (mu <= 32: at most one). At
    // mu = 1 row j is slot j / 32 of every lane (the owner: lane j % 32).
    const int p = (lane - row0) & 31;
    const bool own = p < mu;
    const int slot = mu == 1 ? j >> 5 : (row0 + p) >> 5;
    T r = T(0), z = T(0);
    int k = smu;
#pragma unroll
    for (int i = 0; i < RPL; ++i)
      if (i == slot) {
        r = r_acc[i];
        z = zv[i];
        k = first[i];
      }
    // The collisions: the dz of each earlier row with this id, in row
    // order. Mostly none (k is the row itself, not below row0): then the
    // warp takes no branch.
    if (__any_sync(0xffffffffu, own && k < row0)) {
      __syncwarp();   // the earlier steps' s_dz, written by other lanes
      while (own && k < row0) {
        z += s_dz[k];
        k = s_coll[k] >> 16;
      }
    }
    const T g = z - eta * r;
    const T mag = max(fabs(g) - lam1 * eta, T(0));
    const T shrunk = g > T(0) ? mag : (g < T(0) ? -mag : T(0));
    const T d = own ? shrunk * rden - z : T(0);
    // Neither store holds the chain: nothing waits on a store.
    if (own) {
      dz_out[row0 + p] = d;
      s_dz[row0 + p] = d;
    }
    T coef[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i) coef[i] = thp2[i] * cu - T(1);
    const int jn = j + 1 < s ? j + 1 : j;
    const T eta_n = s_eta[jn], cu_n = s_coefU[jn];
    T rden_n = T(1) / (T(1) + T(2) * eta_n * lam2);
    settle(rden_n);   // here, beside the update, not at the next prox
    // Unrolled, so the shuffles and shared loads of a few columns issue
    // together; the sums into each row still run in column order. No
    // branch: every slot is updated (rows already done, or past s mu,
    // are never read again). A row past s mu reads past its column, but
    // inside the layout (tests/test_torch_inner_plan.py); at RPL = 1
    // (s mu < 8 would not fit) it reads row s mu - 1.
#pragma unroll kUnroll
    for (int pq = 0; pq < mu; ++pq) {
      const int col = row0 + pq;
      const T dq = __shfl_sync(0xffffffffu, d, col & 31);
      const T* gcol = s_GT + col * pitch;
#pragma unroll
      for (int i = 0; i < RPL; ++i)
        r_acc[i] -= gcol[RPL == 1 ? min(lane, smu - 1) : lane + 32 * i] *
                    (coef[i] * dq);
    }
    eta = eta_n;
    cu = cu_n;
    rden = rden_n;
  }
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
cudaError_t launch_block(const T* G, const T* yp, const T* zp, const T* zv,
                         const int64_t* idx, const T* th, const T* cu, T* dz,
                         T* eta, int s, int mu, T q, T lam1, T lam2,
                         int iters, int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const size_t bytes = smem_bytes(s, mu, sizeof(T), G_SMEM);
  if (bytes > (size_t)kSmemPerBlock) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(sa_inner_kernel<T, G_SMEM>, bytes, device,
                               done);
  if (err != cudaSuccess) return err;
  sa_inner_kernel<T, G_SMEM><<<1, kThreads, bytes, stream>>>(
      G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q, lam1, lam2, iters);
  return cudaGetLastError();
}

template <typename T, int RPL>
cudaError_t launch_warp(const T* G, const T* yp, const T* zp, const T* zv,
                        const int64_t* idx, const T* th, const T* cu, T* dz,
                        T* eta, int s, int mu, T q, T lam1, T lam2,
                        int iters, int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const size_t bytes = warp_smem_bytes(s, mu, sizeof(T));
  cudaError_t err = allow_smem(sa_inner_warp_kernel<T, RPL>, bytes, device,
                               done);
  if (err != cudaSuccess) return err;
  sa_inner_warp_kernel<T, RPL><<<1, kThreads, bytes, stream>>>(
      G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q, lam1, lam2, iters);
  return cudaGetLastError();
}

template <typename T>
int sa_inner(const T* G, const T* yp, const T* zp, const T* zv,
             const int64_t* idx, const T* th, const T* cu, T* dz, T* eta,
             int s, int mu, T q, T lam1, T lam2, int iters, int body,
             int device, cudaStream_t stream) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (s < 1 || mu < 1) return cudaErrorInvalidValue;
  if (body == kBlockGlobal)
    return launch_block<T, false>(G, yp, zp, zv, idx, th, cu, dz, eta, s,
                                  mu, q, lam1, lam2, iters, device, stream);
  if (body == kBlockSmem)
    return launch_block<T, true>(G, yp, zp, zv, idx, th, cu, dz, eta, s,
                                 mu, q, lam1, lam2, iters, device, stream);
  if (body != kWarpBody || !warp_fits(s, mu, sizeof(T)))
    return cudaErrorInvalidValue;
  const int rows = (s * mu + 31) / 32;
  if (rows <= 1)
    return launch_warp<T, 1>(G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q,
                             lam1, lam2, iters, device, stream);
  if (rows <= 2)
    return launch_warp<T, 2>(G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q,
                             lam1, lam2, iters, device, stream);
  if (rows <= 4)
    return launch_warp<T, 4>(G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q,
                             lam1, lam2, iters, device, stream);
  return launch_warp<T, 8>(G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q,
                           lam1, lam2, iters, device, stream);
}

// Not a solver kernel: a latency probe for the bound of sa_inner and
// svm_inner, whose inner steps form one dependent chain. Each of `steps`
// rounds is what every inner step of both kernels' block bodies waits on
// at least once: a warp shuffle reduction, then one block barrier, in one
// block of the same 16 warps (the shared partials alternate between two
// buffers so one barrier a round suffices). chip_smoke.py times it at two
// step counts; their difference over the steps is one step's latency.
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

extern "C" long long sa_inner_warp_smem_bytes(int s, int mu, int itemsize) {
  return (long long)warp_smem_bytes(s, mu, itemsize);
}

extern "C" int sa_inner_warp_fits(int s, int mu, int itemsize) {
  return warp_fits(s, mu, itemsize);
}

// Warps of the warp body that run power iterations at (s, mu).
extern "C" int sa_inner_power_warps(int s, int mu) {
  return power_warps(s, mu);
}

// body: 0 the block body with G in global memory, 1 the block body with G
// in shared memory, 2 the warp body.
extern "C" int sa_inner_f32(const float* G, const float* yp, const float* zp,
                            const float* zv, const int64_t* idx,
                            const float* th, const float* cu, float* dz,
                            float* eta, int s, int mu, float q, float lam1,
                            float lam2, int iters, int body, int device,
                            void* stream) {
  return sa_inner<float>(G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q, lam1,
                         lam2, iters, body, device,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int sa_inner_f64(const double* G, const double* yp,
                            const double* zp, const double* zv,
                            const int64_t* idx, const double* th,
                            const double* cu, double* dz, double* eta, int s,
                            int mu, double q, double lam1, double lam2,
                            int iters, int body, int device, void* stream) {
  return sa_inner<double>(G, yp, zp, zv, idx, th, cu, dz, eta, s, mu, q, lam1,
                          lam2, iters, body, device,
                          static_cast<cudaStream_t>(stream));
}
