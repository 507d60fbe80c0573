// Device helpers shared by the hand-written kernels.
//
// power_iter_max_eig_warp replaces the TPU package's in-kernel helper
// src/repro/kernels/common.py:8 power_iter_max_eig (K0): fixed-count
// power iteration on a (mu, mu) PSD block in row-vector form, then a
// Rayleigh quotient. On the TPU it ran as (1, mu) x (mu, mu) MXU products;
// here one warp owns one block: lanes stride over the mu columns, the
// iterate lives in a small per-warp shared buffer, and the norm is a warp
// shuffle reduction, so no block-wide barrier sits on its chain.
// power_iter_max_eig_group is the same function with the block in
// registers, 32 / P blocks a warp (K2's warp body).
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

template <typename T> __device__ __forceinline__ T tiny_of();
template <> __device__ __forceinline__ float tiny_of<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny_of<double>() { return DBL_MIN; }

// Sum over the 32 lanes of a warp; every lane gets the total.
template <typename T>
__device__ __forceinline__ T warp_allreduce_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Largest eigenvalue of the (mu, mu) block at Gjj (row stride ld) by
// `iters` rounds of v <- vG / max(||vG||, 1e-30) from v = 1/sqrt(mu),
// then (vG . v) / max(v . v, 1e-30). Called by all 32 lanes of one warp;
// `scratch` holds 2 * mu elements private to that warp.
template <typename T>
__device__ T power_iter_max_eig_warp(const T* Gjj, int ld, int mu, int iters,
                                     T* scratch, int lane) {
  T* v = scratch;
  T* w = scratch + mu;
  const T v0 = T(1) / sqrt(T(mu));
  for (int c = lane; c < mu; c += 32) v[c] = v0;
  __syncwarp();
  for (int it = 0; it < iters; ++it) {
    T nrm2 = T(0);
    for (int c = lane; c < mu; c += 32) {
      T acc = T(0);
      for (int r = 0; r < mu; ++r) acc += v[r] * Gjj[(size_t)r * ld + c];
      w[c] = acc;
      nrm2 += acc * acc;
    }
    const T nrm = max(sqrt(warp_allreduce_sum(nrm2)), T(1e-30));
    __syncwarp();
    for (int c = lane; c < mu; c += 32) v[c] = w[c] / nrm;
    __syncwarp();
  }
  T num = T(0), den = T(0);
  for (int c = lane; c < mu; c += 32) {
    T acc = T(0);
    for (int r = 0; r < mu; ++r) acc += v[r] * Gjj[(size_t)r * ld + c];
    num += acc * v[c];
    den += v[c] * v[c];
  }
  num = warp_allreduce_sum(num);
  den = warp_allreduce_sum(den);
  __syncwarp();
  return num / max(den, T(1e-30));
}

// Sum over an aligned group of P lanes (P a power of two); every lane of
// the group gets the total.
template <typename T, int P>
__device__ __forceinline__ T group_allreduce_sum(T v) {
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, P);
  return v;
}

// power_iter_max_eig_warp with the block in registers: an aligned group
// of P lanes (P the least power of two >= mu, so a warp runs 32 / P
// blocks at once) owns one block, lane c of the group holding column c of
// it (rows 0..mu-1). No shared memory, no __syncwarp. The arithmetic is
// the warp helper's: (vG)_c summed over r = 0..mu-1, the same butterfly
// for the norm (lanes c >= mu hold zeros, so the 32-lane tree and the
// P-lane tree add the same terms), a division by the norm; so it returns
// the same bits. Each round broadcasts the iterate by shuffles within the
// group and reduces the norm by a shuffle butterfly within the group. The
// sums run over all P rows with no test of r < mu, so the shuffles issue
// back to back: rows r >= mu hold zeros and add exact zeros. Called by
// all 32 lanes of a warp; a lane with live = false (no block) reads
// nothing.
template <typename T, int P>
__device__ T power_iter_max_eig_group(const T* Gjj, int ld, int mu,
                                      int iters, int c, bool live) {
  T g[P];
#pragma unroll
  for (int r = 0; r < P; ++r)
    g[r] = (live && r < mu && c < mu) ? Gjj[(size_t)r * ld + c] : T(0);
  T v = c < mu ? T(1) / sqrt(T(mu)) : T(0);
  for (int it = 0; it < iters; ++it) {
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < P; ++r)
      acc += __shfl_sync(0xffffffffu, v, r, P) * g[r];
    const T nrm = max(sqrt(group_allreduce_sum<T, P>(acc * acc)),
                      T(1e-30));
    v = acc / nrm;
  }
  T acc = T(0);
#pragma unroll
  for (int r = 0; r < P; ++r)
    acc += __shfl_sync(0xffffffffu, v, r, P) * g[r];
  const T num = group_allreduce_sum<T, P>(acc * v);
  const T den = group_allreduce_sum<T, P>(v * v);
  return num / max(den, T(1e-30));
}

// Every library exports this, so a wrapper can name the error an entry
// point returned.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
