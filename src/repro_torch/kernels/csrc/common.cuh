// Device helpers shared by the hand-written kernels.
//
// power_iter_max_eig_warp replaces the TPU package's in-kernel helper
// src/repro/kernels/common.py:8 power_iter_max_eig (K0): fixed-count
// power iteration on a (mu, mu) PSD block in row-vector form, then a
// Rayleigh quotient. On the TPU it ran as (1, mu) x (mu, mu) MXU products;
// here one warp owns one block: lanes stride over the mu columns, the
// iterate lives in a small per-warp shared buffer, and the norm is a warp
// shuffle reduction, so no block-wide barrier sits on its chain.
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

// Every library exports this, so a wrapper can name the error an entry
// point returned.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
