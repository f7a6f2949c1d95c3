// The fused (L, L^-1) column sweep that K10b (chol_inv_grid.cu) factors
// its members with: one thread block factors one SPD matrix and inverts its
// factor in the same pass.  K1 and K4 ran on it whole before they moved to
// the cluster schedule of chol_inv_cluster.cuh.
//
// The working set is one packed lower triangle W (row i at tri_off(i)) in
// which row i holds L^-1[i, 0..k] (the partial forward substitution of the
// identity) left of the trailing Schur complement S[i, k+1..i].  Step k:
//   1. d = S[k,k]; a pivot that is not > 0 (or not finite) fails the try;
//   2. u[j] = W[k,j]/L[k,k] for j < k (row k of L^-1, now final),
//      u[k] = 1/L[k,k], u[i] = S[i,k]/L[k,k] for i > k (column k of L),
//      and W[i,k] = 0 for i > k;
//   3. W[i,j] -= u[i] u[j] for all k < i, j <= i: the rank-1 Schur update
//      of S and the elimination step of L^-1 in one loop.
// Every entry of L and L^-1 (n x n, row-major, zero above the diagonal) is
// written exactly once by a sweep that runs to its end.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace chol_sweep {

__device__ __forceinline__ size_t tri_off(int i) {
  return static_cast<size_t>(i) * (i + 1) / 2;
}

// false for NaN and +-inf
__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) <= 3.402823466e+38f;
}

// One sweep over the triangle `w` (shared memory or global scratch) that
// the caller has filled and followed with a block barrier; `u` is n floats
// of shared memory and `bad` a shared flag the caller has set to 0 before
// that barrier.  Writes L and LI (n x n each).  Returns, uniformly across
// the block, whether every pivot was positive and every entry of L (and,
// with kCheckInverse, of L^-1) came out finite.  kThreads is the block
// size and kMaxN the largest n.
template <int kThreads, int kMaxN, bool kCheckInverse>
__device__ bool chol_inv_sweep(float* w, float* u, float* L, float* LI, int n,
                               int* bad) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kMaxM = (kMaxN + 31) / 32;  // u values one lane keeps in registers
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int k = 0; k < n; ++k) {
    // every thread reads the same pivot after the barrier: uniform branch
    const float d = w[tri_off(k) + k];
    if (!(d > 0.f) || !finite(d)) return false;
    const float lkk = sqrtf(d);
    float* rowk = w + tri_off(k);
    const size_t rk = static_cast<size_t>(k) * n;
    for (int t = tid; t < n; t += kThreads) {
      if (t < k) {
        const float x = rowk[t] / lkk;
        if (kCheckInverse && !finite(x)) *bad = 1;
        u[t] = x;
        LI[rk + t] = x;
      } else if (t == k) {
        const float r = 1.0f / lkk;
        u[k] = r;
        LI[rk + k] = r;
        L[rk + k] = lkk;
      } else {
        float* wt = w + tri_off(t) + k;
        const float c = *wt / lkk;
        if (!finite(c)) *bad = 1;
        u[t] = c;
        *wt = 0.f;
        L[static_cast<size_t>(t) * n + k] = c;
        L[rk + t] = 0.f;
        LI[rk + t] = 0.f;
      }
    }
    __syncthreads();

    float ur[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      const int j = lane + 32 * m;
      ur[m] = j < n ? u[j] : 0.f;
    }
    for (int i = k + 1 + warp; i < n; i += kWarps) {
      const float ci = u[i];
      float* row = w + tri_off(i);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (32 * m > i) break;
        const int j = lane + 32 * m;
        if (j <= i) row[j] = fmaf(-ci, ur[m], row[j]);
      }
    }
    __syncthreads();
  }
  // `bad` was last written before a barrier every thread has passed
  return *bad == 0;
}

// NaN into every entry of L and LI: the outcome of a member whose every
// try failed.
template <int kThreads>
__device__ void fill_nan(float* L, float* LI, size_t nn) {
  const float nan = __int_as_float(0x7fc00000);
  for (size_t e = threadIdx.x; e < nn; e += kThreads) {
    L[e] = nan;
    LI[e] = nan;
  }
}

}  // namespace chol_sweep
