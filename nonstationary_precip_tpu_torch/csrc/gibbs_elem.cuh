// The diagonal-Gibbs covariance element that K2/K3 (gibbs_matvec.cu), K9
// (gibbs_gram.cu) and K8 (gibbs_fused.cu) share:
//   K(i,j) = prod_k sqrt(2 l_ik l_jk / ss_k) * exp(-sum_k (x_ik - x_jk)^2 / ss_k),
//   ss_k = l_ik^2 + l_jk^2,
// formed from the differences (no cancellation at large |x|), in plain f32
// with IEEE division, sqrtf and expf.  The element is symmetric in (i, j) to
// the bit: every operation on the pair commutes.

#pragma once

#include <cuda_runtime.h>

namespace gibbs {

constexpr int kMaxD = 8;  // input dims (the generic template runs d <= 8)

// Whether dim k is live: always for an exact-D instantiation, k < d for the
// generic one (D == kMaxD).
template <int D>
__device__ __forceinline__ bool live(int k, int d) {
  return D != kMaxD || k < d;
}

// One element K(i, j) from the payloads (xi, li) and (xj, lj).  Also leaves
// the per-dim difference x_ik - x_jk and 1/ss_k in diff / inv_ss for K3's
// pullbacks (dead stores elsewhere).
template <int D>
__device__ __forceinline__ float gibbs_elem(const float* xi, const float* li,
                                            const float* xj, const float* lj,
                                            int d, float* diff, float* inv_ss) {
  float pref = 1.0f;
  float quad = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (live<D>(k, d)) {
      const float ss = li[k] * li[k] + lj[k] * lj[k];
      const float inv = 1.0f / ss;
      const float dk = xi[k] - xj[k];
      pref *= sqrtf(2.0f * (li[k] * lj[k]) * inv);
      quad += dk * dk * inv;
      diff[k] = dk;
      inv_ss[k] = inv;
    }
  }
  return pref * expf(-quad);
}

}  // namespace gibbs
