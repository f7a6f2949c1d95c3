// The diagonal-Gibbs covariance element
//   K(i,j) = prod_k sqrt(2 l_ik l_jk / ss_k) * exp(-sum_k (x_ik - x_jk)^2 / ss_k),
//   ss_k = l_ik^2 + l_jk^2,
// formed from the differences (no cancellation at large |x|), in two forms:
//  * gibbs_elem, the per-dim form in plain f32 with IEEE division, sqrtf and
//    expf, which K8 (gibbs_fused.cu) and K2/K3 at d != 2 (gibbs_matvec.cu)
//    compute.  It is symmetric in (i, j) to the bit: every operation on the
//    pair commutes;
//  * at d = 2, the JAX matvec kernel's rewrite (pallas_matvec.py:118-141)
//    from factors made once a row (d2_row) and once a column (d2_col_xq,
//    d2_col_n), which K2, K3 (gibbs_matvec.cu) and K9 (gibbs_gram.cu)
//    compute: one element is 15 f32 operations (an FMA as 2), one rsqrt and
//    one ex2 on the special-function unit (d2_elem).

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

// ---- the d = 2 element ----

// ln 2 and 2 ln 2: the d = 2 element scales its squared lengthscales by
// ln 2 so that exp(-y) becomes 2^-(y / ln 2) with no multiply an element
constexpr float kLn2 = 0.693147180559945309f;
constexpr float kTwoLn2 = 1.386294361119890618f;

// The special-function unit's approximations, one MUFU operation each
// (PTX ISA: rsqrt.approx.f32 and ex2.approx.f32, relative error about
// 2^-22 to 2^-23; .ftz flushes subnormal inputs and results to zero, so an
// element below 2^-126 of its prefactor becomes 0).
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The rewrite with its squared lengthscales prescaled by ln 2: from the row
// factors (x_i, a_i = l_i^2, n_i = 2 ln 2 sqrt(l_i0 l_i1)) and the column
// factors (x_j, q_j = l_j^2 ln 2, n_j = sqrt(l_j0 l_j1)),
//   s_k = fma(a_ik, ln 2, q_jk) = ss_k ln 2,  rs = rsqrt(s_0 s_1) = rsqrt(p) / ln 2,
//   y = (d_0^2 s_1 + d_1^2 s_0) rs^2 = quadnum / p / ln 2,
//   K = (n_i n_j) rs 2^-y = 2 sqrt(l_i0 l_i1 l_j0 l_j1) rsqrt(p) exp(-quadnum / p),
// with p = ss_0 ss_1 and quadnum = d_0^2 ss_1 + d_1^2 ss_0.  The row's
// l_i^2 ln 2 enters s_k through one fused multiply-add, as ptxas contracts it
// where the row factors live in registers (K2's and K3's walk): spelt out,
// every kernel that computes the element gets the same bits.  A column with
// n_j = 0 gives 0.
struct D2Row {
  float x0, x1, a0, a1, n;
};
__device__ __forceinline__ D2Row d2_row(const float* xi, const float* li) {
  return {xi[0], xi[1], li[0] * li[0], li[1] * li[1], sqrtf(li[0] * li[1]) * kTwoLn2};
}
// s_k of the element: the row's l_ik^2 ln 2 plus the column's q_jk.
__device__ __forceinline__ float d2_s(float a, float q) { return fmaf(a, kLn2, q); }
// A column's (x_j, q_j), one float4, and n_j.
__device__ __forceinline__ float4 d2_col_xq(float x0, float x1, float l0, float l1) {
  return make_float4(x0, x1, (l0 * l0) * kLn2, (l1 * l1) * kLn2);
}
__device__ __forceinline__ float d2_col_n(float l0, float l1) { return sqrtf(l0 * l1); }
__device__ __forceinline__ float d2_elem(const D2Row& r, const float4& xq, float n) {
  const float s0 = d2_s(r.a0, xq.z);
  const float s1 = d2_s(r.a1, xq.w);
  const float rs = rsqrt_approx(s0 * s1);
  const float d0 = r.x0 - xq.x;
  const float d1 = r.x1 - xq.y;
  const float y = fmaf(d1 * d1, s0, (d0 * d0) * s1) * (rs * rs);
  return ((r.n * n) * rs) * exp2_approx(-y);
}

}  // namespace gibbs
