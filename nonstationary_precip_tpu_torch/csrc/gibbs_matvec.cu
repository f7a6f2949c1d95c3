// Gibbs Gram-times-V (K2), the fused backward panel sweep of the
// matrix-free MLL (K3) and the SE-ARD (RBF) Gram-times-V (K6), with the
// Gram never in memory.  Hopper (sm_90a) ports of the TPU kernels
//   K2 nonstationary_precip_tpu/ops/pallas_matvec.py::make_gibbs_matvec
//   K3 nonstationary_precip_tpu/ops/pallas_matvec.py::packed_gibbs_panel_grads
//      (and packed_gibbs_panel_grads_rows)
//   K6 nonstationary_precip_tpu/ops/pallas_matvec.py::make_rbf_matvec.
// The wrappers, the plain PyTorch versions and the design notes are in
// nonstationary_precip_tpu_torch/ops/matvec.py.
//
// Both kernels walk the (rows x columns) Gram in the same way.  A block of
// kRows threads owns kRows consecutive rows, one row per thread, with the
// row's payload (x_i, l_i) and its accumulators in registers.  The column
// range is cut into `splits` slices (gridDim.y); a block walks its slice
// kCols columns at a time, staging the columns' payload (and V's rows, or
// K3's column factors) in shared memory, where every thread of the block
// reads the same address (a broadcast).  Each Gram element is built from
// the plain formula and used at once:
//   K(i,j) = prod_k sqrt(2 l_ik l_jk / ss_k) * exp(-sum_k (x_ik - x_jk)^2 / ss_k),
//   ss_k = l_ik^2 + l_jk^2,
// or, for K6, from the payload z = x / ell that the wrapper prescales once
// (the TPU kernel's _pack_scaled):
//   K(i,j) = exp(-0.5 sum_k (z_ik - z_jk)^2),
// the quadratic formed from the differences (no cancellation, so no clamp).
// Each slice writes its partial row sums to a scratch buffer; a second
// kernel adds the slices in a fixed order.  No atomics: the result is the
// same bits on every run.  Plain f32 arithmetic, IEEE division and sqrtf /
// expf (no fast-math intrinsics, no tensor cores).

#include <cuda_runtime.h>

#include <cstddef>

#include "gibbs_elem.cuh"

namespace {

using gibbs::gibbs_elem;
using gibbs::kMaxD;
using gibbs::live;

constexpr int kRows = 128;   // threads per block; one row each
constexpr int kCols = 128;   // columns staged in shared memory per pass
constexpr int kGroup = 32;   // K2: right-hand sides one block contracts
constexpr int kMaxR = 128;   // K2: right-hand sides one launch takes

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// Row payload of row i into registers; an inactive row (i >= n) gets a
// harmless x = 0, l = 1.
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ x,
                                         const float* __restrict__ l, int i,
                                         bool active, int d, float* xi,
                                         float* li) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const bool ok = active && live<D>(k, d);
    xi[k] = ok ? x[static_cast<size_t>(i) * d + k] : 0.0f;
    li[k] = ok ? l[static_cast<size_t>(i) * d + k] : 1.0f;
  }
}

// K6's Gram element from the prescaled row payload zi in registers and the
// column payload zj in shared memory.
template <int D>
__device__ __forceinline__ float rbf_elem(const float* zi, const float* zj,
                                          int d) {
  float quad = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (live<D>(k, d)) {
      const float dk = zi[k] - zj[k];
      quad += dk * dk;
    }
  }
  return expf(-0.5f * quad);
}

// Columns [c0, c0 + jn) of (x, l) into cp[j] = [x_j0..x_j(D-1), l_j0..];
// with W = D (K6) only x is staged.
template <int D, int W>
__device__ __forceinline__ void stage_cols(float (*cp)[W],
                                           const float* __restrict__ x,
                                           const float* __restrict__ l, int c0,
                                           int jn, int d) {
  for (int e = threadIdx.x; e < jn * D; e += kRows) {
    const int j = e / D;
    const int k = e % D;
    const bool ok = live<D>(k, d);
    const size_t g = static_cast<size_t>(c0 + j) * d + k;
    cp[j][k] = ok ? x[g] : 0.0f;
    if constexpr (W == 2 * D) cp[j][D + k] = ok ? l[g] : 1.0f;
  }
}

// K2 (kRbf false) and K6 (kRbf true, x the prescaled z, l unread).
// part[s, i, g0 + r] = sum over slice s of K(i, j) v[j, g0 + r], for the
// rhs group g0 = kGroup * blockIdx.z, r < min(kGroup, rc - g0).
template <int D, int RB, bool kRbf>
__global__ void __launch_bounds__(kRows)
gibbs_matvec_kernel(const float* __restrict__ x1, const float* __restrict__ l1,
                    int n1, const float* __restrict__ x2,
                    const float* __restrict__ l2, int n2,
                    const float* __restrict__ v, int ldv, int rc, int d,
                    int cols_per_split, float* __restrict__ part) {
  constexpr int RP = pad4(RB);
  constexpr int W = kRbf ? D : 2 * D;
  __shared__ __align__(16) float cp[kCols][W];
  __shared__ __align__(16) float vs[kCols][RP];
  const int i = blockIdx.x * kRows + threadIdx.x;
  const int s = blockIdx.y;
  const int g0 = blockIdx.z * kGroup;
  const int gw = min(kGroup, rc - g0);  // <= RB by the host's choice of RB
  const bool active = i < n1;
  float xi[D], li[D];
  load_row<D>(x1, kRbf ? x1 : l1, i, active, d, xi, li);  // K6: li unused
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.0f;

  const int c_begin = s * cols_per_split;
  const int c_end = min(n2, c_begin + cols_per_split);
  for (int c0 = c_begin; c0 < c_end; c0 += kCols) {
    const int jn = min(kCols, c_end - c0);
    __syncthreads();  // the previous pass is done with cp / vs
    stage_cols<D, W>(cp, x2, l2, c0, jn, d);
    for (int e = threadIdx.x; e < jn * RP; e += kRows) {
      const int j = e / RP;
      const int r = e % RP;
      vs[j][r] = r < gw ? v[static_cast<size_t>(c0 + j) * ldv + g0 + r] : 0.0f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 2
      for (int j = 0; j < jn; ++j) {
        float kij;
        if constexpr (kRbf) {
          kij = rbf_elem<D>(xi, &cp[j][0], d);
        } else {
          float diff[D], inv_ss[D];
          kij = gibbs_elem<D>(xi, li, &cp[j][0], &cp[j][D], d, diff, inv_ss);
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r] = fmaf(kij, vs[j][r], acc[r]);
      }
    }
  }
  if (active) {
    float* out = part + (static_cast<size_t>(s) * n1 + i) * rc + g0;
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < gw) out[r] = acc[r];
  }
}

// K2, second pass: out[i, r] = sum_s part[s, i, r], s in order.
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits,
                                  int n1, int rc, float* __restrict__ out,
                                  int ldo) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t m = static_cast<size_t>(n1) * rc;
  if (e >= m) return;
  float t = part[e];
  for (int s = 1; s < splits; ++s) t += part[s * m + e];
  const size_t i = e / rc;
  out[i * ldo + e % rc] = t;
}

// K3.  For the rows (xr, lr, f1r) against the columns (xc, lc, f2c), with
// P(i,j) = W(i,j) K(i,j), W(i,j) = f1r[i] . f2c[j] (fw factors), writes
// part[s, i, :] = [sum P, sum P d_k/ss_k (k < d), sum P (2 d_k^2/ss_k - 1)/ss_k
// (k < d)] over slice s.
template <int D, int FB>
__global__ void __launch_bounds__(kRows)
gibbs_panel_grads_kernel(const float* __restrict__ xr,
                         const float* __restrict__ lr,
                         const float* __restrict__ f1r, int nr,
                         const float* __restrict__ xc,
                         const float* __restrict__ lc,
                         const float* __restrict__ f2c, int n, int d, int fw,
                         int cols_per_split, float* __restrict__ part) {
  constexpr int FP = pad4(FB);
  __shared__ __align__(16) float cp[kCols][2 * D];
  __shared__ __align__(16) float fs[kCols][FP];
  const int i = blockIdx.x * kRows + threadIdx.x;
  const int s = blockIdx.y;
  const bool active = i < nr;
  float xi[D], li[D], fi[FB];
  load_row<D>(xr, lr, i, active, d, xi, li);
#pragma unroll
  for (int f = 0; f < FB; ++f)
    fi[f] = active && f < fw ? f1r[static_cast<size_t>(i) * fw + f] : 0.0f;
  float sp = 0.0f;
  float gx[D], gt[D];
#pragma unroll
  for (int k = 0; k < D; ++k) gx[k] = gt[k] = 0.0f;

  const int c_begin = s * cols_per_split;
  const int c_end = min(n, c_begin + cols_per_split);
  for (int c0 = c_begin; c0 < c_end; c0 += kCols) {
    const int jn = min(kCols, c_end - c0);
    __syncthreads();
    stage_cols<D, 2 * D>(cp, xc, lc, c0, jn, d);
    for (int e = threadIdx.x; e < jn * FP; e += kRows) {
      const int j = e / FP;
      const int f = e % FP;
      fs[j][f] = f < fw ? f2c[static_cast<size_t>(c0 + j) * fw + f] : 0.0f;
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < jn; ++j) {
        float diff[D], inv_ss[D];
        const float kij =
            gibbs_elem<D>(xi, li, &cp[j][0], &cp[j][D], d, diff, inv_ss);
        float w = 0.0f;
#pragma unroll
        for (int f = 0; f < FB; ++f) w = fmaf(fi[f], fs[j][f], w);
        const float p = w * kij;
        sp += p;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (live<D>(k, d)) {
            gx[k] = fmaf(p, diff[k] * inv_ss[k], gx[k]);
            gt[k] = fmaf(
                p, inv_ss[k] * (2.0f * diff[k] * diff[k] * inv_ss[k] - 1.0f),
                gt[k]);
          }
        }
      }
    }
  }
  if (active) {
    float* out = part + (static_cast<size_t>(s) * nr + i) * (1 + 2 * d);
    out[0] = sp;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (live<D>(k, d)) {
        out[1 + k] = gx[k];
        out[1 + d + k] = gt[k];
      }
    }
  }
}

// K3, second pass: adds the slices in order and applies the per-row
// closed forms  gx_k = -2 sum P d_k/ss_k,
//               gl_k = sp / (2 l_ik) + l_ik sum P (2 d_k^2/ss_k - 1)/ss_k.
__global__ void panel_grads_finish_kernel(const float* __restrict__ part,
                                          int splits, int nr, int d,
                                          const float* __restrict__ lr,
                                          float* __restrict__ gx,
                                          float* __restrict__ gl,
                                          float* __restrict__ sp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nr) return;
  const int w = 1 + 2 * d;
  const size_t stride = static_cast<size_t>(nr) * w;
  const float* p = part + static_cast<size_t>(i) * w;
  float spi = p[0];
  for (int s = 1; s < splits; ++s) spi += p[s * stride];
  sp[i] = spi;
  for (int k = 0; k < d; ++k) {
    float a = p[1 + k];
    float t = p[1 + d + k];
    for (int s = 1; s < splits; ++s) {
      a += p[s * stride + 1 + k];
      t += p[s * stride + 1 + d + k];
    }
    const float l = lr[static_cast<size_t>(i) * d + k];
    gx[static_cast<size_t>(i) * d + k] = -2.0f * a;
    gl[static_cast<size_t>(i) * d + k] = spi / (2.0f * l) + l * t;
  }
}

struct MatvecArgs {
  const float *x1, *l1, *x2, *l2, *v;
  float *out, *part;
  int n1, n2, d, ldv, rc, ldo, splits, cols_per_split;
};

template <int D, int RB, bool kRbf>
void launch_matvec(const MatvecArgs& a, cudaStream_t s) {
  const dim3 grid((a.n1 + kRows - 1) / kRows, a.splits,
                  (a.rc + kGroup - 1) / kGroup);
  gibbs_matvec_kernel<D, RB, kRbf><<<grid, kRows, 0, s>>>(
      a.x1, a.l1, a.n1, a.x2, a.l2, a.n2, a.v, a.ldv, a.rc, a.d,
      a.cols_per_split, a.part);
}

// Accumulators per thread: the smallest bucket that holds one rhs group
// (mBCG's 1 + 8 probes take 9 exactly).
template <int D, bool kRbf>
void matvec_rb(const MatvecArgs& a, cudaStream_t s) {
  const int w = a.rc < kGroup ? a.rc : kGroup;
  if (w <= 1) launch_matvec<D, 1, kRbf>(a, s);
  else if (w <= 4) launch_matvec<D, 4, kRbf>(a, s);
  else if (w <= 9) launch_matvec<D, 9, kRbf>(a, s);
  else if (w <= 16) launch_matvec<D, 16, kRbf>(a, s);
  else launch_matvec<D, kGroup, kRbf>(a, s);
}

// The launches of K2 (kRbf false) or K6: the kernel, then the fixed-order
// sum of the column slices.
template <bool kRbf>
int run_matvec(const MatvecArgs& a, cudaStream_t s) {
  switch (a.d) {
    case 1: matvec_rb<1, kRbf>(a, s); break;
    case 2: matvec_rb<2, kRbf>(a, s); break;
    case 3: matvec_rb<3, kRbf>(a, s); break;
    default: matvec_rb<kMaxD, kRbf>(a, s); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t m = static_cast<size_t>(a.n1) * a.rc;
  sum_splits_kernel<<<static_cast<unsigned>((m + 255) / 256), 256, 0, s>>>(
      a.part, a.splits, a.n1, a.rc, a.out, a.ldo);
  return static_cast<int>(cudaGetLastError());
}

bool matvec_args_ok(int n1, int n2, int d, int ldv, int rc, int ldo,
                    int splits, int cols_per_split) {
  return n1 >= 1 && n2 >= 1 && d >= 1 && d <= kMaxD && rc >= 1 &&
         rc <= kMaxR && ldv >= rc && ldo >= rc && splits >= 1 &&
         cols_per_split >= 1 &&
         static_cast<long long>(splits) * cols_per_split >= n2;
}

struct GradsArgs {
  const float *xr, *lr, *f1r, *xc, *lc, *f2c;
  float *gx, *gl, *sp, *part;
  int nr, n, d, fw, splits, cols_per_split;
};

template <int D, int FB>
void launch_grads(const GradsArgs& a, cudaStream_t s) {
  const dim3 grid((a.nr + kRows - 1) / kRows, a.splits);
  gibbs_panel_grads_kernel<D, FB><<<grid, kRows, 0, s>>>(
      a.xr, a.lr, a.f1r, a.nr, a.xc, a.lc, a.f2c, a.n, a.d, a.fw,
      a.cols_per_split, a.part);
}

// Factors per row, 1 + 2R: the smallest bucket that holds them (the
// path's R = 8 probes take 17 exactly).
template <int D>
void grads_fb(const GradsArgs& a, cudaStream_t s) {
  if (a.fw <= 3) launch_grads<D, 3>(a, s);
  else if (a.fw <= 9) launch_grads<D, 9>(a, s);
  else if (a.fw <= 17) launch_grads<D, 17>(a, s);
  else if (a.fw <= 33) launch_grads<D, 33>(a, s);
  else launch_grads<D, 65>(a, s);
}

}  // namespace

extern "C" {

// K2.  x1, l1: (n1, d); x2, l2: (n2, d); v: rows of stride ldv, columns
// [0, rc); out: rows of stride ldo, columns [0, rc); part: splits*n1*rc
// scratch.  All f32, row-major.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
int gibbs_matvec(const void* x1, const void* l1, int n1, const void* x2,
                 const void* l2, int n2, int d, const void* v, int ldv,
                 int rc, void* out, int ldo, void* part, int splits,
                 int cols_per_split, void* stream) {
  if (!matvec_args_ok(n1, n2, d, ldv, rc, ldo, splits, cols_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const MatvecArgs a{static_cast<const float*>(x1), static_cast<const float*>(l1),
                     static_cast<const float*>(x2), static_cast<const float*>(l2),
                     static_cast<const float*>(v),  static_cast<float*>(out),
                     static_cast<float*>(part),     n1, n2, d, ldv, rc, ldo,
                     splits, cols_per_split};
  return run_matvec<false>(a, static_cast<cudaStream_t>(stream));
}

// K6.  z1: (n1, d) and z2: (n2, d), the prescaled x / ell; v, out and part
// as in gibbs_matvec.  Returns cudaGetLastError() as an int.
int rbf_matvec(const void* z1, int n1, const void* z2, int n2, int d,
               const void* v, int ldv, int rc, void* out, int ldo, void* part,
               int splits, int cols_per_split, void* stream) {
  if (!matvec_args_ok(n1, n2, d, ldv, rc, ldo, splits, cols_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* pz1 = static_cast<const float*>(z1);
  const float* pz2 = static_cast<const float*>(z2);
  const MatvecArgs a{pz1, pz1, pz2, pz2, static_cast<const float*>(v),
                     static_cast<float*>(out), static_cast<float*>(part),
                     n1, n2, d, ldv, rc, ldo, splits, cols_per_split};
  return run_matvec<true>(a, static_cast<cudaStream_t>(stream));
}

// K3.  Rows xr, lr: (nr, d), f1r: (nr, fw); columns xc, lc: (n, d),
// f2c: (n, fw); outputs gx, gl: (nr, d), sp: (nr,); part: splits*nr*(1+2d)
// scratch.  All f32, row-major.  Returns cudaGetLastError() as an int.
int gibbs_panel_grads(const void* xr, const void* lr, const void* f1r, int nr,
                      const void* xc, const void* lc, const void* f2c, int n,
                      int d, int fw, void* gx, void* gl, void* sp, void* part,
                      int splits, int cols_per_split, void* stream) {
  if (nr < 1 || n < 1 || d < 1 || d > kMaxD || fw < 1 || fw > 65 ||
      splits < 1 || cols_per_split < 1 ||
      static_cast<long long>(splits) * cols_per_split < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const GradsArgs a{static_cast<const float*>(xr), static_cast<const float*>(lr),
                    static_cast<const float*>(f1r), static_cast<const float*>(xc),
                    static_cast<const float*>(lc), static_cast<const float*>(f2c),
                    static_cast<float*>(gx), static_cast<float*>(gl),
                    static_cast<float*>(sp), static_cast<float*>(part),
                    nr, n, d, fw, splits, cols_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: grads_fb<1>(a, s); break;
    case 2: grads_fb<2>(a, s); break;
    case 3: grads_fb<3>(a, s); break;
    default: grads_fb<kMaxD>(a, s); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  panel_grads_finish_kernel<<<(nr + 127) / 128, 128, 0, s>>>(
      a.part, splits, nr, d, a.lr, a.gx, a.gl, a.sp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
