// K4: the whitened-SVGP K_zz precompute of every output dim of every layer
// (and every split) in one call: K = s2 RBF(z / ell) + eps I, its factor L
// and L^-1 with K4's own jitter retry, and W = L^-T P.  Hopper (sm_90a)
// port of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_svgp.py::svgp_precompute_fused
// (body _svgp_kernel).  The wrapper, the plain PyTorch version and the
// design notes are in nonstationary_precip_tpu_torch/ops/svgp_precompute.py.
//
// Two kernels, launched back to back on one stream by one C call:
//  1. svgp_factor_kernel, one 1024-thread block per member: builds the
//     member's Gram straight into a packed lower triangle in shared memory
//     (z / ell and the squared norms staged beside it; the ragged M is the
//     triangle's own size, so nothing is padded), then runs the fused
//     (L, L^-1) sweep that K1 shares (chol_sweep.cuh).  A member whose L or
//     L^-1 is not finite is rebuilt with 1e-4 more on the diagonal, then a
//     further 1e-2, at most 3 tries, inside the block: healthy members run
//     once and keep their exact factors.  Every try that fails leaves NaN.
//  2. svgp_w_kernel: W = L^-T P as 32 x 32 output tiles, L^-1 and P staged
//     through shared memory 32 rows at a time, each output a sum over k in
//     ascending order (fixed, no atomics).  The retry of kernel 1 checks
//     L and L^-1: with a finite P, a finite L^-1 gives a finite W, and W's
//     identity block is L^-T itself, so this is the TPU kernel's "L and W
//     finite" test for the packed [m | tril(S) | I] the model passes.
// Plain f32 throughout: IEEE division, sqrtf and expf, explicit roundings
// in the Gram (no contraction into FMA), no tensor cores.

#include <cuda_runtime.h>

#include <cstddef>

#include "chol_sweep.cuh"

namespace {

using chol_sweep::tri_off;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 256;
constexpr int kMaxD = 8;
constexpr int kTries = 3;
constexpr int kTile = 32;      // W tile edge
constexpr int kRowsPerThread = 4;

__global__ void __launch_bounds__(kThreads)
svgp_factor_kernel(const float* __restrict__ z, const float* __restrict__ ell,
                   const float* __restrict__ s2, float* __restrict__ l,
                   float* __restrict__ li, float* __restrict__ jit_out, int m,
                   int d, float eps) {
  extern __shared__ float smem[];
  __shared__ int bad;
  float* u = smem;
  float* w = u + m;
  float* zs = w + tri_off(m);
  float* sq = zs + m * d;
  const int b = blockIdx.x;
  const size_t mm = static_cast<size_t>(m) * m;
  float* L = l + b * mm;
  float* LI = li + b * mm;
  const float* Z = z + static_cast<size_t>(b) * m * d;
  const float s2v = s2[b];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < m * d; e += kThreads) zs[e] = Z[e] / ell[b * d + e % d];
  __syncthreads();
  for (int i = tid; i < m; i += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < d; ++k)
      acc = __fadd_rn(acc, __fmul_rn(zs[i * d + k], zs[i * d + k]));
    sq[i] = acc;
  }
  __syncthreads();

  float jit = 0.f;
  bool ok = false;
  for (int attempt = 0; attempt < kTries; ++attempt) {
    // the diagonal accumulates the ladder in f32, as the TPU kernel's
    // jittered K does: ((s2 + eps) + 1e-4) + 1e-2
    float dg = s2v + eps;
    if (attempt >= 1) dg = dg + 1e-4f;
    if (attempt >= 2) dg = dg + 1e-2f;
    jit = attempt == 0 ? 0.f : (attempt == 1 ? 1e-4f : 1e-4f + 1e-2f);
    for (int i = warp; i < m; i += kWarps) {
      float* row = w + tri_off(i);
      const float* zi = zs + i * d;
      for (int j = lane; j <= i; j += 32) {
        if (j == i) {
          row[j] = dg;
        } else {
          const float* zj = zs + j * d;
          float cross = 0.f;
          for (int k = 0; k < d; ++k) cross = __fadd_rn(cross, __fmul_rn(zi[k], zj[k]));
          const float q = __fsub_rn(__fadd_rn(sq[i], sq[j]), __fmul_rn(2.0f, cross));
          row[j] = __fmul_rn(s2v, expf(__fmul_rn(-0.5f, fmaxf(q, 0.f))));
        }
      }
    }
    if (tid == 0) bad = 0;
    __syncthreads();
    if (chol_sweep::chol_inv_sweep<kThreads, kMaxM, true>(w, u, L, LI, m, &bad)) {
      ok = true;
      break;
    }
    __syncthreads();  // all threads have read `bad` before the next try resets it
  }

  if (!ok) chol_sweep::fill_nan<kThreads>(L, LI, mm);
  if (tid == 0) jit_out[b] = jit;
}

// W[i, c] = sum_{k >= i} L^-1[k, i] P[k, c] for one (32-row, 32-column)
// tile of one member; L^-1 is zero above its diagonal, so the k loop starts
// at the tile's first row.
__global__ void __launch_bounds__(kTile * kTile / kRowsPerThread)
svgp_w_kernel(const float* __restrict__ li, const float* __restrict__ packed,
              float* __restrict__ w, int m, int p) {
  __shared__ float a_tile[kTile][kTile];  // a_tile[kk][ii] = L^-1[k0 + kk, i0 + ii]
  __shared__ float b_tile[kTile][kTile];  // b_tile[kk][cc] = P[k0 + kk, c0 + cc]
  constexpr int kRowStep = kTile / kRowsPerThread;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * kTile;
  const size_t t = blockIdx.z;
  const float* LI = li + t * m * m;
  const float* P = packed + t * m * p;
  float* W = w + t * m * p;

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
  for (int k0 = i0; k0 < m; k0 += kTile) {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int kk = ty + kRowStep * r;
      const int k = k0 + kk;
      a_tile[kk][tx] = (k < m && i0 + tx < m) ? LI[static_cast<size_t>(k) * m + i0 + tx] : 0.f;
      b_tile[kk][tx] = (k < m && c0 + tx < p) ? P[static_cast<size_t>(k) * p + c0 + tx] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) {
      const float bv = b_tile[kk][tx];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        acc[r] = fmaf(a_tile[kk][ty + kRowStep * r], bv, acc[r]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = i0 + ty + kRowStep * r;
    const int c = c0 + tx;
    if (i < m && c < p) W[static_cast<size_t>(i) * p + c] = acc[r];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of svgp_factor_kernel at (m, d): the pivot
// vector, the packed triangle, z / ell and the squared norms.
long long svgp_factor_smem_bytes(int m, int d) {
  return static_cast<long long>(m + static_cast<long long>(m) * (m + 1) / 2 +
                                static_cast<long long>(m) * d + m) *
         static_cast<long long>(sizeof(float));
}

// z (t, m, d), ell (t, d), s2 (t,), packed (t, m, p) f32 row-major in;
// l, li (t, m, m), w (t, m, p), jit (t,) f32 out; eps is the base diagonal
// jitter (the wrapper passes EPSILON of utils/config.py).  Launches both
// kernels on `stream` and returns the first launch error as an int
// (0 = launched).
int svgp_precompute(const void* z, const void* ell, const void* s2,
                    const void* packed, void* l, void* w, void* li, void* jit,
                    int t, int m, int d, int p, float eps, void* stream) {
  if (t < 1 || t > 65535 || m < 1 || m > kMaxM || d < 1 || d > kMaxD || p < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(svgp_factor_smem_bytes(m, d));
  cudaError_t e = cudaFuncSetAttribute(
      svgp_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  svgp_factor_kernel<<<t, kThreads, bytes, s>>>(
      static_cast<const float*>(z), static_cast<const float*>(ell),
      static_cast<const float*>(s2), static_cast<float*>(l),
      static_cast<float*>(li), static_cast<float*>(jit), m, d, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p + kTile - 1) / kTile, (m + kTile - 1) / kTile, t);
  const dim3 block(kTile, kTile / kRowsPerThread);
  svgp_w_kernel<<<grid, block, 0, s>>>(static_cast<const float*>(li),
                                       static_cast<const float*>(packed),
                                       static_cast<float*>(w), m, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
