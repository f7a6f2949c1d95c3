// The left-looking blocked Cholesky of K8 (gibbs_fused.cu, 128-wide panels),
// with the forward substitution of y riding the factorisation.
//
// The matrix is padded by the caller to n, a multiple of the panel width kP.
// For each block column j (jp = j kP), three kernels on one stream:
//  1. gemm_nt_kernel<true>: C = A[jp:, jp:jp+kP] - L[jp:, :jp] L[jp:jp+kP, :jp]^T
//     into the (n - jp) x kP scratch `cbuf`;
//  2. diag_kernel, one block: the lower triangle of C's top kP x kP tile into
//     shared memory, the fused (L, L^-1) sweep of chol_sweep.cuh, L_jj into L
//     and L_jj^-1 into a kP x kP scratch, then
//     alpha_j = L_jj^-1 (alpha_j - L[jp:jp+kP, :jp] alpha[:jp]);
//  3. gemm_nt_kernel<false>: L[jp+kP:, jp:jp+kP] = C_below (L_jj^-1)^T.
// The GEMM is a tiled SIMT kernel: 64 x 64 output tiles, 16-deep k-slabs of
// both operands staged in shared memory, each thread a 4 x 4 block of f32
// FMAs summed over k in ascending order, in 128-deep partial sums added in
// order (fixed order, no atomics, no tensor cores).  A diagonal tile whose
// sweep fails (a pivot that is not > 0, or a non-finite L_jj or L_jj^-1) is
// written as NaN, and the NaN reaches every later column through the
// updates.  The caller zero-fills L, so the upper triangle outside the
// diagonal tiles stays 0.  Every kernel first reads *skip and returns at
// once if it is not 0 (K8's jitter ladder).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "chol_sweep.cuh"

namespace blocked_chol {

using chol_sweep::tri_off;

constexpr int kBM = 64;          // GEMM output tile rows
constexpr int kBN = 64;          // GEMM output tile columns
constexpr int kBK = 16;          // k-slab depth
constexpr int kGemmThreads = 256;
constexpr int kTM = 4;           // outputs per thread, rows
constexpr int kTN = 4;           // outputs per thread, columns
constexpr int kKBlock = 128;     // k-depth of one partial sum
static_assert(kBM == kBN && kBM == 16 * kTM && kBN == 16 * kTN &&
                  kBM * kBK % kGemmThreads == 0 && kKBlock % kBK == 0,
              "the tile loaders and the 16 x 16 thread grid assume these shapes");

// C[i, c] = (kBase ? B[i, c] - S : S),  S = sum_k X[i, k] Y[c, k], for an
// M x Ncol output; X is M x K with row stride ldx, Y is Ncol x K with row
// stride ldy (both "k contiguous"), B and C row strides ldb and ldc.  M,
// Ncol and K are multiples of kBM, kBN and kKBlock (the caller pads).
// Thread (ty, tx) owns rows ty + 16 a and columns tx + 16 b, a, b < 4.  S is
// summed in two levels, a serial FMA chain over each kKBlock-deep block of
// k and the blocks' partial sums added in order, so its rounding error
// grows with kKBlock + K / kKBlock rather than with K (8192 at most).
template <bool kBase>
__global__ void __launch_bounds__(kGemmThreads)
gemm_nt_kernel(const float* __restrict__ X, int ldx, const float* __restrict__ Y,
               int ldy, const float* __restrict__ B, int ldb, float* __restrict__ C,
               int ldc, int K, const int* __restrict__ skip) {
  if (*skip != 0) return;
  __shared__ float xs[kBK][kBM + 1];  // xs[kk][r] = X[m0 + r, k0 + kk]
  __shared__ float ys[kBK][kBN + 1];  // ys[kk][c] = Y[n0 + c, k0 + kk]
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  float acc[kTM][kTN], part[kTM][kTN];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < kTN; ++b) acc[a][b] = part[a][b] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // 64 x 16 of each operand: 4 elements a thread, a warp reading two
    // 64-byte row segments per instruction
#pragma unroll
    for (int q = 0; q < kBM * kBK / kGemmThreads; ++q) {
      const int e = tid + q * kGemmThreads;
      const int r = e / kBK;
      const int kk = e % kBK;
      xs[kk][r] = X[static_cast<size_t>(m0 + r) * ldx + k0 + kk];
      ys[kk][r] = Y[static_cast<size_t>(n0 + r) * ldy + k0 + kk];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int a = 0; a < kTM; ++a) av[a] = xs[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < kTN; ++b) bv[b] = ys[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int b = 0; b < kTN; ++b) part[a][b] = fmaf(av[a], bv[b], part[a][b]);
    }
    if ((k0 + kBK) % kKBlock == 0) {
#pragma unroll
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int b = 0; b < kTN; ++b) {
          acc[a][b] += part[a][b];
          part[a][b] = 0.f;
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const size_t i = static_cast<size_t>(m0 + ty + 16 * a);
#pragma unroll
    for (int b = 0; b < kTN; ++b) {
      const int c = n0 + tx + 16 * b;
      C[i * ldc + c] = kBase ? B[i * ldb + c] - acc[a][b] : acc[a][b];
    }
  }
}

// Dynamic shared memory of diag_kernel<kP, ...>, in bytes: u (kP floats) and
// the packed kP-triangle.
template <int kP>
constexpr int diag_smem_bytes() {
  return static_cast<int>((kP + kP * (kP + 1) / 2) * sizeof(float));
}

// Factor the kP x kP tile at the top of `cbuf` (row stride kP; its lower
// triangle is read): L_jj into L at (jp, jp) (row stride n) and into `ljj`,
// L_jj^-1 into `linv` (both kP x kP scratch).  NaN tiles on failure.
// Rows jp..jp+kP of `alpha` (n floats, rows < jp final) become
// L_jj^-1 (alpha_j - L[jp:jp+kP, :jp] alpha[:jp]): one warp a row, each dot
// product summed by lanes in a fixed order.
template <int kP, int kThreads>
__global__ void __launch_bounds__(kThreads)
diag_kernel(const float* __restrict__ cbuf, float* __restrict__ L, int n, int jp,
            float* __restrict__ ljj, float* __restrict__ linv, float* __restrict__ alpha,
            const int* __restrict__ skip) {
  if (*skip != 0) return;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float smem[];
  __shared__ int bad;
  float* u = smem;
  float* w = smem + kP;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = warp; i < kP; i += kWarps) {
    float* row = w + tri_off(i);
    const float* crow = cbuf + static_cast<size_t>(i) * kP;
    for (int c = lane; c <= i; c += 32) row[c] = crow[c];
  }
  if (tid == 0) bad = 0;
  __syncthreads();
  const bool ok =
      chol_sweep::chol_inv_sweep<kThreads, kP, true>(w, u, ljj, linv, kP, &bad);
  if (!ok) chol_sweep::fill_nan<kThreads>(ljj, linv, static_cast<size_t>(kP) * kP);
  __syncthreads();  // the tile's global writes are visible to the whole block
  for (int e = tid; e < kP * kP; e += kThreads) {
    const int r = e / kP;
    const int c = e % kP;
    L[static_cast<size_t>(jp + r) * n + jp + c] = ljj[e];
  }
  // u is free after the sweep: rhs_r = alpha[jp + r] - L[jp + r, :jp] alpha[:jp]
  for (int r = warp; r < kP; r += kWarps) {
    const float* lrow = L + static_cast<size_t>(jp + r) * n;
    float s = 0.f;
    for (int c = lane; c < jp; c += 32) s = fmaf(lrow[c], alpha[c], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) u[r] = alpha[jp + r] - s;
  }
  __syncthreads();
  for (int r = warp; r < kP; r += kWarps) {
    const float* irow = linv + static_cast<size_t>(r) * kP;
    float s = 0.f;
    for (int c = lane; c <= r; c += 32) s = fmaf(irow[c], u[c], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) alpha[jp + r] = s;
  }
}

// The factorisation of the n x n matrix A (row stride n; its lower triangle
// is read) into L (zero-filled by the caller): every kernel on `s`.  Scratch:
// cbuf n x kP, ljj and linv kP x kP; alpha and skip as above.  Returns the first non-zero cudaGetLastError() as an int
// (0 = all launched).
template <int kP, int kThreads>
int left_looking(const float* A, float* L, float* Cb, float* Ljj, float* Li, int n,
                 cudaStream_t s, float* alpha, const int* skip) {
  static_assert(kP % kBN == 0 && kP % kKBlock == 0, "a panel is whole GEMM tiles and k-blocks");
  if (n < kP || n % kP != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = diag_smem_bytes<kP>();
  cudaError_t e = cudaFuncSetAttribute(
      diag_kernel<kP, kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int jp = 0; jp < n; jp += kP) {
    const int m = n - jp;  // rows of block column j
    const float* lrow = L + static_cast<size_t>(jp) * n;
    gemm_nt_kernel<true><<<dim3(kP / kBN, m / kBM), kGemmThreads, 0, s>>>(
        lrow, n, lrow, n, A + static_cast<size_t>(jp) * n + jp, n, Cb, kP, jp, skip);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    diag_kernel<kP, kThreads><<<1, kThreads, smem, s>>>(Cb, L, n, jp, Ljj, Li, alpha, skip);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    if (m > kP) {
      gemm_nt_kernel<false><<<dim3(kP / kBN, (m - kP) / kBM), kGemmThreads, 0, s>>>(
          Cb + static_cast<size_t>(kP) * kP, kP, Li, kP, nullptr, 0,
          L + static_cast<size_t>(jp + kP) * n + jp, n, kP, skip);
      if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    }
  }
  return 0;
}

}  // namespace blocked_chol
