// K10c: the v1 streaming Cholesky of one N x N SPD matrix held in device
// memory, right-looking.  Hopper (sm_90a) port of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_chol.py::streaming_cholesky
// (_forward_streaming -> body _stream_kernel), which K5 (chol_stream.cu,
// left-looking) superseded on the TPU.  The wrapper, the plain PyTorch
// version and the design notes are in
// nonstationary_precip_tpu_torch/ops/chol_stream.py.
//
// The matrix is copied by the wrapper into a working matrix W, padded to n,
// a multiple of kP = 256, with an identity block.  One C call runs, for each
// block column j (jp = j kP), on one stream:
//  1. a strided copy of W[jp:, jp:jp+kP] (already carrying every earlier
//     column's update) into the (n - jp) x kP scratch `cbuf`;
//  2. blocked_chol.cuh's diag_kernel: the diagonal tile's fused (L, L^-1)
//     sweep in one 1024-thread block, L_jj into L (K5's kernel);
//  3. blocked_chol.cuh's gemm_nt_kernel: the panel L[jp+kP:, j] = C_below
//     (L_jj^-1)^T (K5's kernel);
//  4. syrk_lower_kernel: the trailing update W[jp+kP:, jp+kP:] -= P P^T with
//     P the new panel, one 256-thread block per 64 x 64 tile of the lower
//     triangle (the diagonal tiles whole), each thread a 4 x 4 block of f32
//     FMAs over 16-deep shared-memory k-slabs, k summed in ascending order in
//     128-deep partial sums added in order: no atomics, the same bits on
//     every run.
// A diagonal tile whose sweep fails is written as NaN, and the NaN reaches
// every later column through the trailing updates.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "blocked_chol.cuh"

namespace {

using blocked_chol::kBK;
using blocked_chol::kBM;
using blocked_chol::kBN;
using blocked_chol::kGemmThreads;
using blocked_chol::kKBlock;
using blocked_chol::kTM;
using blocked_chol::kTN;

constexpr int kP = 256;          // panel width (the TPU kernel's SPANEL)
constexpr int kDiagThreads = 1024;

// W[i, c] -= sum_k P[i, k] P[c, k], k < kP, for the 64 x 64 tile (ti, tj),
// tj <= ti, of the lower triangle that blockIdx.x numbers row by row.  P
// and W have row stride ld and point at the trailing block's corner.
__global__ void __launch_bounds__(kGemmThreads)
syrk_lower_kernel(const float* __restrict__ P, float* W, int ld) {
  __shared__ float xs[kBK][kBM + 1];  // xs[kk][r] = P[m0 + r, k0 + kk]
  __shared__ float ys[kBK][kBN + 1];  // ys[kk][c] = P[n0 + c, k0 + kk]
  const int t = blockIdx.x;
  int ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int m0 = ti * kBM;
  const int n0 = tj * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[kTM][kTN], part[kTM][kTN];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < kTN; ++b) acc[a][b] = part[a][b] = 0.f;

  for (int k0 = 0; k0 < kP; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < kBM * kBK / kGemmThreads; ++q) {
      const int e = tid + q * kGemmThreads;
      const int r = e / kBK;
      const int kk = e % kBK;
      xs[kk][r] = P[static_cast<size_t>(m0 + r) * ld + k0 + kk];
      ys[kk][r] = P[static_cast<size_t>(n0 + r) * ld + k0 + kk];
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
    for (int b = 0; b < kTN; ++b) W[i * ld + n0 + tx + 16 * b] -= acc[a][b];
  }
}

}  // namespace

extern "C" {

// w: the n x n working matrix (a copy of A, row-major, n a positive multiple
// of kP; its lower triangle is read and overwritten); l: n x n output,
// zero-filled by the caller; cbuf: n x kP, ljj and linv: kP x kP f32 scratch.
// Launches every kernel on `stream` and returns the first non-zero
// cudaGetLastError() as an int (0 = all launched).
int chol_stream_v1(void* w, void* l, void* cbuf, void* ljj, void* linv, int n, void* stream) {
  static_assert(kP % kBM == 0 && kP % kKBlock == 0, "a panel is whole tiles and k-blocks");
  if (n < kP || n % kP != 0) return static_cast<int>(cudaErrorInvalidValue);
  float* W = static_cast<float*>(w);
  float* L = static_cast<float*>(l);
  float* Cb = static_cast<float*>(cbuf);
  float* Ljj = static_cast<float*>(ljj);
  float* Li = static_cast<float*>(linv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = blocked_chol::diag_smem_bytes<kP>();
  cudaError_t e = cudaFuncSetAttribute(blocked_chol::diag_kernel<kP, kDiagThreads, false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int jp = 0; jp < n; jp += kP) {
    const int m = n - jp;  // rows of block column j
    e = cudaMemcpy2DAsync(Cb, kP * sizeof(float), W + static_cast<size_t>(jp) * n + jp,
                          static_cast<size_t>(n) * sizeof(float), kP * sizeof(float), m,
                          cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocked_chol::diag_kernel<kP, kDiagThreads, false><<<1, kDiagThreads, smem, s>>>(
        Cb, L, n, jp, Ljj, Li, nullptr, nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    if (m == kP) break;
    float* panel = L + static_cast<size_t>(jp + kP) * n + jp;
    blocked_chol::gemm_nt_kernel<false, false><<<dim3(kP / kBN, (m - kP) / kBM), kGemmThreads, 0, s>>>(
        Cb + static_cast<size_t>(kP) * kP, kP, Li, kP, nullptr, 0, panel, n, kP, nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    const int mt = (m - kP) / kBM;
    syrk_lower_kernel<<<mt * (mt + 1) / 2, kGemmThreads, 0, s>>>(
        panel, W + static_cast<size_t>(jp + kP) * n + jp + kP, n);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // extern "C"
