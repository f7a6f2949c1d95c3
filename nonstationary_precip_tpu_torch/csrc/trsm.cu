// K11: X = L^-1 B for a lower-triangular L (N x N) and B (N x K), by
// forward block substitution.  Hopper (sm_90a) port of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_trsm.py::blocked_trsm (body
// _trsm_kernel, pallas_call in _forward).  The wrapper, the plain PyTorch
// version and the design notes are in nonstationary_precip_tpu_torch/ops/trsm.py.
//
// The wrapper pads N to a multiple of kB = 128 (L with an identity block, B
// with zero rows) and K to a multiple of kCT = 16 (zero columns).  Two
// kernels on one stream:
//  1. tri_inv_kernel, one 128-thread block per diagonal block of L: the
//     block's inverse by forward substitution of the identity (the TPU
//     kernel's _tri_inv_block), thread c walking column c of the inverse
//     down the rows, the inverse in shared memory (64 KB);
//  2. trsm_kernel: the columns of B are independent, so one 256-thread
//     block owns a kCT-wide column tile of X and walks the block rows in
//     order, with no synchronisation between blocks:
//       rhs = B_i - L[i, :i] X[:i],  X_i = inv(L_ii) rhs.
//     Both products stage 32-deep k-slabs of their operands in shared
//     memory; each thread sums 8 rows of one column over k in ascending
//     order with f32 FMAs, in 128-deep partial sums added in order (fixed
//     order, no atomics, no tensor cores).
// A block row's X_i is read back by the same block for the later rows,
// after a barrier.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kB = 128;       // block rows (the TPU kernel's BLOCK)
constexpr int kCT = 16;       // columns of X a block owns
constexpr int kBK = 32;       // k-slab depth
constexpr int kKBlock = 128;  // k-depth of one partial sum
constexpr int kThreads = 256;
constexpr int kRowsPer = kB * kCT / kThreads;  // rows a thread sums (8)
constexpr int kRowStride = kThreads / kCT;     // 16

__global__ void __launch_bounds__(kB)
tri_inv_kernel(const float* __restrict__ L, int n, float* __restrict__ inv) {
  extern __shared__ float xs[];  // xs[q * kB + c] = inv(L_ii)[q, c]
  const int c = threadIdx.x;
  const size_t i0 = static_cast<size_t>(blockIdx.x) * kB;
  const float* lt = L + i0 * n + i0;
  for (int j = 0; j < kB; ++j) {
    const float* lrow = lt + static_cast<size_t>(j) * n;
    float s = j == c ? 1.0f : 0.0f;
    for (int q = c; q < j; ++q) s = fmaf(-lrow[q], xs[q * kB + c], s);
    xs[j * kB + c] = j < c ? 0.0f : s / lrow[j];
  }
  __syncthreads();
  float* out = inv + static_cast<size_t>(blockIdx.x) * kB * kB;
  for (int e = c; e < kB * kB; e += kB) out[e] = xs[e];
}

// acc[a] = sum_{k < K} A[ty + kRowStride a, k] * Bm[k, tx] for the kB x kCT
// tile, A with row stride lda, Bm with row stride ldb (global or shared
// memory), K a multiple of kBK, the operands staged through as / bs.  Summed
// in two levels, as K5's GEMM sums: a serial FMA chain over each kKBlock-deep
// block of k, the blocks' partial sums added in order, so the rounding error
// grows with kKBlock + K / kKBlock rather than with K.
__device__ __forceinline__ void tile_product(const float* A, int lda, const float* Bm, int ldb,
                                             int K, float* acc, float (*as)[kBK + 1],
                                             float (*bs)[kCT]) {
  const int tid = threadIdx.x;
  const int tx = tid % kCT;
  const int ty = tid / kCT;
  float part[kRowsPer];
#pragma unroll
  for (int a = 0; a < kRowsPer; ++a) acc[a] = part[a] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kB * kBK; e += kThreads) {
      const int r = e / kBK;
      const int kk = e % kBK;
      as[r][kk] = A[static_cast<size_t>(r) * lda + k0 + kk];
    }
    for (int e = tid; e < kBK * kCT; e += kThreads) {
      const int kk = e / kCT;
      const int c = e % kCT;
      bs[kk][c] = Bm[static_cast<size_t>(k0 + kk) * ldb + c];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float bv = bs[kk][tx];
#pragma unroll
      for (int a = 0; a < kRowsPer; ++a) part[a] = fmaf(as[ty + kRowStride * a][kk], bv, part[a]);
    }
    if ((k0 + kBK) % kKBlock == 0 || k0 + kBK == K) {
#pragma unroll
      for (int a = 0; a < kRowsPer; ++a) {
        acc[a] += part[a];
        part[a] = 0.0f;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
trsm_kernel(const float* __restrict__ L, const float* __restrict__ inv,
            const float* __restrict__ B, float* X, int n, int k) {
  __shared__ float as[kB][kBK + 1];
  __shared__ float bs[kBK][kCT];
  __shared__ float rhs[kB][kCT];
  const int tid = threadIdx.x;
  const int tx = tid % kCT;
  const int ty = tid / kCT;
  const int c0 = blockIdx.x * kCT;
  for (int i0 = 0; i0 < n; i0 += kB) {
    float acc[kRowsPer];
    tile_product(L + static_cast<size_t>(i0) * n, n, X + c0, k, i0, acc, as, bs);
#pragma unroll
    for (int a = 0; a < kRowsPer; ++a) {
      const int r = ty + kRowStride * a;
      rhs[r][tx] = B[static_cast<size_t>(i0 + r) * k + c0 + tx] - acc[a];
    }
    __syncthreads();
    tile_product(inv + static_cast<size_t>(i0 / kB) * kB * kB, kB, &rhs[0][0], kCT, kB, acc, as, bs);
#pragma unroll
    for (int a = 0; a < kRowsPer; ++a) {
      X[static_cast<size_t>(i0 + ty + kRowStride * a) * k + c0 + tx] = acc[a];
    }
    __syncthreads();  // X_i is read by this block's later rows
  }
}

}  // namespace

extern "C" {

// l: n x n lower triangular, b and x: n x k, inv: n x 128 f32 scratch (the
// n / 128 inverted diagonal blocks), all row-major on the device; n a positive multiple of 128, k of
// 16.  Two launches on `stream`; returns the first non-zero
// cudaGetLastError() as an int (0 = all launched).
int trsm(const void* l, const void* b, void* x, void* inv, int n, int k, void* stream) {
  if (n < kB || n % kB != 0 || k < kCT || k % kCT != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int smem = kB * kB * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(tri_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* L = static_cast<const float*>(l);
  auto* I = static_cast<float*>(inv);
  tri_inv_kernel<<<n / kB, kB, smem, s>>>(L, n, I);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  trsm_kernel<<<k / kCT, kThreads, 0, s>>>(L, I, static_cast<const float*>(b), static_cast<float*>(x), n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
