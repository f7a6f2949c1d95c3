// K10b: (L, L^-1) of each member of a stack of SPD matrices, one member a
// thread block, with no jitter retry.  Hopper (sm_90a) port of the TPU
// kernel nonstationary_precip_tpu/ops/pallas_chol.py::chol_inv_batched
// (_chol_inv_forward -> body _chol_inv_kernel).  The wrapper, the plain
// PyTorch version and the design notes are in
// nonstationary_precip_tpu_torch/ops/chol_inv.py.
//
// Each member is padded by the caller to n, a multiple of kP = 128, with an
// identity block.  A member stays in device memory (1 MB at n = 512, held in
// the 50 MB L2); one 1024-thread block runs a left-looking blocked
// factorisation over it, block column by block column (jp = j kP):
//   1. C = A[jp:, jp:jp+kP] - L[jp:, :jp] L[jp:jp+kP, :jp]^T into the
//      member's (n - jp) x kP scratch;
//   2. the diagonal tile's (L_jj, L_jj^-1) from chol_sweep.cuh's fused sweep
//      (K1's), its packed 128-triangle in shared memory (33 KB), written to
//      L's and L^-1's diagonal tiles;
//   3. the panel L[jp+kP:, jp:jp+kP] by forward substitution against L_jj
//      (x L_jj^T = C_below, one warp a row, L_jj packed in the same shared
//      memory), not by a product with L_jj^-1: on a near-singular member
//      the product carries L_jj^-1's condition into L (on the deep GP's
//      K_zz stack at init, an H100 run of the product form came out 0.103
//      of L's largest entry from float64, potrf 0.0027).
// Then the off-diagonal tiles of L^-1, block row by block row:
//   X_ij = -L_ii^-1 (L[ip:ip+kP, jp:ip] X[jp:ip, jp:jp+kP]),  j < i,
// whose right factor holds only rows above ip, all final by then.  The
// update and those products are in-block tiled GEMMs: 128 x 128 output
// tiles, each of the 1024 threads a 4 x 4 block of f32 FMAs, k in 16-deep
// shared-memory slabs summed in ascending order in 128-deep partial sums
// added in order (no atomics, the same bits on every run).  A diagonal tile
// whose sweep fails (a pivot that is not > 0, or a non-finite entry) is
// written as NaN and the NaN reaches every later column, so a member that is
// not PD comes out non-finite while the other members, other blocks, are
// untouched.

#include <cuda_runtime.h>

#include <cstddef>

#include "chol_sweep.cuh"

namespace {

using chol_sweep::tri_off;

constexpr int kP = 128;          // tile width
constexpr int kThreads = 1024;   // 32 x 32 threads, each 4 x 4 outputs of a 128 x 128 tile
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 16;          // k-slab depth
constexpr int kKBlock = 128;     // k-depth of one partial sum
constexpr int kMaxN = 512;       // the TPU kernel's MAX_N_CHOLINV
constexpr int kTriFloats = kP + kP * (kP + 1) / 2;  // u and the packed triangle
static_assert(2 * kBK * (kP + 1) <= kTriFloats, "the GEMM's slabs fit in the sweep's shared memory");

enum class Out { kStore, kSubtractFrom, kNegate };

// C[r, c] (r < M, c < kP) = S, B[r, c] - S or -S with S = sum_k X[r, k] Y(k, c),
// k < K; X row-major with row stride ldx; Y(k, c) = Y[c * ldy + k] when kNT,
// else Y[k * ldy + c].  M and K are multiples of kP and kKBlock (K may be
// 0).  `stage` is 2 kBK (kP + 1) floats of shared memory.  Every thread of
// the block calls it; it ends with a barrier.
template <bool kNT, Out kOut>
__device__ void tile_gemm(const float* X, int ldx, const float* Y, int ldy, const float* B,
                          int ldb, float* C, int ldc, int M, int K, float* stage) {
  float(*xs)[kP + 1] = reinterpret_cast<float(*)[kP + 1]>(stage);
  float(*ys)[kP + 1] = reinterpret_cast<float(*)[kP + 1]>(stage + kBK * (kP + 1));
  const int tid = threadIdx.x;
  const int tx = tid % 32;
  const int ty = tid / 32;
  for (int m0 = 0; m0 < M; m0 += kP) {
    float acc[4][4], part[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = part[a][b] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
      for (int q = 0; q < kP * kBK / kThreads; ++q) {
        const int e = tid + q * kThreads;
        const int r = e / kBK;
        const int kk = e % kBK;
        xs[kk][r] = X[static_cast<size_t>(m0 + r) * ldx + k0 + kk];
        if (kNT) {
          ys[kk][r] = Y[static_cast<size_t>(r) * ldy + k0 + kk];
        } else {
          const int kn = e / kP;
          const int c = e % kP;
          ys[kn][c] = Y[static_cast<size_t>(k0 + kn) * ldy + c];
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = xs[kk][ty + 32 * a];
#pragma unroll
        for (int b = 0; b < 4; ++b) bv[b] = ys[kk][tx + 32 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) part[a][b] = fmaf(av[a], bv[b], part[a][b]);
      }
      if ((k0 + kBK) % kKBlock == 0) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            acc[a][b] += part[a][b];
            part[a][b] = 0.f;
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const size_t i = static_cast<size_t>(m0 + ty + 32 * a);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = tx + 32 * b;
        const float s = acc[a][b];
        C[i * ldc + c] = kOut == Out::kStore ? s : kOut == Out::kNegate ? -s : B[i * ldb + c] - s;
      }
    }
  }
  __syncthreads();  // C is visible to the whole block; the slabs are free
}

// Rows r < rows of L_out (row stride n) solve x L_jj^T = C[r] (row stride
// kP), L_jj's lower triangle packed in shared memory (`w`, row i at
// tri_off(i)): one warp a row, the row's x in registers (x[c] in lane c % 32,
// slot c / 32), each dot product summed by a shuffle tree in a fixed order.
// Every thread of the block calls it.
__device__ void panel_solve(const float* C, const float* w, float* L_out, int n, int rows) {
  constexpr int kSlots = kP / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    const float* crow = C + static_cast<size_t>(r) * kP;
    float x[kSlots];
#pragma unroll
    for (int m = 0; m < kSlots; ++m) x[m] = 0.f;
    for (int c = 0; c < kP; ++c) {
      const float* lrow = w + tri_off(c);
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int k = lane + 32 * m;
        if (k < c) s = fmaf(x[m], lrow[k], s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const float xc = (crow[c] - s) / lrow[c];
#pragma unroll
      for (int m = 0; m < kSlots; ++m)
        if (c == lane + 32 * m) x[m] = xc;
    }
#pragma unroll
    for (int m = 0; m < kSlots; ++m) L_out[static_cast<size_t>(r) * n + lane + 32 * m] = x[m];
  }
}

// a, l, li: the stack, n x n a member, row-major; l and li zero-filled by the
// caller.  scratch: (n + 2 kP) x kP floats a member.
__global__ void __launch_bounds__(kThreads)
chol_inv_grid_kernel(const float* __restrict__ a, float* __restrict__ l,
                     float* __restrict__ li, float* __restrict__ scratch, int n) {
  __shared__ float smem[kTriFloats];
  __shared__ int bad;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* A = a + blockIdx.x * nn;
  float* L = l + blockIdx.x * nn;
  float* LI = li + blockIdx.x * nn;
  float* cbuf = scratch + blockIdx.x * static_cast<size_t>(n + 2 * kP) * kP;
  float* ljj = cbuf + static_cast<size_t>(n) * kP;
  float* linv = ljj + kP * kP;
  float* u = smem;
  float* w = smem + kP;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int jp = 0; jp < n; jp += kP) {
    const int m = n - jp;
    const float* lrow = L + static_cast<size_t>(jp) * n;
    tile_gemm<true, Out::kSubtractFrom>(lrow, n, lrow, n, A + static_cast<size_t>(jp) * n + jp, n,
                                        cbuf, kP, m, jp, smem);
    for (int i = warp; i < kP; i += kWarps) {
      float* row = w + tri_off(i);
      const float* crow = cbuf + static_cast<size_t>(i) * kP;
      for (int c = lane; c <= i; c += 32) row[c] = crow[c];
    }
    if (tid == 0) bad = 0;
    __syncthreads();
    const bool ok = chol_sweep::chol_inv_sweep<kThreads, kP, true>(w, u, ljj, linv, kP, &bad);
    if (!ok) chol_sweep::fill_nan<kThreads>(ljj, linv, static_cast<size_t>(kP) * kP);
    __syncthreads();  // the tile's global writes are visible to the whole block
    for (int e = tid; e < kP * kP; e += kThreads) {
      const int r = e / kP;
      const int c = e % kP;
      const size_t off = static_cast<size_t>(jp + r) * n + jp + c;
      L[off] = ljj[e];
      LI[off] = linv[e];
      if (c <= r) w[tri_off(r) + c] = ljj[e];  // the sweep's triangle is free: L_jj for the panel
    }
    __syncthreads();
    if (m > kP) panel_solve(cbuf + kP * kP, w, L + static_cast<size_t>(jp + kP) * n + jp, n, m - kP);
    __syncthreads();
  }

  for (int ip = kP; ip < n; ip += kP) {
    const float* lii_inv = LI + static_cast<size_t>(ip) * n + ip;
    for (int jp = 0; jp < ip; jp += kP) {
      // T = L[ip:ip+kP, jp:ip] X[jp:ip, jp:jp+kP] into cbuf, then
      // X_ij = -L_ii^-1 T
      tile_gemm<false, Out::kStore>(L + static_cast<size_t>(ip) * n + jp, n,
                                    LI + static_cast<size_t>(jp) * n + jp, n, nullptr, 0, cbuf,
                                    kP, kP, ip - jp, smem);
      tile_gemm<false, Out::kNegate>(lii_inv, n, cbuf, kP, nullptr, 0,
                                     LI + static_cast<size_t>(ip) * n + jp, n, kP, kP, smem);
    }
  }
}

}  // namespace

extern "C" {

// a: b x n x n f32 (n a positive multiple of kP, at most kMaxN); l, li: the
// same shape, zero-filled; scratch: b (n + 2 kP) kP floats.  One launch on
// `stream`; returns cudaGetLastError() as an int (0 = launched).
int chol_inv_grid(const void* a, void* l, void* li, void* scratch, int b, int n, void* stream) {
  if (b < 1 || n < kP || n % kP != 0 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  chol_inv_grid_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(l), static_cast<float*>(li),
      static_cast<float*>(scratch), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
