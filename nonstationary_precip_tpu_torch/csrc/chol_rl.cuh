// The right-looking blocked Cholesky that K10a (chol_blocked.cu), K5
// (chol_stream.cu), K10c (chol_stream_v1.cu) and K8 (gibbs_fused.cu) share,
// designed for Hopper (sm_90a).  It replaces the TPU
// kernels nonstationary_precip_tpu/ops/pallas_chol.py::blocked_cholesky (body
// _chol_kernel, whose right-looking order this is) and ::streaming_cholesky2
// (body _stream2_kernel, whose diagonal tiles come from the recursive 2 x 2
// blocking _chol_inv_rec, as here).
//
// The factorisation works in place on L, which the caller fills with the
// lower triangle of the padded matrix (n a multiple of kT = 128, the upper
// triangle zero).  For each block column j (jp = j kT):
//  1. diag_kernel, one CTA: the tile L[jp:jp+kT, jp:jp+kT] into shared memory
//     as a square (row stride kT + 4, 66 KB), factored by the recursive
//     2 x 2 blocking of _chol_inv_rec down to 32-wide leaves, with L21 by
//     forward substitution where _chol_inv_rec multiplies by L11^-1.  A
//     leaf is one warp: 32 column steps in registers, the column broadcast
//     through shared memory, no block barrier inside; between leaves
//     L21 = D21 L11^-T (lower_solve: one thread a row) and D22 -= L21 L21^T
//     (all eight warps).  About a dozen block barriers for 128 columns,
//     where a column sweep takes two a column.  L_jj goes back into L.
//  2. panel_kernel: the panel L[jp+kT:, j] = W[jp+kT:, j] L_jj^-T by blocked
//     forward substitution against L_jj, 64 rows a CTA, in place.
//  3. syrk_kernel<kColumn, kTriangle>: the trailing update
//     W[jp+kT:, jp+kT:] -= P P^T with P the new panel (K = 128), one CTA per
//     128 x 128 tile of the lower triangle (2016 CTAs at N = 8192's first
//     column), the diagonal tiles written below their diagonal only.
// The SYRK kernel: 256 threads, each an 8 x 8 register micro-tile of f32
// FFMAs (rows ty + 16 a, columns tx + 16 b); 16-deep k-slabs of both
// operands come into a 3-stage shared-memory ring by cp.async (16 bytes a
// copy) and are read with 16-byte loads from rows padded to 20 floats,
// which eight consecutive rows read without bank conflicts; two CTAs an SM
// for K5, one for K10a.
// factor<false> (K10a) launches the three in turn on the caller's stream,
// 3 n / kT - 2 launches a call.  factor<true> (K5) looks ahead: block column
// j + 1's update (kColumn), diagonal tile and panel run on a second stream
// of the highest priority while the rest of column j's update (kTriangle)
// runs on the caller's, 4 n / kT - 4 launches joined by events; the
// diagonal tiles and panels then hide behind the trailing updates.
// No tensor cores, no TF32, no atomics: each entry's K = 128 products are
// summed in ascending order and the block columns' updates are applied in
// column order, so the rounding grows with 128 + N / 128 and every run gives
// the same bits.
// A diagonal tile with a pivot that is not > 0, or a non-finite entry of
// L_jj or of its Schur complements, is written as NaN whole, and the NaN
// reaches every later column through the panels and the trailing updates:
// safe_cholesky's retry sees a non-finite factor.
// What bounds it on an H100: the N^3/3 FFMA operations of the trailing
// updates (67 TFLOP/s of f32 outside the tensor cores), then the chain of
// N/128 diagonal tiles, each on one SM.
// K8's two hooks are a compile-time template parameter of every kernel,
// kFused, so that K5, K10a and K10c compile to the code they had without
// them.  With kFused each kernel first reads state[0] (set once an attempt
// of K8's jitter ladder has succeeded) and returns at once when it is set;
// diag_kernel then forward-substitutes the right-hand side alpha_j against
// the tile it has just factored (a substitution, not a product with
// L_jj^-1: see panel_kernel) and sets state[1] if the tile failed, and
// panel_kernel, once its rows X are solved, subtracts X alpha_j from its own
// rows of alpha.  Each row of alpha is owned by one CTA and the block
// columns are applied in order, so alpha = L^-1 y rides the factorisation
// with no atomics, the same bits on every run.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace chol_rl {

constexpr int kT = 128;       // tile width
constexpr int kLeaf = 32;     // leaf width of the diagonal recursion: one warp
constexpr int kLds = kT + 4;  // diagonal tile's row stride: 16-byte rows, kLds / 4 odd
constexpr int kDiagThreads = 256;
// the tile and the leaves' two 32-float column buffers
constexpr int kDiagSmem = (kT * kLds + 2 * kLeaf) * static_cast<int>(sizeof(float));

constexpr int kPanelRows = 64;  // panel rows a CTA solves
constexpr int kPanelThreads = 256;
constexpr int kPanelSmem = (kT + kPanelRows) * kLds * static_cast<int>(sizeof(float));  // L_jj and the rows
static_assert(kPanelThreads == 4 * kPanelRows && kPanelRows % 32 == 0,
              "the panel's update gives each thread 2 x 4 entries of a 32-column block");

constexpr int kTileThreads = 256;  // 16 x 16 threads, each an 8 x 8 micro-tile
constexpr int kMicro = kT / 16;
constexpr int kBK = 16;            // k-slab depth
constexpr int kStages = 3;         // the cp.async ring
constexpr int kSlabLd = kBK + 4;   // 80-byte rows: 16-byte aligned, 8 rows on 8 distinct bank quads
constexpr int kSlab = kT * kSlabLd;  // floats of one operand's slab
constexpr int kTileSmem = kStages * 2 * kSlab * static_cast<int>(sizeof(float));
constexpr int kCopies = kT * kBK / 4 / kTileThreads;  // 16-byte copies of each operand's slab a thread
static_assert(kT % kBK == 0 && kBK % 4 == 0 && kCopies * 4 * kTileThreads == kT * kBK,
              "the threads copy each operand's slab in whole 16-byte pieces");

// false for NaN and +-inf
__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= 3.402823466e+38f; }

// K8's hooks (read only by the kFused instantiations): the right-hand side
// and K8's state pair.  Each launch gets alpha at the block column's first
// row jp: diag_kernel solves alpha[0, kT), panel_kernel updates the rows
// below, alpha[kT + kPanelRows blockIdx.x, ...).
struct Rhs {
  float* alpha;  // y in, L^-1 y out
  int* state;    // [0]: 1 + the attempt that succeeded, 0 while none has; [1]: a tile failed
};

// ---- cp.async: 16 bytes global -> shared, outside the register file ----
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// ---- end of cp.async ----

// ---------------------------------------------------------------------------
// The diagonal tile
// ---------------------------------------------------------------------------

// The 32 x 32 leaf at (o, o) of D, by warp 0, factored in one pass of 32
// column steps with no block barrier: lane r holds row r of the Schur
// complement (a) in registers.  Step k: the pivot from lane k,
// L[r][k] = a[k] rsqrt(d) stored to D, the column L[:, k] broadcast through
// `col` (2 x 32 floats of shared memory, read back as 16-byte broadcasts),
// then the rank-1 Schur update of a[j] for j > k.  Fully unrolled (no
// register moves, the next pivot's broadcast issued as soon as it is
// ready) and not inlined, so the four leaves of a tile share one copy of
// the code in the instruction cache.  A pivot that is not > 0, or a
// non-finite entry, sets *bad.
__device__ __noinline__ void leaf(float* D, int o, float* col, int* bad) {
  const int lane = threadIdx.x;
  float* drow = D + (o + lane) * kLds + o;
  float a[kLeaf];
#pragma unroll
  for (int j = 0; j < kLeaf; ++j) a[j] = j <= lane ? drow[j] : 0.f;
#pragma unroll
  for (int k = 0; k < kLeaf; ++k) {
    const float d = __shfl_sync(0xffffffffu, a[k], k);  // the pivot, uniform over the warp
    const float rs = rsqrtf(d);
    const float l = lane == k ? d * rs : (lane > k ? a[k] * rs : 0.f);
    if (!(d > 0.f && finite(d) && finite(l))) *bad = 1;
    drow[k] = l;  // zero above the diagonal
    float* cb = col + (k & 1) * kLeaf;  // two buffers: step k + 1 writes while step k's reads finish
    cb[lane] = l;
    __syncwarp();
    float cv[kLeaf];
#pragma unroll
    for (int q = (k + 1) / 4; q < kLeaf / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(cb)[q];
      cv[4 * q] = v.x;
      cv[4 * q + 1] = v.y;
      cv[4 * q + 2] = v.z;
      cv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int j = k + 1; j < kLeaf; ++j) a[j] = fmaf(-l, cv[j], a[j]);
  }
}

// S = A B over an h x h block, all 256 threads, thread (ty, tx) the entries
// (ty + 16 a, tx + 16 b): S[r][c] = sum_t A[r][t] B(t, c) in ascending t,
// with B(t, c) = B[c][t] if kBT, else B[t][c]; every matrix at row stride
// kLds.  A, and B if kBT, are read four t at a time with 16-byte loads (two
// distinct rows of A a warp; sixteen of B, on distinct bank quads as
// kLds / 4 is odd); B otherwise one float a column, consecutive in tx.
template <int h, bool kBT>
__device__ __forceinline__ void block_prod(const float* A, const float* B, float (&s)[h / 16][h / 16]) {
  constexpr int m = h / 16;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < m; ++a)
#pragma unroll
    for (int b = 0; b < m; ++b) s[a][b] = 0.f;
#pragma unroll 2
  for (int t = 0; t < h; t += 4) {
    float av[m][4], bv[m][4];
#pragma unroll
    for (int a = 0; a < m; ++a) {
      const float4 v = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * kLds + t);
      av[a][0] = v.x;
      av[a][1] = v.y;
      av[a][2] = v.z;
      av[a][3] = v.w;
    }
#pragma unroll
    for (int b = 0; b < m; ++b) {
      if (kBT) {
        const float4 v = *reinterpret_cast<const float4*>(B + (tx + 16 * b) * kLds + t);
        bv[b][0] = v.x;
        bv[b][1] = v.y;
        bv[b][2] = v.z;
        bv[b][3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[b][q] = B[(t + q) * kLds + tx + 16 * b];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int a = 0; a < m; ++a)
#pragma unroll
        for (int b = 0; b < m; ++b) s[a][b] = fmaf(av[a][q], bv[b][q], s[a][b]);
  }
}

// C = alpha S + beta C over the h x h block C (row stride kLds), thread
// (ty, tx) the entries of block_prod; a non-finite result sets *bad.
template <int h>
__device__ __forceinline__ void block_store(float* C, const float (&s)[h / 16][h / 16], float alpha, float beta,
                                            int* bad) {
  constexpr int m = h / 16;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  bool ok = true;
#pragma unroll
  for (int a = 0; a < m; ++a)
#pragma unroll
    for (int b = 0; b < m; ++b) {
      float* c = C + (ty + 16 * a) * kLds + tx + 16 * b;
      const float v = beta == 0.f ? alpha * s[a][b] : fmaf(alpha, s[a][b], beta * *c);
      ok = ok && finite(v);
      *c = v;
    }
  if (!ok) *bad = 1;
}

// L21 = D21 L11^-T in place over the h x h block D21 at (o + h, o) of D,
// by blocked forward substitution against L11 at (o, o), as panel_kernel
// solves the panel: per 32-column block b, the update by the blocks
// already solved, R_b -= X_<b L11[b, <b]^T (all 256 threads, thread
// (ty, tx) the entries (ty + 32 a, tx + 8 c), K = 32 b in ascending
// order), then the substitution against the 32 x 32 diagonal block, one
// thread a row, dividing by the pivots.  _chol_inv_rec multiplies by
// L11^-1 instead, which is not backward stable: its error grows with
// |D21| |L11^-T|, and on an ill-conditioned tile (a 900^2 RBF Gram of
// lengthscale 0.5 with jitter 2e-5) it broke gamma_(N+1) |L| |L^T| 70 times
// over.  A non-finite entry sets *bad.  Starts and ends with every thread
// past a block barrier.
template <int h>
__device__ void lower_solve(float* D, int o, int* bad) {
  const float* l11 = D + o * kLds + o;
  float* x = D + (o + h) * kLds + o;
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
#pragma unroll 1
  for (int c0 = 0; c0 < h; c0 += kLeaf) {
    if (c0 > 0) {
      float acc[h / 32][4];
#pragma unroll
      for (int a = 0; a < h / 32; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 2
      for (int t = 0; t < c0; t += 4) {
        float4 av[h / 32], bv[4];
#pragma unroll
        for (int a = 0; a < h / 32; ++a) av[a] = *reinterpret_cast<const float4*>(x + (ty + 32 * a) * kLds + t);
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = *reinterpret_cast<const float4*>(l11 + (c0 + tx + 8 * c) * kLds + t);
#pragma unroll
        for (int a = 0; a < h / 32; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[a][c] = fmaf(av[a].x, bv[c].x, acc[a][c]);
            acc[a][c] = fmaf(av[a].y, bv[c].y, acc[a][c]);
            acc[a][c] = fmaf(av[a].z, bv[c].z, acc[a][c]);
            acc[a][c] = fmaf(av[a].w, bv[c].w, acc[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < h / 32; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) x[(ty + 32 * a) * kLds + c0 + tx + 8 * c] -= acc[a][c];
      __syncthreads();
    }
    if (tid < h) {
      float* xr = x + tid * kLds + c0;
      const float* lb = l11 + c0 * kLds + c0;  // the diagonal block
      float r[kLeaf];
#pragma unroll
      for (int j = 0; j < kLeaf; ++j) r[j] = xr[j];
      bool ok = true;
#pragma unroll
      for (int k = 0; k < kLeaf; ++k) {
        r[k] = r[k] / lb[k * kLds + k];
        ok = ok && finite(r[k]);
#pragma unroll
        for (int j = k + 1; j < kLeaf; ++j) r[j] = fmaf(-r[k], lb[j * kLds + k], r[j]);
      }
#pragma unroll
      for (int j = 0; j < kLeaf; ++j) xr[j] = r[j];
      if (!ok) *bad = 1;
    }
    __syncthreads();
  }
}

// L of the S x S block at (o, o) of D, in place: the recursion of
// pallas_chol.py::_chol_inv_rec with L21 by substitution,
//   L11 = rec(D11);  L21 = D21 L11^-T (lower_solve);  L22 = rec(D22 - L21 L21^T),
// so no inverse is formed.  Starts and ends with every thread past a block
// barrier.
template <int S>
__device__ void chol_rec(float* D, int o, float* col, int* bad) {
  if constexpr (S == kLeaf) {
    if (threadIdx.x < 32) leaf(D, o, col, bad);
    __syncthreads();
  } else {
    constexpr int h = S / 2;
    constexpr int m = h / 16;
    float* d21 = D + (o + h) * kLds + o;
    float* d22 = d21 + h;
    chol_rec<h>(D, o, col, bad);
    lower_solve<h>(D, o, bad);
    float s[m][m];
    block_prod<h, true>(d21, d21, s);  // D22 -= L21 L21^T
    block_store<h>(d22, s, -1.f, 1.f, bad);
    __syncthreads();
    chol_rec<h>(D, o + h, col, bad);
  }
}

// K8's right-hand side of the tile, by warp 0: a[0, kT) = L_jj^-1 a[0, kT)
// by forward substitution in L_jj (the lower triangle of D), column by
// column.  Lane r holds rows r, r + 32, r + 64 and r + 96 in registers; step
// k divides row k by the pivot (its owner's value broadcast) and subtracts
// L[i][k] x_k from every row i > k, one fused multiply-add each, so every
// row's updates come in ascending k.  The 32 steps of a block of rows stay a
// loop: fully unrolled, the 128 steps (a division each) took 14.6 us a tile
// on an H100 against 9.7 rolled, and four steps a body no less than rolled
// (tools/bench_k8.py), likely the unrolled code's size.  NaN whole if the
// tile failed.
__device__ __forceinline__ void rhs_solve(const float* D, float* a, bool ok) {
  constexpr int kQ = kT / 32;  // rows a lane holds
  const int lane = threadIdx.x;
  float v[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) v[q] = a[32 * q + lane];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll 1
    for (int t = 0; t < 32; ++t) {
      const int k = 32 * q + t;
      const float xk = __shfl_sync(0xffffffffu, v[q], t) / D[k * kLds + k];
      if (lane == t) v[q] = xk;
#pragma unroll
      for (int p = q; p < kQ; ++p) {
        if (p > q || lane > t) v[p] = fmaf(-D[(32 * p + lane) * kLds + k], xk, v[p]);
      }
    }
  }
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int q = 0; q < kQ; ++q) a[32 * q + lane] = ok ? v[q] : nan;
}

// Factor the diagonal tile at (jp, jp) of L (row stride n; its lower
// triangle is read): L_jj back into L, zeros above its diagonal; NaN whole
// if a pivot was not > 0 or an entry of L_jj, or of its Schur complements,
// is not finite.  The tile comes in and goes out as 16-byte pieces,
// sixteen a thread in flight.  With kFused (K8): nothing once state[0] is
// set; then alpha_j = L_jj^-1 alpha_j (rhs_solve) and state[1] = 1 if the
// tile failed.
template <bool kFused>
__global__ void __launch_bounds__(kDiagThreads) diag_kernel(float* __restrict__ L, int n, int jp, Rhs rhs) {
  if constexpr (kFused) {
    if (rhs.state[0] != 0) return;
  }
  extern __shared__ __align__(16) float smem[];
  __shared__ int bad;
  float* D = smem;                // the tile, then L_jj (scratch in its upper blocks)
  float* col = smem + kT * kLds;  // the leaves' column broadcast
  constexpr int kQuads = kT / 4;                       // 16-byte pieces a row
  constexpr int kPer = kT * kQuads / kDiagThreads;     // pieces a thread
  const int tid = threadIdx.x;
  float* tile = L + static_cast<size_t>(jp) * n + jp;
  float4 v[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = tid + q * kDiagThreads;
    v[q] = *reinterpret_cast<const float4*>(tile + static_cast<size_t>(e / kQuads) * n + (e % kQuads) * 4);
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = tid + q * kDiagThreads;
    const int r = e / kQuads;
    const int c = (e % kQuads) * 4;
    const float4 w = make_float4(c <= r ? v[q].x : 0.f, c + 1 <= r ? v[q].y : 0.f, c + 2 <= r ? v[q].z : 0.f,
                                 c + 3 <= r ? v[q].w : 0.f);
    *reinterpret_cast<float4*>(D + r * kLds + c) = w;
  }
  if (tid == 0) bad = 0;
  __syncthreads();
  chol_rec<kT>(D, 0, col, &bad);
  const bool ok = bad == 0;
  const float nan = __int_as_float(0x7fc00000);
  const float4 nan4 = make_float4(nan, nan, nan, nan);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = tid + q * kDiagThreads;
    const int r = e / kQuads;
    const int c = (e % kQuads) * 4;
    const float4 dv = *reinterpret_cast<const float4*>(D + r * kLds + c);
    const float4 w = make_float4(c <= r ? dv.x : 0.f, c + 1 <= r ? dv.y : 0.f, c + 2 <= r ? dv.z : 0.f,
                                 c + 3 <= r ? dv.w : 0.f);
    *reinterpret_cast<float4*>(tile + static_cast<size_t>(r) * n + c) = ok ? w : nan4;
  }
  if constexpr (kFused) {
    if (tid < 32) rhs_solve(D, rhs.alpha, ok);
    if (tid == 0 && !ok) rhs.state[1] = 1;
  }
}

// ---------------------------------------------------------------------------
// The panel
// ---------------------------------------------------------------------------

// Rows r0 .. r0 + kPanelRows of the panel P (row stride ld, r0 =
// kPanelRows blockIdx.x), in place: X = W L_jj^-T by blocked forward
// substitution against L_jj (the kT x kT lower tile at Ljj, row stride ld),
// both staged in shared memory.  Per 32-column block b: the update by the
// blocks already solved, R_b -= X_<b L_b,<b^T (K = 32 b, ascending, 16-byte
// reads; threads (ty, tx) the entries (ty + 32 a, tx + 8 c)), then the
// substitution against the 32 x 32 diagonal block, one thread a row,
// dividing by the pivots.  Substitution is backward stable, as a product
// with L_jj^-1 is not: its error grows with |W| |L_jj^-T|, which on the
// noisy Gibbs Gram at init broke the bound gamma_(N+1) |L| |L^T|.  With
// kFused (K8): nothing once state[0] is set; then the CTA's rows of alpha
// (at rhs.alpha + kT + r0) less X alpha_j (alpha_j at rhs.alpha, final),
// four threads a row, thread p summing the columns p, p + 4, .. in
// ascending order and the four sums added in a fixed order.
template <bool kFused>
__global__ void __launch_bounds__(kPanelThreads) panel_kernel(float* P, int ld, const float* __restrict__ Ljj, Rhs rhs) {
  if constexpr (kFused) {
    if (rhs.state[0] != 0) return;
  }
  extern __shared__ __align__(16) float smem[];
  float* Ls = smem;              // L_jj, zeros above its diagonal
  float* Xs = smem + kT * kLds;  // the rows: W, then X
  constexpr int kQuads = kT / 4;
  const int tid = threadIdx.x;
  float* rows = P + static_cast<size_t>(blockIdx.x) * kPanelRows * ld;
  for (int e = tid; e < kT * kQuads; e += kPanelThreads) {
    const int r = e / kQuads;
    const int c = (e % kQuads) * 4;
    *reinterpret_cast<float4*>(Ls + r * kLds + c) =
        *reinterpret_cast<const float4*>(Ljj + static_cast<size_t>(r) * ld + c);
  }
  for (int e = tid; e < kPanelRows * kQuads; e += kPanelThreads) {
    const int r = e / kQuads;
    const int c = (e % kQuads) * 4;
    *reinterpret_cast<float4*>(Xs + r * kLds + c) =
        *reinterpret_cast<const float4*>(rows + static_cast<size_t>(r) * ld + c);
  }
  __syncthreads();
  const int tx = tid % 8;
  const int ty = tid / 8;
#pragma unroll 1
  for (int c0 = 0; c0 < kT; c0 += kLeaf) {
    if (c0 > 0) {
      float acc[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 2
      for (int t = 0; t < c0; t += 4) {
        float4 av[2], bv[4];
#pragma unroll
        for (int a = 0; a < 2; ++a) av[a] = *reinterpret_cast<const float4*>(Xs + (ty + 32 * a) * kLds + t);
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = *reinterpret_cast<const float4*>(Ls + (c0 + tx + 8 * c) * kLds + t);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[a][c] = fmaf(av[a].x, bv[c].x, acc[a][c]);
            acc[a][c] = fmaf(av[a].y, bv[c].y, acc[a][c]);
            acc[a][c] = fmaf(av[a].z, bv[c].z, acc[a][c]);
            acc[a][c] = fmaf(av[a].w, bv[c].w, acc[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) Xs[(ty + 32 * a) * kLds + c0 + tx + 8 * c] -= acc[a][c];
      __syncthreads();
    }
    if (tid < kPanelRows) {
      float* xr = Xs + tid * kLds + c0;
      const float* lb = Ls + c0 * kLds + c0;  // the diagonal block
      float r[kLeaf];
#pragma unroll
      for (int j = 0; j < kLeaf; ++j) r[j] = xr[j];
#pragma unroll
      for (int k = 0; k < kLeaf; ++k) {
        r[k] = r[k] / lb[k * kLds + k];
#pragma unroll
        for (int j = k + 1; j < kLeaf; ++j) r[j] = fmaf(-r[k], lb[j * kLds + k], r[j]);
      }
#pragma unroll
      for (int j = 0; j < kLeaf; ++j) xr[j] = r[j];
    }
    __syncthreads();
  }
  if constexpr (kFused) {
    float* aj = Ls;  // L_jj is not read again: alpha_j over its first row
    if (tid < kT) aj[tid] = rhs.alpha[tid];
    __syncthreads();
    const int r = tid / 4;
    const int p = tid % 4;
    const float* xr = Xs + r * kLds;
    float s = 0.f;
#pragma unroll 8
    for (int c = p; c < kT; c += 4) s = fmaf(xr[c], aj[c], s);
    const float s1 = __shfl_down_sync(0xffffffffu, s, 1);
    const float s2 = __shfl_down_sync(0xffffffffu, s, 2);
    const float s3 = __shfl_down_sync(0xffffffffu, s, 3);
    if (p == 0) rhs.alpha[kT + blockIdx.x * kPanelRows + r] -= (s + s1) + (s2 + s3);
  }
  for (int e = tid; e < kPanelRows * kQuads; e += kPanelThreads) {
    const int r = e / kQuads;
    const int c = (e % kQuads) * 4;
    *reinterpret_cast<float4*>(rows + static_cast<size_t>(r) * ld + c) =
        *reinterpret_cast<const float4*>(Xs + r * kLds + c);
  }
}

// ---------------------------------------------------------------------------
// The trailing update
// ---------------------------------------------------------------------------

// One k-slab of both operands into the ring: rows m0.. and n0.. of the
// panel P (row stride ld), columns k0..k0+kBK, kCopies 16-byte cp.async
// copies of each a thread.
__device__ __forceinline__ void load_slab(float* xs, float* ys, const float* P, int ld, int m0, int n0, int k0) {
#pragma unroll
  for (int q = 0; q < kCopies; ++q) {
    const int e = threadIdx.x + q * kTileThreads;
    const int r = e / (kBK / 4);
    const int c = (e % (kBK / 4)) * 4;
    cp_async16(xs + r * kSlabLd + c, P + static_cast<size_t>(m0 + r) * ld + k0 + c);
    cp_async16(ys + r * kSlabLd + c, P + static_cast<size_t>(n0 + r) * ld + k0 + c);
  }
}

// What one launch of syrk_kernel updates.
enum SyrkMode : int {
  kColumn = 0,    // the tiles (b, 0): the first block column of a trailing update
  kTriangle = 1,  // the lower tiles (ti, tj), tj <= ti, numbered row by row: all of it, or the rest
};

// C[tile] -= P[m0:m0+kT, 0:kT] P[n0:n0+kT, 0:kT]^T for one kT x kT tile at
// (m0, n0) = kT (ti, tj) of the trailing block C, as kMode says, P the
// panel beside it (both at row stride ld); a tile on the diagonal
// (ti == tj) is written below its diagonal only.  kCtasPerSm = 2 (K5's
// many-wave updates) caps a thread at 128 registers so that two CTAs share
// an SM and one's loads and read-modify-write overlap the other's FFMAs, at
// the cost of a few spilled registers; 1 (K10a's single-wave updates) lets
// one CTA finish its tile sooner without spills.  With kFused (K8): nothing
// once state[0] is set.
template <int kMode, int kCtasPerSm, bool kFused>
__global__ void __launch_bounds__(kTileThreads, kCtasPerSm)
syrk_kernel(const float* __restrict__ P, float* __restrict__ C, int ld, Rhs rhs) {
  if constexpr (kFused) {
    if (rhs.state[0] != 0) return;
  }
  extern __shared__ __align__(16) float ring[];
  int ti = blockIdx.x;
  int tj = 0;
  if (kMode == kTriangle) {
    const int t = blockIdx.x;
    ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    while (ti * (ti + 1) / 2 > t) --ti;
    tj = t - ti * (ti + 1) / 2;
  }
  const int m0 = ti * kT;
  const int n0 = tj * kT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  constexpr int kSlabs = kT / kBK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_slab(ring + 2 * s * kSlab, ring + (2 * s + 1) * kSlab, P, ld, m0, n0, s * kBK);
    cp_async_commit();
  }
  float acc[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = 0.f;

#pragma unroll 1
  for (int s = 0; s < kSlabs; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slab s have landed
    __syncthreads();               // everyone's have, and slab s - 1's buffer is free
    const int nx = s + kStages - 1;
    if (nx < kSlabs) {
      const int st = nx % kStages;
      load_slab(ring + 2 * st * kSlab, ring + (2 * st + 1) * kSlab, P, ld, m0, n0, nx * kBK);
    }
    cp_async_commit();  // an empty group at the tail keeps the count uniform
    const float* xs = ring + 2 * (s % kStages) * kSlab;
    const float* ys = xs + kSlab;
#pragma unroll
    for (int kq = 0; kq < kBK; kq += 4) {
      float av[kMicro][4];
#pragma unroll
      for (int a = 0; a < kMicro; ++a) {
        const float4 v = *reinterpret_cast<const float4*>(xs + (ty + 16 * a) * kSlabLd + kq);
        av[a][0] = v.x;
        av[a][1] = v.y;
        av[a][2] = v.z;
        av[a][3] = v.w;
      }
#pragma unroll
      for (int b = 0; b < kMicro; ++b) {
        const float4 v = *reinterpret_cast<const float4*>(ys + (tx + 16 * b) * kSlabLd + kq);
#pragma unroll
        for (int a = 0; a < kMicro; ++a) {
          acc[a][b] = fmaf(av[a][0], v.x, acc[a][b]);
          acc[a][b] = fmaf(av[a][1], v.y, acc[a][b]);
          acc[a][b] = fmaf(av[a][2], v.z, acc[a][b]);
          acc[a][b] = fmaf(av[a][3], v.w, acc[a][b]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int r = ty + 16 * a;
    float* crow = C + static_cast<size_t>(m0 + r) * ld + n0;
#pragma unroll
    for (int b = 0; b < kMicro; ++b) {
      const int c = tx + 16 * b;
      if (ti != tj || c <= r) crow[c] -= acc[a][b];
    }
  }
}

// The factorisation of the n x n matrix in L (row stride n, n a positive
// multiple of kT; the lower triangle of the padded matrix, zeros above),
// in place.  Everything ends ordered on `s`.  Without look-ahead, per block
// column: the diagonal tile, the panel and the whole trailing update,
// 3 n / kT - 2 launches.  With kLookAhead: block column j + 1's update from
// panel j, its diagonal tile and its panel run on a second stream of the
// highest priority while the rest of column j's update runs on `s`, and
// events join the two; 4 n / kT - 4 launches.  With kFused (K8), `rhs`
// holds the right-hand side (n floats, L^-1 y on return) and K8's state
// pair.  Returns the first non-zero CUDA error as an int (0 = all
// launched).
template <bool kLookAhead, bool kFused = false>
inline int factor(float* L, int n, cudaStream_t s, Rhs rhs = {nullptr, nullptr}) {
  constexpr int kCtas = kLookAhead ? 2 : 1;  // SYRK CTAs an SM
  if (n < kT || n % kT != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(diag_kernel<kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDiagSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(panel_kernel<kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize, kPanelSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(syrk_kernel<kTriangle, kCtas, kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTileSmem);
  if constexpr (kLookAhead) {
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(syrk_kernel<kColumn, kCtas, kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTileSmem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nb = n / kT;
  constexpr int kPanelBlocks = kT / kPanelRows;  // panel CTAs a 128-row block
  // the right-hand side from block column jp's first row on
  auto at = [&](int jp) { return Rhs{rhs.alpha ? rhs.alpha + jp : nullptr, rhs.state}; };
  diag_kernel<kFused><<<1, kDiagThreads, kDiagSmem, s>>>(L, n, 0, at(0));
  if ((e = cudaGetLastError()) != cudaSuccess || nb == 1) return static_cast<int>(e);
  panel_kernel<kFused><<<(nb - 1) * kPanelBlocks, kPanelThreads, kPanelSmem, s>>>(L + static_cast<size_t>(kT) * n, n,
                                                                                  L, at(0));
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  if constexpr (!kLookAhead) {
    for (int jp = 0; jp + kT < n; jp += kT) {
      const int mt = (n - jp) / kT - 1;  // tile rows below the diagonal tile j
      const float* panel = L + static_cast<size_t>(jp + kT) * n + jp;
      float* trail = L + static_cast<size_t>(jp + kT) * n + jp + kT;  // the diagonal tile j + 1
      syrk_kernel<kTriangle, kCtas, kFused><<<mt * (mt + 1) / 2, kTileThreads, kTileSmem, s>>>(panel, trail, n, rhs);
      if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
      diag_kernel<kFused><<<1, kDiagThreads, kDiagSmem, s>>>(L, n, jp + kT, at(jp + kT));
      if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
      if (mt > 1) {
        panel_kernel<kFused><<<(mt - 1) * kPanelBlocks, kPanelThreads, kPanelSmem, s>>>(
            trail + static_cast<size_t>(kT) * n, n, trail, at(jp + kT));
        if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
      }
    }
    return 0;
  } else {
    // Look-ahead: while `s` runs the rest of column j's update (kTriangle),
    // `side` updates block column j + 1 (kColumn), factors its diagonal tile
    // and solves its panel.  tri_done: `s` has finished column j - 1's update
    // (the first block column of j's comes from it); panel_done: `side` has
    // the panel j + 1 that column j + 1's update reads.
    int lo = 0, hi = 0;
    cudaStream_t side = nullptr;
    cudaEvent_t tri_done = nullptr, panel_done = nullptr;
    e = cudaDeviceGetStreamPriorityRange(&lo, &hi);
    if (e == cudaSuccess) e = cudaStreamCreateWithPriority(&side, cudaStreamNonBlocking, hi);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&tri_done, cudaEventDisableTiming);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&panel_done, cudaEventDisableTiming);
    if (e == cudaSuccess) e = cudaEventRecord(tri_done, s);
    for (int jp = 0; e == cudaSuccess && jp + kT < n; jp += kT) {
      const int mt = (n - jp) / kT - 1;  // tile rows below the diagonal tile j
      const float* panel = L + static_cast<size_t>(jp + kT) * n + jp;
      float* trail = L + static_cast<size_t>(jp + kT) * n + jp + kT;  // the diagonal tile j + 1
      float* next = trail + static_cast<size_t>(kT) * n;              // panel j + 1
      if ((e = cudaStreamWaitEvent(side, tri_done, 0)) != cudaSuccess) break;
      syrk_kernel<kColumn, kCtas, kFused><<<mt, kTileThreads, kTileSmem, side>>>(panel, trail, n, rhs);
      if ((e = cudaGetLastError()) != cudaSuccess) break;
      diag_kernel<kFused><<<1, kDiagThreads, kDiagSmem, side>>>(L, n, jp + kT, at(jp + kT));
      if ((e = cudaGetLastError()) != cudaSuccess) break;
      if (mt > 1) {
        panel_kernel<kFused><<<(mt - 1) * kPanelBlocks, kPanelThreads, kPanelSmem, side>>>(next, n, trail,
                                                                                          at(jp + kT));
        if ((e = cudaGetLastError()) != cudaSuccess) break;
        syrk_kernel<kTriangle, kCtas, kFused><<<(mt - 1) * mt / 2, kTileThreads, kTileSmem, s>>>(
            panel + static_cast<size_t>(kT) * n, next + kT, n, rhs);
        if ((e = cudaGetLastError()) != cudaSuccess) break;
      }
      if ((e = cudaEventRecord(tri_done, s)) != cudaSuccess) break;
      if ((e = cudaEventRecord(panel_done, side)) != cudaSuccess) break;
      e = cudaStreamWaitEvent(s, panel_done, 0);  // after this column's update on s, before the next
    }
    // released once their work is done; s has waited for everything side ran
    if (panel_done) cudaEventDestroy(panel_done);
    if (tri_done) cudaEventDestroy(tri_done);
    if (side) cudaStreamDestroy(side);
    return static_cast<int>(e);
  }
}

// Registers, local (spill) bytes, static and dynamic shared memory of the
// kernels factor<kLookAhead, kFused> launches, as the runtime reports them,
// four ints each into `out`: the diagonal tile, the panel, then the trailing
// update (with look-ahead its first column, then the rest).  Returns the
// first non-zero error as an int.
template <bool kLookAhead, bool kFused = false>
inline int attributes(int* out) {
  constexpr int kCtas = kLookAhead ? 2 : 1;
  constexpr int kKernels = kLookAhead ? 4 : 3;
  const void* fns[4] = {reinterpret_cast<const void*>(&diag_kernel<kFused>),
                        reinterpret_cast<const void*>(&panel_kernel<kFused>),
                        reinterpret_cast<const void*>(&syrk_kernel<kTriangle, kCtas, kFused>), nullptr};
  if constexpr (kLookAhead) {
    fns[2] = reinterpret_cast<const void*>(&syrk_kernel<kColumn, kCtas, kFused>);
    fns[3] = reinterpret_cast<const void*>(&syrk_kernel<kTriangle, kCtas, kFused>);
  }
  const int dyn[4] = {kDiagSmem, kPanelSmem, kTileSmem, kTileSmem};
  for (int k = 0; k < kKernels; ++k) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, fns[k]);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[4 * k] = fa.numRegs;
    out[4 * k + 1] = static_cast<int>(fa.localSizeBytes);
    out[4 * k + 2] = static_cast<int>(fa.sharedSizeBytes);
    out[4 * k + 3] = dyn[k];
  }
  return 0;
}

}  // namespace chol_rl
