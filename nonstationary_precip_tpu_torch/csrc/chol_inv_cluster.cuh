// The cluster (L, L^-1) that K1 (chol_inv_cluster.cu) and K4
// (svgp_precompute.cu) share: one thread-block cluster of kCluster CTAs
// factors one SPD member and inverts its factor in one chain of block
// steps, for Hopper (sm_90a).
//
// The member, padded to np = 32 nb with an identity block, is kept as the
// nb (nb + 1) / 2 tiles of 32 x 32 of its lower triangle, spread over the
// cluster's shared memory: tile (i, j) at linear index t = i (i + 1) / 2 + j
// lives in CTA t % kCluster, slot t / kCluster.  A tile holds the Schur
// complement S_ij until its block column is factored, then L_ij, and from
// then on the partial forward substitution of the identity that ends as
// (L^-1)_ij, so one chain of nb block steps yields both L and L^-1.
// Block step k:
//  1. every CTA copies S_kk from its owner (distributed shared memory) and
//     factors it in one warp, in registers (the leaf of chol_rl.cuh: 32
//     column steps that give L_kk and X_kk = L_kk^-1 together).  The
//     copies and the code are the same in every CTA, so every CTA reaches
//     the same pivot decision without a message;
//  2. each CTA, one warp a tile it owns: the panel L_ik = S_ik L_kk^-T by
//     forward substitution against L_kk (lane r row r), and row k of L^-1,
//     X_kj = L_kk^-1 W_kj for j < k, by substitution too (lane c column c).
//     No product with an inverse tile forms L: that breaks the backward
//     error bound of the factor;                       -- cluster barrier
//  3. each CTA copies the step's operands into its own shared memory: the
//     panel transposed (buf[i] = L_ik^T, i > k), row k of L^-1 (buf[j] =
//     X_kj, j < k) and X_kk (buf[k]); the owner of tile (k, k) also keeps
//     X_kk there;                                      -- cluster barrier
//  4. each CTA updates the tiles it owns below row k, a 4 x 4 FFMA register
//     micro-tile a thread, 64 threads a tile:
//         W_ij -= sum_m buf[i][m][r] buf[j][m][c]   (j != k; j < k: the
//         substitution of L^-1, j > k: the Schur update S_ij -= L_ik L_jk^T)
//         W_ik  = -sum_m buf[i][m][r] buf[k][m][c]  (L^-1's column k starts)
//     each entry's 32 products summed in ascending m, then applied once.
//                                                      -- cluster barrier
// L's tiles and L^-1's rows go to global memory as they become final; the
// upper triangles are written as zeros at the end.  After a try that
// succeeds, every lower tile slot of the cluster holds (L^-1)_ij, so a
// caller can go on to use L^-1 from shared memory (K4's W = L^-T P).
//
// What differs between the two users is a Source (see factor() below): how
// a tile of the try's matrix is made (K1 reads A + j I from global memory;
// K4 builds its Gram tile from z / ell in shared memory, so K_zz never
// reaches device memory), and the jitter ladder.  The retry: a pivot that
// is not > 0, or a non-finite entry of the leaf, fails the try at once in
// every CTA alike; a non-finite entry of the panel or of row k of L^-1 sets
// its CTA's flag, and the flags are OR-ed over the cluster after the last
// step.  A failed try restarts the whole cluster from the Source's next
// rung; a member that never failed runs once with no jitter, and its bits
// do not depend on any other member.  Plain f32 FFMA, rsqrtf in the leaf,
// IEEE division or the product with the IEEE reciprocal of the diagonal in
// the substitutions (K1: division; K4: reciprocal); no tensor cores, no
// atomics: every run gives the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace chol_cluster {

namespace cg = cooperative_groups;

constexpr int kB = 32;           // block width: one warp's leaf
constexpr int kLd = kB + 4;      // tile row stride: 16-byte rows
constexpr int kTile = kB * kLd;  // floats a tile slot
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileThreads = 64;  // threads a tile in the update: 8 x 8, each 4 x 4
static_assert(kThreads % kTileThreads == 0 && kThreads == kB * kB / 4, "one float4 of a tile a thread");

__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= 3.402823466e+38f; }

__host__ __device__ __forceinline__ int num_blocks(int n) { return (n + kB - 1) / kB; }
__host__ __device__ __forceinline__ int num_tiles(int nb) { return nb * (nb + 1) / 2; }
template <int kCluster>
__host__ __device__ __forceinline__ int slots(int nb) { return (num_tiles(nb) + kCluster - 1) / kCluster; }

// Shared memory factor() takes, in floats: a CTA's tile slots, the operand
// buffer (nb tiles), L_kk, the leaf's two column buffers and two flags.
template <int kCluster>
__host__ __device__ __forceinline__ size_t factor_floats(int n) {
  const int nb = num_blocks(n);
  return static_cast<size_t>(slots<kCluster>(nb) + nb + 1) * kTile + 2 * kB + 4;
}

// (i, j) of the lower tile at linear index t = i (i + 1) / 2 + j
__device__ __forceinline__ void tile_of(int t, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  j = t - i * (i + 1) / 2;
}

// The leaf: D (S_kk, natural, row stride kLd) factored in place by one warp
// into L_kk (zeros above the diagonal) and X = L_kk^-1 written beside it, in
// one pass of 32 column steps: lane r holds row r of the Schur complement
// (a) and lane c column c of the substitution of the identity (x), in
// registers; column k of L goes to the other lanes through `col` (2 x 32
// floats, read back as 16-byte broadcasts).  A pivot that is not > 0, or a
// non-finite entry, sets *bad.
__device__ __noinline__ void leaf(float* D, float* X, float* col, int* bad) {
  const int lane = threadIdx.x & 31;
  float* drow = D + lane * kLd;
  float a[kB], x[kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    a[j] = j <= lane ? drow[j] : 0.f;
    x[j] = j == lane ? 1.f : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    const float d = __shfl_sync(0xffffffffu, a[k], k);
    const float rs = rsqrtf(d);
    const float l = lane == k ? d * rs : (lane > k ? a[k] * rs : 0.f);
    const float xk = x[k] * rs;
    if (!(d > 0.f && finite(d) && finite(l) && finite(xk))) *bad = 1;
    drow[k] = l;
    X[k * kLd + lane] = xk;
    float* cb = col + (k & 1) * kB;
    cb[lane] = l;
    __syncwarp();
    float cv[kB];
#pragma unroll
    for (int q = (k + 1) / 4; q < kB / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(cb)[q];
      cv[4 * q] = v.x;
      cv[4 * q + 1] = v.y;
      cv[4 * q + 2] = v.z;
      cv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int j = k + 1; j < kB; ++j) {
      a[j] = fmaf(-l, cv[j], a[j]);
      x[j] = fmaf(-cv[j], xk, x[j]);
    }
  }
  __syncwarp();
}

// Forward substitution of one 32-vector against L (natural, stride kLd):
// v_m = (v_m - sum_{p < m} L[m][p] v_p) / L[m][m], the sum in ascending p,
// by IEEE division, or (kRecip) times rdiag[m] = 1 / L[m][m], which takes
// the division off the chain of 32 dependent rows.  Lane-private; L and
// rdiag read as warp-wide broadcasts.
template <bool kRecip>
__device__ __forceinline__ void substitute(const float* L, const float* rdiag, float (&v)[kB]) {
#pragma unroll
  for (int m = 0; m < kB; ++m) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < m; ++p) s = fmaf(L[m * kLd + p], v[p], s);
    if constexpr (kRecip) v[m] = (v[m] - s) * rdiag[m];
    else v[m] = (v[m] - s) / L[m * kLd + m];
  }
}

// One warp writes the 32 x 32 tile T (stride kLd) to the n x n output G at
// block (bi, bj), rows and columns past n dropped; 128-byte row stores.
__device__ __forceinline__ void store_tile(float* G, const float* T, int n, int bi, int bj) {
  const int lane = threadIdx.x & 31;
  const int c = bj * kB + lane;
  if (c >= n) return;
  for (int r = 0; r < kB; ++r) {
    const int row = bi * kB + r;
    if (row >= n) break;
    G[static_cast<size_t>(row) * n + c] = T[r * kLd + lane];
  }
}

// The tile (i, j), wherever in the cluster it lives; W is this CTA's first
// slot.
template <int kCluster>
__device__ __forceinline__ float* tile_ptr(cg::cluster_group& cluster, float* W, int i, int j) {
  const int t = i * (i + 1) / 2 + j;
  return cluster.map_shared_rank(W + (t / kCluster) * kTile, t % kCluster);
}

// (L, L^-1) of one member by the cluster: every CTA of the cluster calls it
// alike, with `smem` its dynamic shared memory (factor_floats<kCluster>(n)
// floats, 16-byte aligned) and L, LI the member's n x n outputs.  The
// Source gives the matrix, the substitutions' rounding and the ladder:
//   static constexpr bool kRecip       -- substitute's kRecip;
//   int tries() const                   -- tries in all;
//   float jitter(float prev, int a)     -- the diagonal jitter try a reports
//                                          (prev: try a - 1's; 0 at a = 0);
//   float entry(int r, int c, int a, float jit)  -- entry (r, c) of try a's
//                                          matrix, r, c < 32 nb: the
//                                          member inside n, I outside.
// Sets *jit_out to the last try's jitter.  Returns, alike in every CTA,
// whether a try succeeded: then L and LI are written, zeros above the
// diagonal, and every lower tile slot holds (L^-1)_ij; else L and LI are
// NaN.  Ends on a cluster barrier.
template <int kCluster, class Source>
__device__ bool factor(cg::cluster_group& cluster, float* smem, const Source& src, int n, float* L, float* LI,
                       float* jit_out) {
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5;
  const int nb = num_blocks(n);
  const int ntiles = num_tiles(nb);
  const int nown = (ntiles - rank + kCluster - 1) / kCluster;  // tiles t = rank + s kCluster

  float* W = smem;                              // slots(nb) tiles
  float* buf = W + slots<kCluster>(nb) * kTile;  // nb operand tiles
  float* D = buf + nb * kTile;                  // S_kk, then L_kk
  float* col = D + kTile;                       // the leaf's column buffers
  int* flags = reinterpret_cast<int*>(col + 2 * kB);  // [0] a non-finite panel entry, [1] the leaf failed
  const size_t nn = static_cast<size_t>(n) * n;
  auto tile = [&](int i, int j) { return tile_ptr<kCluster>(cluster, W, i, j); };

  float jit = 0.f;
  bool ok = false;
  for (int attempt = 0; attempt < src.tries(); ++attempt) {
    jit = src.jitter(jit, attempt);
    for (int s = 0; s < nown; ++s) {
      int i, j;
      tile_of(rank + s * kCluster, i, j);
      for (int e = tid; e < kB * kB; e += kThreads) {
        const int r = e / kB, c = e % kB;
        W[s * kTile + r * kLd + c] = src.entry(i * kB + r, j * kB + c, attempt, jit);
      }
    }
    if (tid == 0) flags[0] = 0;
    cluster.sync();

    bool failed = false;
    for (int k = 0; k < nb; ++k) {
      // 1. S_kk from its owner, factored by warp 0 of every CTA alike
      {
        const float* skk = tile(k, k);
        const int r = tid / 8, q = tid % 8;
        *reinterpret_cast<float4*>(D + r * kLd + 4 * q) = *reinterpret_cast<const float4*>(skk + r * kLd + 4 * q);
      }
      if (tid == 0) flags[1] = 0;
      __syncthreads();
      if (warp == 0) {
        leaf(D, buf + k * kTile, col, &flags[1]);
        // the leaf is done with its column buffers: the diagonal's
        // reciprocals go there
        if constexpr (Source::kRecip) col[tid] = 1.f / D[tid * kLd + tid];
      }
      __syncthreads();
      if (flags[1]) {  // the same in every CTA of the cluster
        failed = true;
        break;
      }
      // 2. the panel and row k of L^-1 by substitution, one warp a tile
      const int owner_kk = (k * (k + 1) / 2 + k) % kCluster;
      if (rank == owner_kk) {
        if (warp == 0) store_tile(L, D, n, k, k);
        if (warp == 1) store_tile(LI, buf + k * kTile, n, k, k);
      }
      int item = 0;
      for (int s = 0; s < nown; ++s) {
        int i, j;
        tile_of(rank + s * kCluster, i, j);
        const bool panel = j == k && i > k, row = i == k && j < k;
        if (!panel && !row) continue;
        if (item++ % kWarps != (warp + 2) % kWarps) continue;  // warps 0 and 1 may be storing L_kk, X_kk
        const int lane = tid & 31;
        float* T = W + s * kTile;
        float v[kB];
        if (panel) {
#pragma unroll
          for (int m = 0; m < kB; ++m) v[m] = T[lane * kLd + m];
        } else {
#pragma unroll
          for (int m = 0; m < kB; ++m) v[m] = T[m * kLd + lane];
        }
        substitute<Source::kRecip>(D, col, v);
        bool fin = true;
#pragma unroll
        for (int m = 0; m < kB; ++m) fin = fin && finite(v[m]);
        if (panel) {
#pragma unroll
          for (int m = 0; m < kB; ++m) T[lane * kLd + m] = v[m];
        } else {
#pragma unroll
          for (int m = 0; m < kB; ++m) T[m * kLd + lane] = v[m];
        }
        if (!fin) flags[0] = 1;
        __syncwarp();
        if (panel) store_tile(L, T, n, i, k);
        else store_tile(LI, T, n, k, j);
      }
      __syncthreads();
      cluster.sync();
      // 3. the step's operands into this CTA's buffer: buf[j] = X_kj
      //    (j < k), buf[i] = L_ik^T (i > k); buf[k] = X_kk from the leaf,
      //    which the owner of tile (k, k) also keeps in its slot (every CTA
      //    has read S_kk by now)
      for (int s = 0; s < nb; ++s) {
        const int r = tid / 8, q = tid % 8;
        float* B = buf + s * kTile;
        if (s == k) {
          if (rank == owner_kk) {
            const int t = k * (k + 1) / 2 + k;
            *reinterpret_cast<float4*>(W + (t / kCluster) * kTile + r * kLd + 4 * q) =
                *reinterpret_cast<const float4*>(B + r * kLd + 4 * q);
          }
        } else if (s < k) {
          const float* src_t = tile(k, s);
          *reinterpret_cast<float4*>(B + r * kLd + 4 * q) = *reinterpret_cast<const float4*>(src_t + r * kLd + 4 * q);
        } else {
          const float* src_t = tile(s, k);
          const float4 v = *reinterpret_cast<const float4*>(src_t + r * kLd + 4 * q);
          B[(4 * q) * kLd + r] = v.x;
          B[(4 * q + 1) * kLd + r] = v.y;
          B[(4 * q + 2) * kLd + r] = v.z;
          B[(4 * q + 3) * kLd + r] = v.w;
        }
      }
      __syncthreads();
      cluster.sync();
      // 4. the rank-32 update of this CTA's tiles below row k
      {
        const int group = tid / kTileThreads, g = tid % kTileThreads;
        const int tr = g / 8, tc = g % 8;
        int item4 = 0;
        for (int s = 0; s < nown; ++s) {
          int i, j;
          tile_of(rank + s * kCluster, i, j);
          if (i <= k) continue;
          if (item4++ % (kThreads / kTileThreads) != group) continue;
          const float* Ai = buf + i * kTile + 4 * tr;
          const float* Bj = buf + j * kTile + 4 * tc;
          float acc[4][4];
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
#pragma unroll 8
          for (int m = 0; m < kB; ++m) {
            const float4 av = *reinterpret_cast<const float4*>(Ai + m * kLd);
            const float4 bv = *reinterpret_cast<const float4*>(Bj + m * kLd);
            const float ax[4] = {av.x, av.y, av.z, av.w}, by[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
              for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(ax[x], by[y], acc[x][y]);
          }
          float* T = W + s * kTile + (4 * tr) * kLd + 4 * tc;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            float4 w = j == k ? make_float4(0.f, 0.f, 0.f, 0.f) : *reinterpret_cast<const float4*>(T + x * kLd);
            w.x -= acc[x][0];
            w.y -= acc[x][1];
            w.z -= acc[x][2];
            w.w -= acc[x][3];
            *reinterpret_cast<float4*>(T + x * kLd) = w;
          }
        }
      }
      __syncthreads();
      cluster.sync();
    }
    cluster.sync();  // every read of this try's tiles and leaf flags is done
    if (!failed) {
      for (int q = 0; q < kCluster; ++q) failed = failed || *cluster.map_shared_rank(flags, q) != 0;
    }
    cluster.sync();  // every CTA has read the flags before a retry resets them
    if (!failed) {
      ok = true;
      break;
    }
  }

  if (ok) {
    // the upper triangles: tiles (i, j), i < j, spread over the cluster
    for (int u = rank; u < nb * nb; u += kCluster) {
      const int i = u / nb, j = u % nb;
      if (i >= j) continue;
      for (int e = tid; e < kB * kB; e += kThreads) {
        const int r = i * kB + e / kB, c = j * kB + e % kB;
        if (r < n && c < n) {
          L[static_cast<size_t>(r) * n + c] = 0.f;
          LI[static_cast<size_t>(r) * n + c] = 0.f;
        }
      }
    }
  } else {
    const float nan = __int_as_float(0x7fc00000);
    for (size_t e = static_cast<size_t>(rank) * kThreads + tid; e < nn; e += static_cast<size_t>(kCluster) * kThreads) {
      L[e] = nan;
      LI[e] = nan;
    }
  }
  if (rank == 0 && tid == 0) *jit_out = jit;
  return ok;
}

}  // namespace chol_cluster
