// K1: batched (L, L^-1) of a stack of SPD matrices with per-member
// escalating jitter, for Hopper (sm_90a).  Port of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_chol.py::chol_inv_batched_safe (body
// _chol_inv_b_kernel -> _chol_inv_nlevel_b).  The wrapper, the plain
// PyTorch version and the design notes are in
// nonstationary_precip_tpu_torch/ops/chol_inv.py.
//
// One thread-block cluster of kCluster CTAs per member, one launch a call.
// The member, padded to np = 32 nb with an identity block, is kept as the
// nb (nb + 1) / 2 tiles of 32 x 32 of its lower triangle, spread over the
// cluster's shared memory: tile (i, j) at linear index t = i (i + 1) / 2 + j
// lives in CTA t % kCluster, slot t / kCluster.  A tile holds the Schur
// complement S_ij until its block column is factored, then L_ij, and from
// then on the partial forward substitution of the identity that ends as
// (L^-1)_ij: the blocked form of the fused sweep of the column kernel this
// one replaces, so one chain of nb block steps yields both L and L^-1.
// Block step k:
//  1. every CTA copies S_kk from its owner (distributed shared memory) and
//     factors it in one warp, in registers (the leaf of chol_rl.cuh: 32
//     column steps that give L_kk and X_kk = L_kk^-1 together).  The copies
//     and the code are the same in every CTA, so every CTA reaches the same
//     pivot decision without a message;
//  2. each CTA, one warp a tile it owns: the panel L_ik = S_ik L_kk^-T by
//     forward substitution against L_kk (lane r row r), and row k of L^-1,
//     X_kj = L_kk^-1 W_kj for j < k, by substitution too (lane c column c).
//     No product with an inverse tile forms L: that breaks the backward
//     error bound of the factor;                       -- cluster barrier
//  3. each CTA copies the step's operands into its own shared memory: the
//     panel transposed (buf[i] = L_ik^T, i > k), row k of L^-1 (buf[j] =
//     X_kj, j < k) and X_kk (buf[k]);                  -- cluster barrier
//  4. each CTA updates the tiles it owns below row k, a 4 x 4 FFMA register
//     micro-tile a thread, 64 threads a tile:
//         W_ij -= sum_m buf[i][m][r] buf[j][m][c]   (j != k; j < k: the
//         substitution of L^-1, j > k: the Schur update S_ij -= L_ik L_jk^T)
//         W_ik  = -sum_m buf[i][m][r] buf[k][m][c]  (L^-1's column k starts)
//     each entry's 32 products summed in ascending m, then applied once.
//                                                      -- cluster barrier
// L's tiles and L^-1's rows go to global memory as they become final; the
// upper triangles are written as zeros at the end.
// The retry: a pivot that is not > 0, or a non-finite entry of the leaf,
// fails the try at once in every CTA alike; a non-finite panel entry sets
// its CTA's flag, and the flags are OR-ed over the cluster after the last
// step.  A failed try restarts the whole cluster from A + j I, read again
// from global memory, j = base, x10, at most max_tries times; a member that
// never failed runs once with j = 0, and its bits do not depend on any
// other member.  Plain f32 FFMA, rsqrtf in the leaf, IEEE division in the
// substitutions; no tensor cores, no atomics: every run gives the same bits.
//
// What bounds it on an H100: at (10, 316) the 2 N^3 / 3 operations a member
// (0.2 GFLOP a call) would take 3 us at the f32 peak, so the chain of nb
// block steps, each a leaf, a substitution, two copies through distributed
// shared memory and three cluster barriers, sets the time.  The cluster
// spreads each step's update over kCluster SMs and keeps N = 384's 78 tiles
// on chip, where one 227 KB CTA could not hold them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#ifndef K1_CLUSTER
#define K1_CLUSTER 8
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = K1_CLUSTER;  // CTAs a member
constexpr int kB = 32;                // block width: one warp's leaf
constexpr int kLd = kB + 4;           // tile row stride: 16-byte rows
constexpr int kTile = kB * kLd;       // floats a tile slot
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 384;
constexpr int kTileThreads = 64;  // threads a tile in the update: 8 x 8, each 4 x 4
static_assert(kCluster == 1 || kCluster == 2 || kCluster == 4 || kCluster == 8, "a portable cluster size");
static_assert(kThreads % kTileThreads == 0 && kThreads == kB * kB / 4, "one float4 of a tile a thread");

__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= 3.402823466e+38f; }

__host__ __device__ __forceinline__ int num_blocks(int n) { return (n + kB - 1) / kB; }
__host__ __device__ __forceinline__ int num_tiles(int nb) { return nb * (nb + 1) / 2; }
__host__ __device__ __forceinline__ int slots(int nb) { return (num_tiles(nb) + kCluster - 1) / kCluster; }

// dynamic shared memory of a CTA: its tile slots, the operand buffer (nb
// tiles), L_kk, the leaf's two column buffers and two flags
__host__ __device__ __forceinline__ size_t smem_floats(int n) {
  const int nb = num_blocks(n);
  return static_cast<size_t>(slots(nb) + nb + 1) * kTile + 2 * kB + 4;
}

// (i, j) of the lower tile at linear index t = i (i + 1) / 2 + j
__device__ __forceinline__ void tile_of(int t, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  j = t - i * (i + 1) / 2;
}

// The padded, jittered member at (r, c): A + j I inside n, I outside.
__device__ __forceinline__ float padded(const float* A, int n, int r, int c, float jit) {
  if (r < n && c < n) return A[static_cast<size_t>(r) * n + c] + (r == c ? jit : 0.f);
  return r == c ? 1.f : 0.f;
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
// v_m = (v_m - sum_{p < m} L[m][p] v_p) / L[m][m], the sum in ascending p.
// Lane-private; L read as warp-wide broadcasts.
__device__ __forceinline__ void substitute(const float* L, float (&v)[kB]) {
#pragma unroll
  for (int m = 0; m < kB; ++m) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < m; ++p) s = fmaf(L[m * kLd + p], v[p], s);
    v[m] = (v[m] - s) / L[m * kLd + m];
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

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
chol_inv_cluster_kernel(const float* __restrict__ a, float* __restrict__ l, float* __restrict__ li,
                        float* __restrict__ jit_out, int n, float base, int max_tries) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int member = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = num_blocks(n);
  const int ntiles = num_tiles(nb);
  const int nown = (ntiles - rank + kCluster - 1) / kCluster;  // tiles t = rank + s kCluster

  extern __shared__ __align__(16) float smem[];
  float* W = smem;                         // slots(nb) tiles
  float* buf = W + slots(nb) * kTile;      // nb operand tiles
  float* D = buf + nb * kTile;             // S_kk, then L_kk
  float* col = D + kTile;                  // the leaf's column buffers
  int* flags = reinterpret_cast<int*>(col + 2 * kB);  // [0] a non-finite panel entry, [1] the leaf failed

  const size_t nn = static_cast<size_t>(n) * n;
  const float* A = a + member * nn;
  float* L = l + member * nn;
  float* LI = li + member * nn;
  // the tile (i, j), wherever in the cluster it lives
  auto tile = [&](int i, int j) {
    const int t = i * (i + 1) / 2 + j;
    return cluster.map_shared_rank(W + (t / kCluster) * kTile, t % kCluster);
  };

  float jit = 0.f;
  bool ok = false;
  for (int attempt = 0; attempt <= max_tries; ++attempt) {
    if (attempt > 0) jit = (jit == 0.f) ? base : jit * 10.0f;
    for (int s = 0; s < nown; ++s) {
      int i, j;
      tile_of(rank + s * kCluster, i, j);
      for (int e = tid; e < kB * kB; e += kThreads) {
        const int r = e / kB, c = e % kB;
        W[s * kTile + r * kLd + c] = padded(A, n, i * kB + r, j * kB + c, jit);
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
      if (warp == 0) leaf(D, buf + k * kTile, col, &flags[1]);
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
        float* T = W + s * kTile;
        float v[kB];
        if (panel) {
#pragma unroll
          for (int m = 0; m < kB; ++m) v[m] = T[lane * kLd + m];
        } else {
#pragma unroll
          for (int m = 0; m < kB; ++m) v[m] = T[m * kLd + lane];
        }
        substitute(D, v);
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
      //    (j < k), buf[i] = L_ik^T (i > k); buf[k] = X_kk from the leaf
      for (int s = 0; s < nb; ++s) {
        if (s == k) continue;
        const int r = tid / 8, q = tid % 8;
        float* B = buf + s * kTile;
        if (s < k) {
          const float* src = tile(k, s);
          *reinterpret_cast<float4*>(B + r * kLd + 4 * q) = *reinterpret_cast<const float4*>(src + r * kLd + 4 * q);
        } else {
          const float* src = tile(s, k);
          const float4 v = *reinterpret_cast<const float4*>(src + r * kLd + 4 * q);
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
  if (rank == 0 && tid == 0) jit_out[member] = jit;
}

}  // namespace

extern "C" {

// CTAs a member (the cluster size this library was built with).
int chol_inv_cluster_size() { return kCluster; }

// Dynamic shared memory a CTA takes at this N.
int chol_inv_cluster_smem(int n) { return static_cast<int>(smem_floats(n) * sizeof(float)); }

// Largest dynamic shared memory one block may opt in to on `device`.
int chol_inv_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  return v;
}

// Clusters of this kernel that fit on the card at once at this N
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
int chol_inv_max_clusters(int n) {
  const int bytes = chol_inv_cluster_smem(n);
  cudaError_t e = cudaFuncSetAttribute(chol_inv_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, chol_inv_cluster_kernel, &cfg);
  return e == cudaSuccess ? count : -static_cast<int>(e);
}

// a, l, li: (t, n, n) f32 row-major; jit: (t,) f32.  One launch of t
// clusters on `stream`; returns the launch's error as an int (0 = launched).
int chol_inv_cluster(const void* a, void* l, void* li, void* jit, int t, int n, float base, int max_tries,
                     void* stream) {
  if (t < 1 || n < 1 || n > kMaxN || max_tries < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = chol_inv_cluster_smem(n);
  cudaError_t e = cudaFuncSetAttribute(chol_inv_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  chol_inv_cluster_kernel<<<t * kCluster, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(l), static_cast<float*>(li), static_cast<float*>(jit), n,
      base, max_tries);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
