// K4: the whitened-SVGP K_zz precompute of every output dim of every layer
// (and every split) in one call: K = s2 RBF(z / ell) + eps I, its factor L
// and L^-1 with K4's own jitter retry, and W = L^-T P.  Hopper (sm_90a)
// port of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_svgp.py::svgp_precompute_fused
// (body _svgp_kernel).  The wrapper, the plain PyTorch version and the
// design notes are in nonstationary_precip_tpu_torch/ops/svgp_precompute.py.
//
// One launch a call: one thread-block cluster of kCluster CTAs a member.
//  1. The factor, on K1's block-step machinery (chol_inv_cluster.cuh):
//     every CTA stages z / ell and the squared norms of the whole member in
//     its shared memory, and builds the Gram tiles it owns in place, with
//     explicit roundings (no contraction into FMA, IEEE division, expf), the
//     diagonal exactly s2 + eps; the member is padded to a multiple of 32
//     with an identity block, and K_zz never reaches device memory.  K4's
//     ladder: a try whose L or L^-1 is not finite is rebuilt with 1e-4 more
//     on the diagonal, then a further 1e-2, at most 3 tries, the diagonal
//     accumulating in f32 as ((s2 + eps) + 1e-4) + 1e-2.  Healthy members
//     run once and keep their exact factors; a member whose every try fails
//     comes back NaN in L, L^-1 and W.
//  2. W = L^-T P in the cluster's tail: after the last block step the
//     cluster's shared memory holds every tile of L^-1.  P's columns are cut
//     into chunks of kWC, chunk q to CTA q % kCluster.  For each 32-row
//     block k of P, in ascending order, the CTA copies row k of L^-1's
//     tiles, (k, i) for i <= k, from their owners (distributed shared
//     memory), P's block comes in by cp.async a block ahead, and every
//     block row i <= k of W takes its 32 products: each thread keeps a
//     4 x 2 register micro-tile in each of kRowGroup block rows of W (two
//     passes at M = 250), so each output is a sum over k in ascending
//     order, with no atomics.  L^-1 is not read back from device memory.
// The retry tests L and L^-1: with a finite P, a finite L^-1 gives a finite
// W, and W's identity block is L^-T itself, so this is the TPU kernel's "L
// and W finite" test for the packed [m | tril(S) | I] the model passes.
// Plain f32 throughout (rsqrtf in the leaf, the IEEE reciprocal of the
// diagonal in the substitutions), no tensor cores; every run gives the same
// bits.
//
// What bounds it on an H100: at (50, 250, D 2, P 501) the ~2.1 GFLOP of a
// call would take ~0.03 ms at the f32 peak, but each member's factor is a
// chain of nb = 8 dependent block steps (leaf, substitution, copies and
// three cluster barriers each).  The cluster spreads a member's steps over
// kCluster SMs; the cluster size and the CTAs an SM (registers) are chosen
// by measurement (tools/bench_k4.py), so that the 50 clusters of the path
// run in one wave.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "chol_inv_cluster.cuh"

#ifndef K4_CLUSTER
#define K4_CLUSTER 4
#endif
#ifndef K4_MIN_BLOCKS
#define K4_MIN_BLOCKS 2
#endif

namespace cg = cooperative_groups;

namespace {

using chol_cluster::kB;
using chol_cluster::kLd;
using chol_cluster::kThreads;
using chol_cluster::kTile;

constexpr int kCluster = K4_CLUSTER;     // CTAs a member
constexpr int kMinBlocks = K4_MIN_BLOCKS;  // CTAs an SM the registers must fit
constexpr int kMaxM = 256;
constexpr int kMaxD = 8;
constexpr int kTries = 3;
constexpr int kWC = 64;  // W columns a tail chunk: 32 rows x 64 columns, 4 x 2 a thread
constexpr int kRowGroup = 4;  // W's block rows a pass of the tail keeps in registers
static_assert(kCluster == 1 || kCluster == 2 || kCluster == 4 || kCluster == 8, "a portable cluster size");
static_assert(kThreads == (kB / 4) * (kWC / 2), "one 4 x 2 micro-tile of the 32 x kWC output a thread");

__host__ __device__ constexpr size_t pad4(size_t n) { return (n + 3) / 4 * 4; }

// Shared memory of a CTA in floats: the factor's, z / ell and the squared
// norms (m d + m, padded to 16 bytes), and the tail's two P stages.
__host__ __device__ size_t smem_floats(int m, int d) {
  return chol_cluster::factor_floats<kCluster>(m) + pad4(static_cast<size_t>(m) * d + m) + 2 * kB * kWC;
}

// K4's Gram tiles and ladder.  Entry (r, c) of try a: s2 exp(-q / 2) with
// q = (|z_r|^2 + |z_c|^2) - 2 z_r . z_c clamped at 0 off the diagonal (the
// same bits for (r, c) and (c, r)), ((s2 + eps) + 1e-4) + 1e-2 up to try a
// on it, and I past m.  The substitutions multiply by the diagonal's
// reciprocal, which takes 32 dependent divisions off each tile's chain.
struct GramSource {
  static constexpr bool kRecip = true;
  const float* zs;  // z / ell, (m, d)
  const float* sq;  // |z / ell|^2, (m,)
  int m, d;
  float s2, eps;
  __device__ int tries() const { return kTries; }
  __device__ float jitter(float, int attempt) const {
    return attempt == 0 ? 0.f : (attempt == 1 ? 1e-4f : 1e-4f + 1e-2f);
  }
  __device__ float entry(int r, int c, int attempt, float) const {
    if (r >= m || c >= m) return r == c ? 1.f : 0.f;
    if (r == c) {
      float dg = s2 + eps;
      if (attempt >= 1) dg = dg + 1e-4f;
      if (attempt >= 2) dg = dg + 1e-2f;
      return dg;
    }
    const float* zr = zs + r * d;
    const float* zc = zs + c * d;
    float cross = 0.f;
    for (int k = 0; k < d; ++k) cross = __fadd_rn(cross, __fmul_rn(zr[k], zc[k]));
    const float q = __fsub_rn(__fadd_rn(sq[r], sq[c]), __fmul_rn(2.0f, cross));
    return __fmul_rn(s2, expf(__fmul_rn(-0.5f, fmaxf(q, 0.f))));
  }
};

// 4-byte cp.async into shared memory; a copy that is not valid zero-fills
// (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The tail: W[i, c] = sum_{k >= i} L^-1[k, i] P[k, c] for this CTA's chunks
// of columns, from the L^-1 tiles in the cluster's slots (`slots`: this
// CTA's first).  tb: kRowGroup tiles of this CTA's shared memory (the
// factor's operand buffer, free now); pb: two stages of 32 x kWC.
__device__ void w_tail(cg::cluster_group& cluster, float* slots, float* tb, float* pb, const float* __restrict__ P,
                       float* __restrict__ Wm, int m, int p) {
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int nb = chol_cluster::num_blocks(m);
  const int nchunks = (p + kWC - 1) / kWC;
  const int rg = tid % (kB / 4), cq = tid / (kB / 4);  // rows 4 rg .. +3, columns 2 cq, 2 cq + 1
  for (int q = rank; q < nchunks; q += kCluster) {
    const int c0 = q * kWC;
    // P's rows [32 kb, 32 kb + 32) of the chunk into stage b; rows past m
    // and columns past p zero
    auto stage = [&](int kb, int b) {
      float* dst = pb + b * (kB * kWC);
      for (int e = tid; e < kB * kWC; e += kThreads) {
        const int row = kb * kB + e / kWC, c = c0 + e % kWC;
        const bool ok = row < m && c < p;
        cp_async4(dst + e, ok ? P + static_cast<size_t>(row) * p + c : P, ok);
      }
      cp_async_commit();
    };
    // W's block rows in groups of kRowGroup (the accumulators of one
    // group in registers): group g0 takes P's blocks kb >= g0
    for (int g0 = 0; g0 < nb; g0 += kRowGroup) {
      float acc[kRowGroup][4][2];
#pragma unroll
      for (int g = 0; g < kRowGroup; ++g)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[g][x][0] = acc[g][x][1] = 0.f;
      __syncthreads();  // every thread is done with the last pass's tb and pb
      stage(g0, 0);
      for (int kb = g0; kb < nb; ++kb) {
        {
          // the tiles (kb, g0 + g), g0 + g <= kb, of row kb of L^-1 into
          // tb[g]: the remote loads first, then the stores
          const int r = tid / 8, c4 = tid % 8;
          float4 v[kRowGroup];
#pragma unroll
          for (int g = 0; g < kRowGroup; ++g)
            if (g0 + g <= kb)
              v[g] = *reinterpret_cast<const float4*>(chol_cluster::tile_ptr<kCluster>(cluster, slots, kb, g0 + g) +
                                                      r * kLd + 4 * c4);
#pragma unroll
          for (int g = 0; g < kRowGroup; ++g)
            if (g0 + g <= kb) *reinterpret_cast<float4*>(tb + g * kTile + r * kLd + 4 * c4) = v[g];
        }
        cp_async_wait_all();
        __syncthreads();  // row kb's tiles and P's block kb are in
        if (kb + 1 < nb) stage(kb + 1, (kb + 1 - g0) & 1);
        const float* Pk = pb + ((kb - g0) & 1) * (kB * kWC) + 2 * cq;
#pragma unroll 4
        for (int k = 0; k < kB; ++k) {
          const float2 b = *reinterpret_cast<const float2*>(Pk + k * kWC);
#pragma unroll
          for (int g = 0; g < kRowGroup; ++g) {
            if (g0 + g <= kb) {
              const float4 a = *reinterpret_cast<const float4*>(tb + g * kTile + k * kLd + 4 * rg);
              const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                acc[g][x][0] = fmaf(av[x], b.x, acc[g][x][0]);
                acc[g][x][1] = fmaf(av[x], b.y, acc[g][x][1]);
              }
            }
          }
        }
        __syncthreads();  // every thread is done with tb and block kb's stage
      }
#pragma unroll
      for (int g = 0; g < kRowGroup; ++g) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = (g0 + g) * kB + 4 * rg + x;
          const int c = c0 + 2 * cq;
          if (g0 + g < nb && i < m) {
            if (c < p) Wm[static_cast<size_t>(i) * p + c] = acc[g][x][0];
            if (c + 1 < p) Wm[static_cast<size_t>(i) * p + c + 1] = acc[g][x][1];
          }
        }
      }
    }
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, kMinBlocks)
svgp_cluster_kernel(const float* __restrict__ z, const float* __restrict__ ell, const float* __restrict__ s2,
                    const float* __restrict__ packed, float* __restrict__ l, float* __restrict__ w,
                    float* __restrict__ li, float* __restrict__ jit_out, int m, int d, int p, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int nb = chol_cluster::num_blocks(m);
  extern __shared__ __align__(16) float smem[];
  float* zs = smem + chol_cluster::factor_floats<kCluster>(m);
  float* sq = zs + m * d;
  float* pb = zs + pad4(static_cast<size_t>(m) * d + m);
  const size_t mm = static_cast<size_t>(m) * m;
  const size_t mp = static_cast<size_t>(m) * p;

  const float* Z = z + static_cast<size_t>(b) * m * d;
  for (int e = tid; e < m * d; e += kThreads) zs[e] = Z[e] / ell[b * d + e % d];
  __syncthreads();
  for (int i = tid; i < m; i += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = __fadd_rn(acc, __fmul_rn(zs[i * d + k], zs[i * d + k]));
    sq[i] = acc;
  }
  __syncthreads();

  const GramSource src{zs, sq, m, d, s2[b], eps};
  const bool ok = chol_cluster::factor<kCluster>(cluster, smem, src, m, l + b * mm, li + b * mm, jit_out + b);
  float* slots = smem;
  float* tb = smem + chol_cluster::slots<kCluster>(nb) * kTile;  // the operand buffer
  if (ok) {
    w_tail(cluster, slots, tb, pb, packed + b * mp, w + b * mp, m, p);
  } else {
    const float nan = __int_as_float(0x7fc00000);
    for (size_t e = static_cast<size_t>(rank) * kThreads + tid; e < mp; e += static_cast<size_t>(kCluster) * kThreads)
      w[b * mp + e] = nan;
  }
  cluster.sync();  // no CTA leaves while another still reads its slots
}

}  // namespace

extern "C" {

// CTAs a member (the cluster size this library was built with).
int svgp_cluster_size() { return kCluster; }

// Dynamic shared memory a CTA takes at (m, d).
int svgp_smem_bytes(int m, int d) { return static_cast<int>(smem_floats(m, d) * sizeof(float)); }

// Largest dynamic shared memory one block may opt in to on `device`.
int svgp_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  return v;
}

// Clusters of the kernel that fit on the card at once at (m, d)
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
int svgp_max_clusters(int m, int d) {
  const int bytes = svgp_smem_bytes(m, d);
  cudaError_t e = cudaFuncSetAttribute(svgp_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, svgp_cluster_kernel, &cfg);
  return e == cudaSuccess ? count : -static_cast<int>(e);
}

// z (t, m, d), ell (t, d), s2 (t,), packed (t, m, p) f32 row-major in;
// l, li (t, m, m), w (t, m, p), jit (t,) f32 out; eps is the base diagonal
// jitter (the wrapper passes EPSILON of utils/config.py).  One launch of t
// clusters on `stream`; returns the launch's error as an int (0 =
// launched).
int svgp_precompute(const void* z, const void* ell, const void* s2, const void* packed, void* l, void* w, void* li,
                    void* jit, int t, int m, int d, int p, float eps, void* stream) {
  if (t < 1 || t > 65535 || m < 1 || m > kMaxM || d < 1 || d > kMaxD || p < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = svgp_smem_bytes(m, d);
  cudaError_t e = cudaFuncSetAttribute(svgp_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  svgp_cluster_kernel<<<t * kCluster, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(ell), static_cast<const float*>(s2),
      static_cast<const float*>(packed), static_cast<float*>(l), static_cast<float*>(w), static_cast<float*>(li),
      static_cast<float*>(jit), m, d, p, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
