// K1: batched (L, L^-1) of a stack of SPD matrices with per-member
// escalating jitter, for Hopper (sm_90a).  Port of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_chol.py::chol_inv_batched_safe (body
// _chol_inv_b_kernel -> _chol_inv_nlevel_b).  The wrapper, the plain
// PyTorch version and the design notes are in
// nonstationary_precip_tpu_torch/ops/chol_inv.py.
//
// One thread-block cluster of kCluster CTAs per member, one launch a call,
// on the block-step machinery of chol_inv_cluster.cuh (shared with K4): the
// member, padded to a multiple of 32 with an identity block, is read into
// the cluster's tiles from global memory as A + j I, and the retry ladder
// is j = base, x10, at most max_tries times after the first, jitter-free
// try.  With max_tries = 0 it is also K10b (pallas_chol.py::chol_inv_batched,
// the retry-free grid-batched (L, L^-1)): one jitter-free try, a member
// whose try fails left NaN, each member its own cluster.
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

#include "chol_inv_cluster.cuh"

#ifndef K1_CLUSTER
#define K1_CLUSTER 8
#endif

namespace cg = cooperative_groups;

namespace {

using chol_cluster::kThreads;

constexpr int kCluster = K1_CLUSTER;  // CTAs a member
// K10b's window top (the JAX MAX_N_CHOLINV); K1's wrapper keeps its gate's
// 384.  At 512 and a cluster of 8 a CTA takes 157 KB (a cluster of 4: 235 KB,
// over the 227 KB a block may opt in to).
constexpr int kMaxN = 512;
static_assert(kCluster == 1 || kCluster == 2 || kCluster == 4 || kCluster == 8, "a portable cluster size");

// K1's tiles and ladder: the padded, jittered member A + j I inside n, I
// outside; j = 0, then base, x10 per try.
struct PaddedSource {
  static constexpr bool kRecip = false;
  const float* A;
  int n;
  float base;
  int max_tries;
  __device__ int tries() const { return max_tries + 1; }
  __device__ float jitter(float prev, int attempt) const {
    return attempt == 0 ? 0.f : (prev == 0.f ? base : prev * 10.0f);
  }
  __device__ float entry(int r, int c, int, float jit) const {
    if (r < n && c < n) return A[static_cast<size_t>(r) * n + c] + (r == c ? jit : 0.f);
    return r == c ? 1.f : 0.f;
  }
};

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
chol_inv_cluster_kernel(const float* __restrict__ a, float* __restrict__ l, float* __restrict__ li,
                        float* __restrict__ jit_out, int n, float base, int max_tries) {
  cg::cluster_group cluster = cg::this_cluster();
  const int member = blockIdx.x / kCluster;
  extern __shared__ __align__(16) float smem[];
  const size_t nn = static_cast<size_t>(n) * n;
  const PaddedSource src{a + member * nn, n, base, max_tries};
  chol_cluster::factor<kCluster>(cluster, smem, src, n, l + member * nn, li + member * nn, jit_out + member);
}

}  // namespace

extern "C" {

// CTAs a member (the cluster size this library was built with).
int chol_inv_cluster_size() { return kCluster; }

// Dynamic shared memory a CTA takes at this N.
int chol_inv_cluster_smem(int n) {
  return static_cast<int>(chol_cluster::factor_floats<kCluster>(n) * sizeof(float));
}

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
