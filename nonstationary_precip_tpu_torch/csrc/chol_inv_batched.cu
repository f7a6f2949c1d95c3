// Batched (L, L^-1) of a stack of SPD matrices, with per-member escalating
// jitter.  Hopper (sm_90a) port of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_chol.py::chol_inv_batched_safe
// (body _chol_inv_b_kernel -> _chol_inv_nlevel_b).  The wrapper, the plain
// PyTorch version and the design notes are in
// nonstationary_precip_tpu_torch/ops/chol_inv.py.
//
// One thread block per matrix runs the fused right-looking sweep of
// chol_sweep.cuh, which yields L and L^-1 from one pass over one packed
// lower triangle.  The triangle lives in shared memory when it fits
// (N <= ~339 on an H100: 200 KB at N = 316), else in a global scratch slab
// that stays in the 50 MB L2.  A try that fails restarts inside the block
// from A + j I, j = base, x10, at most max_tries times, so the retry needs
// no host round trip; a member that never failed runs exactly once with
// j = 0.

#include <cuda_runtime.h>

#include <cstddef>

#include "chol_sweep.cuh"

namespace {

using chol_sweep::tri_off;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 384;

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
chol_inv_kernel(const float* __restrict__ a, float* __restrict__ l,
                float* __restrict__ li, float* __restrict__ jit_out,
                float* __restrict__ scratch, int n, float base,
                int max_tries) {
  extern __shared__ float smem[];
  __shared__ int bad;
  float* u = smem;
  float* w = kSmem ? smem + n : scratch + blockIdx.x * tri_off(n);
  const size_t nn = static_cast<size_t>(n) * n;
  const float* A = a + blockIdx.x * nn;
  float* L = l + blockIdx.x * nn;
  float* LI = li + blockIdx.x * nn;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float jit = 0.f;
  bool ok = false;
  for (int attempt = 0; attempt <= max_tries; ++attempt) {
    if (attempt > 0) jit = (jit == 0.f) ? base : jit * 10.0f;
    for (int i = warp; i < n; i += kWarps) {
      float* row = w + tri_off(i);
      const float* arow = A + static_cast<size_t>(i) * n;
      for (int j = lane; j <= i; j += 32)
        row[j] = (j == i) ? arow[j] + jit : arow[j];
    }
    if (tid == 0) bad = 0;
    __syncthreads();
    if (chol_sweep::chol_inv_sweep<kThreads, kMaxN, false>(w, u, L, LI, n,
                                                             &bad)) {
      ok = true;
      break;
    }
    __syncthreads();  // all threads have read `bad` before the next try resets it
  }

  if (!ok) chol_sweep::fill_nan<kThreads>(L, LI, nn);
  if (tid == 0) jit_out[blockIdx.x] = jit;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may opt in to on `device`.
int chol_inv_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// a, l, li: (t, n, n) f32 row-major; jit: (t,) f32; scratch: t * n(n+1)/2
// f32 when smem == 0, unused otherwise.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
int chol_inv_batched(const void* a, void* l, void* li, void* jit,
                     void* scratch, int t, int n, float base, int max_tries,
                     int smem, void* stream) {
  if (t < 1 || n < 1 || n > kMaxN || max_tries < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  float* pl = static_cast<float*>(l);
  float* pli = static_cast<float*>(li);
  float* pj = static_cast<float*>(jit);
  float* ps = static_cast<float*>(scratch);
  if (smem) {
    const size_t bytes =
        (static_cast<size_t>(n) + static_cast<size_t>(n) * (n + 1) / 2) *
        sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        chol_inv_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    chol_inv_kernel<true><<<t, kThreads, bytes, s>>>(pa, pl, pli, pj, ps, n,
                                                     base, max_tries);
  } else {
    chol_inv_kernel<false><<<t, kThreads, n * sizeof(float), s>>>(
        pa, pl, pli, pj, ps, n, base, max_tries);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
