// K9: the diagonal-Gibbs cross-Gram K(x1, l1; x2, l2), N1 x N2, written to
// device memory.  Hopper (sm_90a) port of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_gram.py::gibbs_gram_pallas (body
// _kernel, pallas_call in _forward).  The wrapper, the plain PyTorch version
// and the design notes are in nonstationary_precip_tpu_torch/ops/gibbs_gram.py.
//
// A block of 256 threads owns a kTile x kTile tile of the output.  The
// tile's row payloads (x, l) are staged in shared memory, where every
// thread of a warp reads the same address (a broadcast); each thread keeps
// one column's payload in registers and writes kTile / 4 elements of that
// column, a warp writing 32 consecutive floats of a row at a time.  Each
// element is gibbs_elem.cuh's plain formula, with no special case on the
// diagonal (the TPU kernel has none either).

#include <cuda_runtime.h>

#include <cstddef>

#include "gibbs_elem.cuh"

namespace {

using gibbs::gibbs_elem;
using gibbs::kMaxD;
using gibbs::live;

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kTile;  // threads sharing a column

template <int D>
__global__ void __launch_bounds__(kThreads)
gibbs_gram_kernel(const float* __restrict__ x1, const float* __restrict__ l1, int n1,
                  const float* __restrict__ x2, const float* __restrict__ l2, int n2,
                  int d, float* __restrict__ out) {
  __shared__ float rp[kTile][2 * D];  // row r: x then l
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTile;
  const int col = blockIdx.x * kTile + tid % kTile;
  const int rg = tid / kTile;
  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int k = e % D;
    const bool ok = r0 + r < n1 && live<D>(k, d);
    const size_t g = static_cast<size_t>(r0 + r) * d + k;
    rp[r][k] = ok ? x1[g] : 0.0f;
    rp[r][D + k] = ok ? l1[g] : 1.0f;
  }
  float xj[D], lj[D], diff[D], inv_ss[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const bool ok = col < n2 && live<D>(k, d);
    xj[k] = ok ? x2[static_cast<size_t>(col) * d + k] : 0.0f;
    lj[k] = ok ? l2[static_cast<size_t>(col) * d + k] : 1.0f;
  }
  __syncthreads();
  if (col >= n2) return;
  for (int r = rg; r < kTile && r0 + r < n1; r += kRowGroups) {
    out[static_cast<size_t>(r0 + r) * n2 + col] =
        gibbs_elem<D>(&rp[r][0], &rp[r][D], xj, lj, d, diff, inv_ss);
  }
}

template <int D>
void launch(const float* x1, const float* l1, int n1, const float* x2, const float* l2,
            int n2, int d, float* out, cudaStream_t s) {
  const dim3 grid((n2 + kTile - 1) / kTile, (n1 + kTile - 1) / kTile);
  gibbs_gram_kernel<D><<<grid, kThreads, 0, s>>>(x1, l1, n1, x2, l2, n2, d, out);
}

}  // namespace

extern "C" {

// x1, l1: n1 x d; x2, l2: n2 x d; out: n1 x n2, all f32 row-major on the
// device, 1 <= d <= 8.  One launch on `stream`; returns cudaGetLastError()
// as an int (0 = launched).
int gibbs_gram(const void* x1, const void* l1, int n1, const void* x2, const void* l2,
               int n2, int d, void* out, void* stream) {
  if (n1 < 1 || n2 < 1 || d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(x1);
  const auto* b = static_cast<const float*>(l1);
  const auto* c = static_cast<const float*>(x2);
  const auto* e = static_cast<const float*>(l2);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(a, b, n1, c, e, n2, d, o, s); break;
    case 2: launch<2>(a, b, n1, c, e, n2, d, o, s); break;
    case 3: launch<3>(a, b, n1, c, e, n2, d, o, s); break;
    default: launch<kMaxD>(a, b, n1, c, e, n2, d, o, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
