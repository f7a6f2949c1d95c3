// K5: the streaming (left-looking, blocked) Cholesky of one N x N SPD
// matrix held in device memory.  Hopper (sm_90a) port of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_chol.py::streaming_cholesky2
// (_forward_streaming2 -> body _stream2_kernel, diagonal tiles from
// _chol_inv_rec).  The wrapper, the plain PyTorch version and the design
// notes are in nonstationary_precip_tpu_torch/ops/chol_stream.py.
//
// The matrix is padded by the wrapper to n, a multiple of kP = 256.  One C
// call runs blocked_chol.cuh's left-looking factorisation at kP = 256: for
// each block column, the update GEMM, the diagonal tile's fused (L, L^-1)
// sweep of chol_sweep.cuh (K1's and K4's) in one 1024-thread block with the
// packed triangle in shared memory (131.6 KB), and the panel GEMM.  A
// diagonal tile whose sweep fails is written as NaN, and the NaN reaches
// every later column through the updates, as the TPU kernel's factor goes
// NaN from the failing column on.

#include <cuda_runtime.h>

#include "blocked_chol.cuh"

namespace {

constexpr int kP = 256;          // panel width (the TPU kernel's p)
constexpr int kDiagThreads = 1024;

}  // namespace

extern "C" {

// a: n x n f32 row-major, n a positive multiple of kP (identity-padded by
// the caller); l: n x n output, zero-filled by the caller; cbuf: n x kP,
// ljj and linv: kP x kP f32 scratch.  Launches every kernel on `stream`
// and returns the first non-zero cudaGetLastError() as an int (0 = all
// launched).
int chol_stream(const void* a, void* l, void* cbuf, void* ljj, void* linv,
                int n, void* stream) {
  return blocked_chol::left_looking<kP, kDiagThreads, false>(
      static_cast<const float*>(a), static_cast<float*>(l), static_cast<float*>(cbuf),
      static_cast<float*>(ljj), static_cast<float*>(linv), n,
      static_cast<cudaStream_t>(stream), nullptr, nullptr);
}

}  // extern "C"
