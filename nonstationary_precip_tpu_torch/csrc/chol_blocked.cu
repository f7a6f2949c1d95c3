// K10a: the blocked Cholesky of one N x N SPD matrix with 768 <= N <= 1280.
// Hopper (sm_90a) port of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_chol.py::blocked_cholesky (body
// _chol_kernel, pallas_call in _forward).  The wrapper, the plain PyTorch
// version and the design notes are in
// nonstationary_precip_tpu_torch/ops/chol_blocked.py.
//
// The TPU kernel holds the whole matrix in VMEM; 1280^2 f32 (6.5 MB) does
// not fit in an SM's shared memory, but it fits in the 50 MB L2.  So this is
// K5's left-looking factorisation (blocked_chol.cuh) at the TPU kernel's
// own 128-wide blocks: per block column the update GEMM, the diagonal
// tile's fused (L, L^-1) sweep in one 256-thread block (the packed
// 128-triangle in shared memory, 33.5 KB), and the panel GEMM.  The matrix
// is identity-padded by the wrapper to a multiple of 128.  A diagonal tile
// whose sweep fails is NaN, and the NaN spreads to every later column.

#include <cuda_runtime.h>

#include "blocked_chol.cuh"

namespace {

constexpr int kP = 128;  // block width (the TPU kernel's BLOCK)
constexpr int kDiagThreads = 256;

}  // namespace

extern "C" {

// a: n x n f32 row-major, n a positive multiple of kP; l: n x n output,
// zero-filled by the caller; cbuf: n x kP, ljj and linv: kP x kP f32
// scratch.  Launches every kernel on `stream` and returns the first non-zero
// cudaGetLastError() as an int (0 = all launched).
int chol_blocked(const void* a, void* l, void* cbuf, void* ljj, void* linv, int n,
                 void* stream) {
  return blocked_chol::left_looking<kP, kDiagThreads, false>(
      static_cast<const float*>(a), static_cast<float*>(l), static_cast<float*>(cbuf),
      static_cast<float*>(ljj), static_cast<float*>(linv), n,
      static_cast<cudaStream_t>(stream), nullptr, nullptr);
}

}  // extern "C"
