// K10a: the blocked Cholesky of one N x N SPD matrix with 768 <= N <= 1280.
// Hopper (sm_90a) kernel in place of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_chol.py::blocked_cholesky (body
// _chol_kernel, pallas_call in _forward).  The wrapper, the plain PyTorch
// version and the design notes are in
// nonstationary_precip_tpu_torch/ops/chol_blocked.py.
//
// The TPU kernel holds the whole matrix in VMEM and factors it right-looking
// at 128-wide blocks.  1280^2 f32 (6.5 MB) does not fit in an SM's shared
// memory but fits in the 50 MB L2, so K10a runs chol_rl.cuh's right-looking
// factorisation in place on the factor, at the same 128-wide tiles as K5:
// per block column the diagonal tile (one CTA, recursive 2 x 2 blocking in
// shared memory), the panel through L_jj^-1 and the tiled trailing update,
// in turn on one stream (factor<false>), 3 N / 128 - 2 CUDA launches a call
// (28 at N = 1280).  What bounds it on an H100 is the chain of N / 128
// diagonal tiles, each on one SM, and of single-wave tile kernels: the
// N^3/3 operations take 10 us at the card's f32 rate.  Look-ahead does not
// pay at these sizes: the trailing update of one column is a single wave,
// no longer than the diagonal tile it would hide, and the second stream's
// events add their own latency.  A diagonal tile that fails is NaN, and the
// NaN spreads to every later column.

#include <cuda_runtime.h>

#include "chol_rl.cuh"

extern "C" {

// l: the n x n working matrix, row-major, n a positive multiple of 128: the
// lower triangle of the identity-padded matrix, zeros above, factored in
// place.  Launches every kernel on `stream` (and, with look-ahead, on a
// second stream that `stream` waits for) and returns the first non-zero
// CUDA error as an int (0 = all launched).
int chol_blocked(void* l, int n, void* stream) {
  return chol_rl::factor<false>(static_cast<float*>(l), n, static_cast<cudaStream_t>(stream));
}

// Registers, local (spill) bytes, static and dynamic shared memory of the
// diagonal-tile, panel and trailing-update kernels into out[12].
int chol_blocked_attributes(int* out) { return chol_rl::attributes<false>(out); }

}  // extern "C"
