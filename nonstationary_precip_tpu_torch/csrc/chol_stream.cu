// K5: the streaming Cholesky of one N x N SPD matrix held in device memory,
// 6144 <= N <= 8192.  Hopper (sm_90a) kernel in place of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_chol.py::streaming_cholesky2
// (_forward_streaming2 -> body _stream2_kernel, diagonal tiles from
// _chol_inv_rec).  The wrapper, the plain PyTorch version and the design
// notes are in nonstationary_precip_tpu_torch/ops/chol_stream.py.
//
// The TPU kernel is left-looking because the TPU runs one grid step at a
// time and streams its operands through VMEM; on an H100 the work has to
// spread over 132 SMs.  So K5 runs chol_rl.cuh's right-looking
// factorisation in place on the factor, at 128-wide tiles (the wrapper pads
// to a multiple of the TPU kernel's 256-wide panels): per block column the
// diagonal tile (one CTA, recursive 2 x 2 blocking in shared memory, as
// _chol_inv_rec), the panel through L_jj^-1, and the trailing update as one
// CTA per 128 x 128 lower tile (2016 at the first column of N = 8192).
// What bounds it on an H100 is the N^3/3 f32 FFMA operations of the
// trailing updates (2.7 ms at 67 TFLOP/s), then the chain of N / 128
// diagonal tiles; with look-ahead (factor<true>) each block column's first
// update, diagonal tile and panel run on a second stream while the rest of
// the previous column's trailing update runs, 4 N / 128 - 4 CUDA launches a
// call (252 at N = 8192).  A diagonal
// tile that fails is written as NaN, and the NaN reaches every later column
// through the updates, as the TPU kernel's factor goes NaN from the failing
// column on.

#include <cuda_runtime.h>

#include "chol_rl.cuh"

extern "C" {

// l: the n x n working matrix, row-major, n a positive multiple of 128: the
// lower triangle of the identity-padded matrix, zeros above, factored in
// place.  Launches every kernel on `stream` (and, with look-ahead, on a
// second stream that `stream` waits for) and returns the first non-zero
// CUDA error as an int (0 = all launched).
int chol_stream(void* l, int n, void* stream) {
  return chol_rl::factor<true>(static_cast<float*>(l), n, static_cast<cudaStream_t>(stream));
}

// Registers, local (spill) bytes, static and dynamic shared memory of the
// diagonal-tile, panel, column-update and triangle-update kernels into
// out[16].
int chol_stream_attributes(int* out) { return chol_rl::attributes<true>(out); }

}  // extern "C"
