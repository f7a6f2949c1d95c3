// K10c: the v1 streaming Cholesky of one N x N SPD matrix held in device
// memory, N <= 8192.  Hopper (sm_90a) kernel in place of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_chol.py::streaming_cholesky
// (_forward_streaming -> body _stream_kernel), which K5 (chol_stream.cu)
// superseded on the TPU.  The wrapper, the plain PyTorch version and the
// design notes are in nonstationary_precip_tpu_torch/ops/chol_stream.py.
//
// K10c computes K5's function: the lower factor of one matrix padded to a
// multiple of the TPU kernel's 256-wide panels.  So it is K5's design,
// chol_rl.cuh's right-looking factorisation in place on the factor at
// 128-wide tiles: per block column the diagonal tile (one CTA, recursive
// 2 x 2 blocking in shared memory down to one-warp leaves), the panel by
// blocked forward substitution against L_jj, and the trailing update as one
// CTA per lower 128 x 128 tile (f32 FFMA micro-tiles over a cp.async ring).
// What bounds it on an H100 is the N^3/3 f32 FFMA operations of the trailing
// updates (2.7 ms at N = 8192), then the chain of N / 128 diagonal tiles;
// with look-ahead each block column's first update, diagonal tile and panel
// run on a second stream while the rest of the previous column's update
// runs, so the chain hides behind the updates: 4 N / 128 - 4 CUDA launches a
// call (252 at N = 8192).  Without look-ahead (factor<false>: 3 N / 128 - 2
// launches, every kernel on the caller's stream) the same factor took 22 %
// longer at N = 8192 and as long at 4096 (tools/bench_chol_rl.py on an H100;
// PERF.md), so K10c looks ahead, as K5 does.  A diagonal tile
// that fails is written as NaN, and the NaN reaches every later column
// through the updates, as the TPU kernel's factor goes NaN from the failing
// column on.

#include <cuda_runtime.h>

#include "chol_rl.cuh"

namespace {

constexpr bool kLookAhead = true;  // the faster schedule at N = 8192

}  // namespace

extern "C" {

// l: the n x n working matrix, row-major, n a positive multiple of 128: the
// lower triangle of the identity-padded matrix, zeros above, factored in
// place.  Launches every kernel on `stream` (and on a second stream that
// `stream` waits for) and returns the first non-zero CUDA error as an int
// (0 = all launched).
int chol_stream_v1(void* l, int n, void* stream) {
  return chol_rl::factor<kLookAhead>(static_cast<float*>(l), n, static_cast<cudaStream_t>(stream));
}

// Registers, local (spill) bytes, static and dynamic shared memory of the
// diagonal-tile, panel, column-update and triangle-update kernels into
// out[16].
int chol_stream_v1_attributes(int* out) { return chol_rl::attributes<kLookAhead>(out); }

}  // extern "C"
