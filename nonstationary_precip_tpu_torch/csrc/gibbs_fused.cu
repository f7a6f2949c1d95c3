// K8: (L, alpha) with L = chol(s2 K_gibbs(x, l) + noise I) and
// alpha = L^-1 y, the Gram never leaving the card between its build and its
// factorisation, with an escalating-jitter ladder on the device.  Hopper
// (sm_90a) port of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_fused.py::gibbs_chol_solve_fused (body
// _fused_kernel, pallas_call in _forward).  The wrapper, the plain PyTorch
// version and the design notes are in
// nonstationary_precip_tpu_torch/ops/gibbs_fused.py.
//
// One C call puts three attempts on the stream, with extra jitter 0, 1e-4
// and 1e-2 added to the noise.  Each attempt is:
//  1. build_kernel: the 128-blocks on and below the diagonal of
//     s2 K + (noise + extra) I straight into the n_pad x n_pad output L, in
//     64 x 64 tiles of gibbs_elem.cuh's element, the diagonal written exactly
//     as s2 + (noise + extra) (the TPU kernel's closed form); the padded rows
//     and columns (i or j >= N) are the identity, so they stay uncoupled;
//     nothing right of the diagonal blocks (the caller's zeros); alpha = y,
//     zero-padded;
//  2. chol_rl.cuh's right-looking factorisation of L in place (K10a's
//     schedule, factor<false>: per block column the diagonal tile, the panel
//     and the trailing update), with K8's hooks: alpha_j = L_jj^-1 alpha_j by
//     substitution in each diagonal tile, alpha_rows -= X alpha_j in each
//     panel, and state[1] = 1 from a diagonal tile that failed;
//  3. commit_kernel: if no attempt has succeeded yet, no tile failed and
//     alpha is finite, state[0] = attempt + 1; state[1] = 0.
// A non-finite entry anywhere in the lower triangle reaches a later
// diagonal tile (a panel row i feeds the (i, i) entry of its block's tile
// through the trailing update), so the tiles' flag and alpha's n entries
// decide an attempt without reading L again
// (tests/test_torch_gibbs_fused_rl.py shows it on the schedule's replay).
// Every kernel of attempts 2 and 3 reads state[0] first and returns at once
// when it is set: no host round trip, and 2 (3 N / 128) empty launches on
// the happy path (the TPU kernel's pl.when).  If all three fail, L and
// alpha hold the last attempt's non-finite result and state[0] is 0.  What
// bounds it on an H100 is chol_rl.cuh's chain of N / 128 diagonal tiles and
// single-wave updates, as in K10a: the N^3/3 operations take 5 us at the
// card's f32 rate.

#include <cuda_runtime.h>

#include <cstddef>

#include "chol_rl.cuh"
#include "gibbs_elem.cuh"

namespace {

using gibbs::gibbs_elem;
using gibbs::kMaxD;
using gibbs::live;

constexpr int kP = chol_rl::kT;  // factorisation block
constexpr int kTile = 64;        // build tile
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kTile;
constexpr int kCommitThreads = 1024;
constexpr float kExtra[3] = {0.0f, 1e-4f, 1e-2f};  // pallas_fused.py:184-199

template <int D>
__global__ void __launch_bounds__(kThreads)
build_kernel(const float* __restrict__ x, const float* __restrict__ l, int n, int d,
             const float* __restrict__ y, const float* __restrict__ s2p,
             const float* __restrict__ noisep, float extra, float* __restrict__ L,
             float* __restrict__ alpha, int n_pad, const int* __restrict__ state) {
  // done, or a tile right of the diagonal 128-blocks (never read)
  if (*state != 0 || blockIdx.x * kTile / kP > blockIdx.y * kTile / kP) return;
  __shared__ float rp[kTile][2 * D];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTile;
  const int col = blockIdx.x * kTile + tid % kTile;
  const int rg = tid / kTile;
  const float s2 = *s2p;
  const float diag = s2 + (*noisep + extra);
  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int k = e % D;
    const bool ok = r0 + r < n && live<D>(k, d);
    const size_t g = static_cast<size_t>(r0 + r) * d + k;
    rp[r][k] = ok ? x[g] : 0.0f;
    rp[r][D + k] = ok ? l[g] : 1.0f;
  }
  float xj[D], lj[D], diff[D], inv_ss[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const bool ok = col < n && live<D>(k, d);
    xj[k] = ok ? x[static_cast<size_t>(col) * d + k] : 0.0f;
    lj[k] = ok ? l[static_cast<size_t>(col) * d + k] : 1.0f;
  }
  if (blockIdx.x == blockIdx.y && tid < kTile) {
    alpha[r0 + tid] = r0 + tid < n ? y[r0 + tid] : 0.0f;
  }
  __syncthreads();
  for (int r = rg; r < kTile; r += kRowGroups) {
    const int row = r0 + r;
    float v;
    if (row >= n || col >= n) {
      v = row == col ? 1.0f : 0.0f;
    } else if (row == col) {
      v = diag;
    } else {
      v = s2 * gibbs_elem<D>(&rp[r][0], &rp[r][D], xj, lj, d, diff, inv_ss);
    }
    L[static_cast<size_t>(row) * n_pad + col] = v;
  }
}

// One block: the attempt holds if no diagonal tile failed (state[1]) and
// alpha's n entries are finite.
__global__ void __launch_bounds__(kCommitThreads)
commit_kernel(const float* __restrict__ alpha, int n, int* state, int attempt) {
  if (state[0] != 0) return;
  __shared__ int bad;
  if (threadIdx.x == 0) bad = state[1];
  __syncthreads();
  bool b = false;
  for (int i = threadIdx.x; i < n; i += kCommitThreads) b |= !chol_rl::finite(alpha[i]);
  if (b) bad = 1;  // every writer stores the same value
  __syncthreads();
  if (threadIdx.x == 0) {
    if (bad == 0) state[0] = attempt + 1;
    state[1] = 0;
  }
}

template <int D>
int run(const float* x, const float* l, int n, int d, const float* y, const float* s2,
        const float* noise, float* L, float* alpha, int* state, int n_pad, cudaStream_t s) {
  const int tiles = n_pad / kTile;
  cudaError_t e;
  for (int attempt = 0; attempt < 3; ++attempt) {
    build_kernel<D><<<dim3(tiles, tiles), kThreads, 0, s>>>(x, l, n, d, y, s2, noise, kExtra[attempt],
                                                            L, alpha, n_pad, state);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    const int err = chol_rl::factor<false, true>(L, n_pad, s, chol_rl::Rhs{alpha, state});
    if (err != 0) return err;
    commit_kernel<<<1, kCommitThreads, 0, s>>>(alpha, n_pad, state, attempt);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

extern "C" {

// x, l: n x d (1 <= d <= 8); y: n; s2, noise: one float each; all f32 on the
// device.  n_pad: n rounded up to a multiple of 128.  Outputs: L n_pad x
// n_pad (zero-filled by the caller: nothing writes right of its diagonal
// 128-blocks), alpha n_pad; state: two ints set to 0 by the caller
// (state[0] on return to the host: 1 + the attempt that succeeded, 0 if
// none did).  Launches every kernel on `stream` and returns the first
// non-zero CUDA error as an int (0 = all launched).
int gibbs_fused(const void* x, const void* l, int n, int d, const void* y, const void* s2,
                const void* noise, void* lout, void* alpha, void* state, int n_pad, void* stream) {
  if (n < 1 || d < 1 || d > kMaxD || n_pad < n || n_pad % kP != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* lf = static_cast<const float*>(l);
  const auto* yf = static_cast<const float*>(y);
  const auto* s2f = static_cast<const float*>(s2);
  const auto* nf = static_cast<const float*>(noise);
  auto* L = static_cast<float*>(lout);
  auto* al = static_cast<float*>(alpha);
  auto* st = static_cast<int*>(state);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return run<1>(xf, lf, n, d, yf, s2f, nf, L, al, st, n_pad, s);
    case 2: return run<2>(xf, lf, n, d, yf, s2f, nf, L, al, st, n_pad, s);
    case 3: return run<3>(xf, lf, n, d, yf, s2f, nf, L, al, st, n_pad, s);
    default: return run<kMaxD>(xf, lf, n, d, yf, s2f, nf, L, al, st, n_pad, s);
  }
}

// Registers, local (spill) bytes, static and dynamic shared memory of the
// diagonal-tile, panel and trailing-update kernels into out[12].
int gibbs_fused_attributes(int* out) { return chol_rl::attributes<false, true>(out); }

}  // extern "C"
