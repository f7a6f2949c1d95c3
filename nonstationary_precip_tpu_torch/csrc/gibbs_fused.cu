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
//     s2 K + (noise + extra) I into the n x n workspace A, in 64 x 64 tiles
//     of gibbs_elem.cuh's element, the diagonal written exactly as
//     s2 + (noise + extra) (the TPU kernel's closed form); the padded rows
//     and columns (i or j >= N) are the identity, so they stay uncoupled;
//     alpha = y, zero-padded;
//  2. blocked_chol.cuh's left-looking factorisation of A into L at 128-wide
//     blocks (K10a's), with alpha = L^-1 y riding each diagonal block;
//  3. finite_kernel: state[1] = 1 if any entry of L or alpha is not finite;
//  4. commit_kernel: if no attempt has succeeded yet and this one is
//     finite, state[0] = attempt + 1; state[1] = 0.
// Every kernel of attempts 2 and 3 reads state[0] first and returns at once
// when it is set: no host round trip, and a few dozen empty launches on the
// happy path (the TPU kernel's pl.when).  If all three fail, L and alpha
// hold the last attempt's non-finite result and state[0] is 0.

#include <cuda_runtime.h>

#include <cstddef>

#include "blocked_chol.cuh"
#include "gibbs_elem.cuh"

namespace {

using gibbs::gibbs_elem;
using gibbs::kMaxD;
using gibbs::live;

constexpr int kP = 128;  // factorisation block (K10a's)
constexpr int kDiagThreads = 256;
constexpr int kTile = 64;  // build tile
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kTile;
constexpr float kExtra[3] = {0.0f, 1e-4f, 1e-2f};  // pallas_fused.py:184-199

template <int D>
__global__ void __launch_bounds__(kThreads)
build_kernel(const float* __restrict__ x, const float* __restrict__ l, int n, int d,
             const float* __restrict__ y, const float* __restrict__ s2p,
             const float* __restrict__ noisep, float extra, float* __restrict__ A,
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
    A[static_cast<size_t>(row) * n_pad + col] = v;
  }
}

__global__ void finite_kernel(const float* __restrict__ L, size_t nn,
                              const float* __restrict__ alpha, int n, int* state) {
  if (state[0] != 0) return;
  bool bad = false;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < nn; e += stride) {
    bad |= !chol_sweep::finite(L[e]);
    if (e < static_cast<size_t>(n)) bad |= !chol_sweep::finite(alpha[e]);
  }
  if (bad) state[1] = 1;  // every writer stores the same value
}

__global__ void commit_kernel(int* state, int attempt) {
  if (state[0] == 0 && state[1] == 0) state[0] = attempt + 1;
  state[1] = 0;
}

template <int D>
int run(const float* x, const float* l, int n, int d, const float* y, const float* s2,
        const float* noise, float* A, float* L, float* alpha, float* cbuf, float* ljj,
        float* linv, int* state, int n_pad, cudaStream_t s) {
  const int tiles = n_pad / kTile;
  cudaError_t e;
  for (int attempt = 0; attempt < 3; ++attempt) {
    build_kernel<D><<<dim3(tiles, tiles), kThreads, 0, s>>>(x, l, n, d, y, s2, noise, kExtra[attempt],
                                                            A, alpha, n_pad, state);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    const int err =
        blocked_chol::left_looking<kP, kDiagThreads>(A, L, cbuf, ljj, linv, n_pad, s, alpha, state);
    if (err != 0) return err;
    finite_kernel<<<264, 256, 0, s>>>(L, static_cast<size_t>(n_pad) * n_pad, alpha, n_pad, state);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    commit_kernel<<<1, 1, 0, s>>>(state, attempt);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

extern "C" {

// x, l: n x d (1 <= d <= 8); y: n; s2, noise: one float each; all f32 on the
// device.  n_pad: n rounded up to a multiple of 128.  Outputs: L n_pad x
// n_pad (zero-filled by the caller), alpha n_pad.  Scratch: A n_pad x n_pad,
// cbuf n_pad x 128, ljj and linv 128 x 128, state two ints set to 0 by the
// caller (state[0] on return to the host: 1 + the attempt that succeeded, 0
// if none did).  Launches every kernel on `stream` and returns the first
// non-zero cudaGetLastError() as an int (0 = all launched).
int gibbs_fused(const void* x, const void* l, int n, int d, const void* y, const void* s2,
                const void* noise, void* a, void* lout, void* alpha, void* cbuf, void* ljj,
                void* linv, void* state, int n_pad, void* stream) {
  if (n < 1 || d < 1 || d > kMaxD || n_pad < n || n_pad % kP != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* lf = static_cast<const float*>(l);
  const auto* yf = static_cast<const float*>(y);
  const auto* s2f = static_cast<const float*>(s2);
  const auto* nf = static_cast<const float*>(noise);
  auto* A = static_cast<float*>(a);
  auto* L = static_cast<float*>(lout);
  auto* al = static_cast<float*>(alpha);
  auto* cb = static_cast<float*>(cbuf);
  auto* lj = static_cast<float*>(ljj);
  auto* li = static_cast<float*>(linv);
  auto* st = static_cast<int*>(state);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return run<1>(xf, lf, n, d, yf, s2f, nf, A, L, al, cb, lj, li, st, n_pad, s);
    case 2: return run<2>(xf, lf, n, d, yf, s2f, nf, A, L, al, cb, lj, li, st, n_pad, s);
    case 3: return run<3>(xf, lf, n, d, yf, s2f, nf, A, L, al, cb, lj, li, st, n_pad, s);
    default: return run<kMaxD>(xf, lf, n, d, yf, s2f, nf, A, L, al, cb, lj, li, st, n_pad, s);
  }
}

}  // extern "C"
