// K9: the diagonal-Gibbs cross-Gram K(x1, l1; x2, l2), N1 x N2, written to
// device memory.  Hopper (sm_90a) port of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_gram.py::gibbs_gram_pallas (body
// _kernel, pallas_call in _forward).  The wrapper, the plain PyTorch version
// and the design notes are in nonstationary_precip_tpu_torch/ops/gibbs_gram.py.
//
// What bounds it: the N1 N2 floats it writes.  A block of kThreads threads
// owns a kTileM x kTileN tile of the output; thread (tr, tc) a register tile
// of kRowsPerThread rows (tr, tr + kRowThreads, ..) by kColsPerThread
// consecutive columns (kColsPerThread tc ..), so a warp writes two rows of
// kTileN floats at once, each row one contiguous 256-byte run.
//  * d = 2: the element is gibbs_elem.cuh's d2_elem, the one K2 computes.
//    The tile's row factors (x_i, l_i^2, n_i) and column factors (x_j, q_j,
//    n_j) are made once each, into shared memory, and each thread reads its
//    rows' and columns' into registers; an element is then 15 f32
//    operations (an FMA as 2), one rsqrt.approx and one ex2.approx.
//  * other d (on no path): gibbs_elem.cuh's per-dim gibbs_elem, the one K2
//    and K3 compute at d != 2, on payloads read into registers.
// A call may carry T members (a stack of pairs, as JAX's vmap hands the TPU
// kernel a split-stacked Gram): member t is blockIdx.z, its inputs and its
// output offset by t n1 d, t n2 d and t n1 n2 floats, one launch for all.
// No special case on the diagonal (the TPU kernel has none either).  Each
// thread writes its register tile row by row as float4 where the row stride
// and the output's base allow it (N2 % 4 == 0), else float2 (N2 % 2 == 0:
// the slice's 394-wide Grams, 2.78 us against 4.15 with a float at a time,
// tools/bench_k9.py on an H100), else a float at a time; plain stores, since
// the Gram is read again at once and fits the L2.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "gibbs_elem.cuh"

namespace {

using gibbs::kMaxD;
using gibbs::live;

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;                      // one float4 of a row
constexpr int kColThreads = 16;                        // threads across a tile's columns
constexpr int kRowThreads = kThreads / kColThreads;    // threads down a tile's rows
// Rows a thread owns: 8 (128 x 64 tiles, 200 blocks at 1280^2), measured
// against 2 and 4 by tools/bench_k9.py (which builds copies of this file
// with the value rewritten): the most at 1280^2, where the paths' largest
// Gram sits; at the small Grams 2 would take ~0.6 us less.
constexpr int kRowsPerThread = 8;
constexpr int kTileN = kColThreads * kColsPerThread;   // columns a block owns
constexpr int kTileM = kRowThreads * kRowsPerThread;   // rows a block owns
static_assert(kColThreads * kRowThreads == kThreads && 32 % kColThreads == 0, "a warp writes whole rows of the tile");

// Writes row i's kColsPerThread values v from column c on, kW floats a
// store; columns past n2 are dropped (kW divides n2, so a store is wholly
// inside or wholly past the row's end).
template <int kW>
__device__ __forceinline__ void store_row(float* __restrict__ out, int n2, int i, int c,
                                          const float (&v)[kColsPerThread]) {
  float* p = out + static_cast<size_t>(i) * n2 + c;
#pragma unroll
  for (int h = 0; h < kColsPerThread; h += kW) {
    if (c + h >= n2) break;
    if constexpr (kW == 4) {
      *reinterpret_cast<float4*>(p + h) = make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]);
    } else if constexpr (kW == 2) {
      *reinterpret_cast<float2*>(p + h) = make_float2(v[h], v[h + 1]);
    } else {
      p[h] = v[h];
    }
  }
}

// Row (or column) r's payload; past the end x = 0, l = 1: finite, never stored.
template <int D>
__device__ __forceinline__ void payload(const float* __restrict__ x, const float* __restrict__ l, int n, int r,
                                        int d, float* xr, float* lr) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const bool ok = r < n && live<D>(k, d);
    xr[k] = ok ? x[static_cast<size_t>(r) * d + k] : 0.0f;
    lr[k] = ok ? l[static_cast<size_t>(r) * d + k] : 1.0f;
  }
}

template <int D, int kW>
__global__ void __launch_bounds__(kThreads)
gibbs_gram_kernel(const float* __restrict__ x1, const float* __restrict__ l1, int n1,
                  const float* __restrict__ x2, const float* __restrict__ l2, int n2,
                  int d, float* __restrict__ out) {
  // member blockIdx.z of the stack
  const size_t t = blockIdx.z;
  x1 += t * n1 * d, l1 += t * n1 * d, x2 += t * n2 * d, l2 += t * n2 * d;
  out += t * n1 * n2;
  const int tid = threadIdx.x;
  const int tc = tid % kColThreads, tr = tid / kColThreads;
  const int i0 = blockIdx.y * kTileM, j0 = blockIdx.x * kTileN;
  const int c = j0 + kColsPerThread * tc;

  if constexpr (D == 2) {
    // the tile's row factors (x0, x1, a0, a1, n) and its columns' (x0, x1,
    // q0, q1) and n
    __shared__ __align__(16) float rs[kTileM * 5];
    __shared__ __align__(16) float cs[kTileN * 5];
    for (int e = tid; e < kTileM; e += kThreads) {
      float xr[2], lr[2];
      payload<2>(x1, l1, n1, i0 + e, d, xr, lr);
      const gibbs::D2Row f = gibbs::d2_row(xr, lr);
      float* s = rs + 5 * e;
      s[0] = f.x0, s[1] = f.x1, s[2] = f.a0, s[3] = f.a1, s[4] = f.n;
    }
    for (int e = tid; e < kTileN; e += kThreads) {
      float xc[2], lc[2];
      payload<2>(x2, l2, n2, j0 + e, d, xc, lc);
      reinterpret_cast<float4*>(cs)[e] = gibbs::d2_col_xq(xc[0], xc[1], lc[0], lc[1]);
      cs[4 * kTileN + e] = gibbs::d2_col_n(lc[0], lc[1]);
    }
    __syncthreads();
    if (c >= n2) return;
    float4 xq[kColsPerThread];
    float cn[kColsPerThread];
#pragma unroll
    for (int v = 0; v < kColsPerThread; ++v) {
      xq[v] = reinterpret_cast<const float4*>(cs)[kColsPerThread * tc + v];
      cn[v] = cs[4 * kTileN + kColsPerThread * tc + v];
    }
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int r = tr + u * kRowThreads;
      if (i0 + r >= n1) break;
      const float* s = rs + 5 * r;
      const gibbs::D2Row f{s[0], s[1], s[2], s[3], s[4]};
      float val[kColsPerThread];
#pragma unroll
      for (int v = 0; v < kColsPerThread; ++v) val[v] = gibbs::d2_elem(f, xq[v], cn[v]);
      store_row<kW>(out, n2, i0 + r, c, val);
    }
  } else {
    if (c >= n2) return;
    float xj[kColsPerThread][D], lj[kColsPerThread][D];
#pragma unroll
    for (int v = 0; v < kColsPerThread; ++v) payload<D>(x2, l2, n2, c + v, d, xj[v], lj[v]);
#pragma unroll 1
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int i = i0 + tr + u * kRowThreads;
      if (i >= n1) break;
      float xi[D], li[D], diff[D], inv_ss[D];
      payload<D>(x1, l1, n1, i, d, xi, li);
      float val[kColsPerThread];
#pragma unroll
      for (int v = 0; v < kColsPerThread; ++v) val[v] = gibbs::gibbs_elem<D>(xi, li, xj[v], lj[v], d, diff, inv_ss);
      store_row<kW>(out, n2, i, c, val);
    }
  }
}

template <int D>
void launch(const float* x1, const float* l1, int n1, const float* x2, const float* l2, int n2, int d, int nt,
            float* out, cudaStream_t s) {
  const dim3 grid((n2 + kTileN - 1) / kTileN, (n1 + kTileM - 1) / kTileM, nt);
  // The store width holds for every member where it holds for the first:
  // a member's output starts n1 n2 floats after the last's, a multiple of 4
  // where n2 % 4 == 0 (16 bytes) and of 2 where n2 % 2 == 0 (8 bytes).
  const auto a = reinterpret_cast<std::uintptr_t>(out);
  if (n2 % 4 == 0 && a % 16 == 0) gibbs_gram_kernel<D, 4><<<grid, kThreads, 0, s>>>(x1, l1, n1, x2, l2, n2, d, out);
  else if (n2 % 2 == 0 && a % 8 == 0) gibbs_gram_kernel<D, 2><<<grid, kThreads, 0, s>>>(x1, l1, n1, x2, l2, n2, d, out);
  else gibbs_gram_kernel<D, 1><<<grid, kThreads, 0, s>>>(x1, l1, n1, x2, l2, n2, d, out);
}

}  // namespace

extern "C" {

// x1, l1: nt x n1 x d; x2, l2: nt x n2 x d; out: nt x n1 x n2, all f32
// row-major on the device, 1 <= d <= 8, 1 <= nt <= 65535 (the grid's z
// limit).  One launch on `stream` for all nt members; returns
// cudaGetLastError() as an int (0 = launched).
int gibbs_gram(const void* x1, const void* l1, int n1, const void* x2, const void* l2,
               int n2, int d, int nt, void* out, void* stream) {
  if (n1 < 1 || n2 < 1 || d < 1 || d > kMaxD || nt < 1 || nt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(x1);
  const auto* b = static_cast<const float*>(l1);
  const auto* c = static_cast<const float*>(x2);
  const auto* e = static_cast<const float*>(l2);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(a, b, n1, c, e, n2, d, nt, o, s); break;
    case 2: launch<2>(a, b, n1, c, e, n2, d, nt, o, s); break;
    case 3: launch<3>(a, b, n1, c, e, n2, d, nt, o, s); break;
    default: launch<kMaxD>(a, b, n1, c, e, n2, d, nt, o, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
