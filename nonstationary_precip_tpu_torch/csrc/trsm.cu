// K11: X = L^-1 B for a lower-triangular L (N x N) and B (N x K).  Hopper
// (sm_90a) kernel in place of the TPU kernel
// nonstationary_precip_tpu/ops/pallas_trsm.py::blocked_trsm (body
// _trsm_kernel, pallas_call in _forward), which walks the 128-row blocks in
// turn: X_i = L_ii^-1 (B_i - sum_{j<i} L_ij X_j).  The wrapper, the plain
// PyTorch version and the design notes are in
// nonstationary_precip_tpu_torch/ops/trsm.py.
//
// What bounds it on an H100: N^2 K / 2 FFMAs (N = 1280, K = 256: 6 us at the
// f32 peak outside the tensor cores), but the block rows are a dependent
// chain, and within a diagonal block so is the substitution.  So each block
// row's work is spread over rows and columns, right-looking: one launch per
// block row i, CTA (c, j - i) for each 32-wide column tile c and each block
// row j >= i.  Every CTA first solves L_ii X_i[:, c] = W_i[:, c] itself, in
// shared memory, one 32-row block at a time: one warp, a lane a column,
// substitutes the block in registers (multiplying by the pivots'
// reciprocals), then all 256 threads subtract the block's 32-deep product
// from the rows below it.  The CTA with j = i writes X_i's tile; the CTAs
// with j > i apply W_j[:, c] -= L_ji X_i[:, c] (4 x 4 register micro-tiles
// of f32 FFMAs over 16-byte shared-memory reads).  Every CTA forms X_i's
// tile by the same code in the same order, so the update uses the bits
// written to X.  W is the wrapper's working copy of B, separate from X: the
// CTAs with j > i read W_i while the CTA with j = i writes X_i.  L_ii, W_i's
// tile and L_ji come in by cp.async (L_ji's copy under the substitution),
// and each launch after the first is a programmatic dependent of the one
// before, so its CTAs copy L_ii while that one finishes.  N / 128 launches a
// call.  A product with L_ii^-1 in place of the substitution would be all
// FFMAs, but it is not backward stable: on the noisy Gibbs Gram at init
// (N = 1024) its residual |L X - B| reaches 1.38 gamma_(N+1) |L| |X|, the
// substitution's 0.018 (tests/test_torch_trsm_rl.py).
// No tensor cores, no TF32, no atomics: each product is a chain of FFMAs in
// ascending k (32 deep in the tile, 128 deep across block rows), subtracted
// once, and the updates come in launch order, so the rounding grows with
// 128 + N / 128 and every run gives the same bits.  A zero or non-finite
// pivot makes its column of X non-finite from that row on, and every later
// block row through the updates.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kB = 128;        // block rows (the TPU kernel's BLOCK)
constexpr int kCT = 32;        // columns of X a CTA owns
constexpr int kLeaf = 32;      // rows of one substitution block: one warp, a lane a column
constexpr int kThreads = 256;  // 8 x 32: thread (ty, tx) the columns 4 tx .. 4 tx + 3
constexpr int kLds = kB + 4;   // row stride of the L tiles in shared memory: 16-byte rows, kLds / 4 odd
constexpr int kXld = kCT + 4;  // row stride of the X tile: 16-byte rows, kXld / 4 odd
constexpr int kQuadsL = kB / 4;   // 16-byte pieces in a row of an L tile
constexpr int kQuadsX = kCT / 4;  // and of the X tile
constexpr int kMicro = kB / (kThreads / kQuadsX);  // rows of the update a thread owns (4)
// L_ii, L_ji, the X tile and the pivots' reciprocals
constexpr int kSmem = (2 * kB * kLds + kB * kXld + kB) * static_cast<int>(sizeof(float));
static_assert(kCT == kLeaf && kThreads == 8 * kLeaf && kQuadsX == 8 && kMicro * 32 == kB,
              "the thread grid is 8 column quads x 32 rows, and one warp substitutes a block");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kB x kQuads 16-byte pieces of the tile at src (row stride ld floats) into
// dst (row stride dld).
template <int kQuads>
__device__ __forceinline__ void load_tile(float* dst, int dld, const float* src, size_t ld) {
  for (int e = threadIdx.x; e < kB * kQuads; e += kThreads) {
    const int r = e / kQuads;
    const int c = (e % kQuads) * 4;
    cp_async16(dst + r * dld + c, src + r * ld + c);
  }
}

// acc += a b, a fused multiply-add an entry
__device__ __forceinline__ void fma4(float a, const float4& b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// v -= acc, four entries
__device__ __forceinline__ void sub4(float4& v, const float4& acc) {
  v.x -= acc.x;
  v.y -= acc.y;
  v.z -= acc.z;
  v.w -= acc.w;
}

// Block row i0 / kB of the solve, CTA (blockIdx.x, blockIdx.y) the column
// tile c0 = kCT blockIdx.x of block row j0 = i0 + kB blockIdx.y.  L (row
// stride n) is read below its diagonal; W and X have row stride k.
__global__ void __launch_bounds__(kThreads, 1)
trsm_row_kernel(const float* __restrict__ L, float* __restrict__ W, float* __restrict__ X, int n, int k, int i0) {
  extern __shared__ __align__(16) float smem[];
  float* Ld = smem;              // L_ii
  float* Lo = Ld + kB * kLds;    // L_ji
  float* Xs = Lo + kB * kLds;    // W_i's tile, solved in place into X_i's
  float* rinv = Xs + kB * kXld;  // 1 / L_ii's pivots
  const int tid = threadIdx.x;
  const int tx = tid % kQuadsX;
  const int ty = tid / kQuadsX;
  const int c0 = blockIdx.x * kCT;
  const int j0 = i0 + blockIdx.y * kB;
  const bool solver = blockIdx.y == 0;

  // The next block row's launch may start now, up to its own wait below.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  load_tile<kQuadsL>(Ld, kLds, L + static_cast<size_t>(i0) * n + i0, n);  // L is read-only
  cp_async_commit();
  // Wait for the previous block row's launch to finish and its writes of W
  // to be visible (returns at once without a programmatic dependency).
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  load_tile<kQuadsX>(Xs, kXld, W + static_cast<size_t>(i0) * k + c0, k);
  cp_async_commit();
  if (!solver) load_tile<kQuadsL>(Lo, kLds, L + static_cast<size_t>(j0) * n + i0, n);
  cp_async_commit();  // lands under the substitution
  cp_async_wait<1>();
  __syncthreads();
  if (tid < kB) rinv[tid] = 1.f / Ld[tid * kLds + tid];
  __syncthreads();

  // The tile solve, one 32-row block at a time: its substitution, then the
  // update of every row below it by its 32 columns.
#pragma unroll 1
  for (int r0 = 0; r0 < kB; r0 += kLeaf) {
    if (tid < kLeaf) {  // the 32 x 32 diagonal block, lane c column c, in registers
      float r[kLeaf];
#pragma unroll
      for (int q = 0; q < kLeaf; ++q) r[q] = Xs[(r0 + q) * kXld + tid];
#pragma unroll
      for (int q = 0; q < kLeaf; ++q) {
        r[q] *= rinv[r0 + q];
#pragma unroll
        for (int p = q + 1; p < kLeaf; ++p) r[p] = fmaf(-Ld[(r0 + p) * kLds + r0 + q], r[q], r[p]);
      }
#pragma unroll
      for (int q = 0; q < kLeaf; ++q) Xs[(r0 + q) * kXld + tid] = r[q];
    }
    __syncthreads();
    const int below = (kB - r0) / kLeaf - 1;  // 32-row blocks below this one
    if (below > 0) {  // thread (ty, tx) rows r0 + 32 (m + 1) + ty, 4 columns; a 32-deep sum, then subtracted
      float4 v[kMicro - 1];
#pragma unroll
      for (int m = 0; m < kMicro - 1; ++m) v[m] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int t = 0; t < kLeaf; t += 4) {
        float4 bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = *reinterpret_cast<const float4*>(Xs + (r0 + t + q) * kXld + 4 * tx);
#pragma unroll
        for (int m = 0; m < kMicro - 1; ++m) {
          if (m < below) {
            const float4 a = *reinterpret_cast<const float4*>(Ld + (r0 + kLeaf * (m + 1) + ty) * kLds + r0 + t);
            fma4(a.x, bv[0], v[m]);
            fma4(a.y, bv[1], v[m]);
            fma4(a.z, bv[2], v[m]);
            fma4(a.w, bv[3], v[m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kMicro - 1; ++m)
        if (m < below) sub4(*reinterpret_cast<float4*>(Xs + (r0 + kLeaf * (m + 1) + ty) * kXld + 4 * tx), v[m]);
      __syncthreads();
    }
  }

  if (solver) {  // X_i's tile out
    for (int e = tid; e < kB * kQuadsX; e += kThreads) {
      const int r = e / kQuadsX;
      const int c = (e % kQuadsX) * 4;
      *reinterpret_cast<float4*>(X + static_cast<size_t>(i0 + r) * k + c0 + c) =
          *reinterpret_cast<const float4*>(Xs + r * kXld + c);
    }
    return;
  }

  // W_j's tile -= L_ji X_i's tile, a 128-deep sum in ascending k, then
  // subtracted: thread (ty, tx) rows ty + 32 a, 4 columns
  float* wj = W + static_cast<size_t>(j0) * k + c0 + 4 * tx;
  float4 w[kMicro], acc[kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    w[a] = *reinterpret_cast<const float4*>(wj + static_cast<size_t>(ty + 32 * a) * k);  // in flight under the sums
    acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll 2
  for (int t = 0; t < kB; t += 4) {
    float4 av[kMicro], bv[4];
#pragma unroll
    for (int a = 0; a < kMicro; ++a) av[a] = *reinterpret_cast<const float4*>(Lo + (ty + 32 * a) * kLds + t);
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = *reinterpret_cast<const float4*>(Xs + (t + q) * kXld + 4 * tx);
#pragma unroll
    for (int a = 0; a < kMicro; ++a) {
      fma4(av[a].x, bv[0], acc[a]);
      fma4(av[a].y, bv[1], acc[a]);
      fma4(av[a].z, bv[2], acc[a]);
      fma4(av[a].w, bv[3], acc[a]);
    }
  }
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    sub4(w[a], acc[a]);
    *reinterpret_cast<float4*>(wj + static_cast<size_t>(ty + 32 * a) * k) = w[a];
  }
}

}  // namespace

extern "C" {

// l: n x n, read below and on its diagonal; w: n x k, a copy of B that the
// solve overwrites; x: n x k, the result; all f32, row-major, 16-byte
// aligned, on the device; n a positive multiple of 128, k of 32.  n / 128
// launches on `stream`; returns the first non-zero CUDA error as an int
// (0 = all launched).
int trsm(const void* l, void* w, void* x, int n, int k, void* stream) {
  if (n < kB || n % kB != 0 || k < kCT || k % kCT != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(trsm_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* L = static_cast<const float*>(l);
  auto* W = static_cast<float*>(w);
  auto* X = static_cast<float*>(x);
  // Each block row's launch after the first is a programmatic dependent of
  // the one before: its CTAs may start on free SMs and copy L_ii while that
  // one finishes.  The first launch waits for the caller's kernels as usual.
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  for (int i0 = 0; i0 < n; i0 += kB) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(k / kCT, (n - i0) / kB);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    cfg.stream = s;
    cfg.attrs = &pdl;
    cfg.numAttrs = i0 > 0 ? 1 : 0;
    if ((e = cudaLaunchKernelEx(&cfg, trsm_row_kernel, L, W, X, n, k, i0)) != cudaSuccess)
      return static_cast<int>(e);
  }
  return 0;
}

// Registers, local (spill) bytes, static and dynamic shared memory of
// trsm_row_kernel into out[4], as the runtime reports them.
int trsm_attributes(int* out) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(&trsm_row_kernel));
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = kSmem;
  return 0;
}

}  // extern "C"
