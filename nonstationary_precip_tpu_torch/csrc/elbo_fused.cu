// K7: the fused DSVI ELBO data term of the deep GP (2 hidden SVGP layers of
// width 2, a scalar head, D = 2), forward and hand-derived backward, for a
// stack of T members.  Hopper (sm_90a) port of the TPU kernels
// nonstationary_precip_tpu/ops/pallas_elbo.py::_pallas_fwd (body
// _elbo_fwd_kernel) and ::_pallas_bwd (body _elbo_bwd_kernel).  The
// wrapper, the plain PyTorch version and the design notes are in
// nonstationary_precip_tpu_torch/ops/elbo_fused.py.
//
// Layout (row-major f32): x (T, B, 2), y (T, B), eps1/eps2 (T, S, 2, B),
// z (T, 5, M, 2), ell (T, 5, 2), s2 (T, 5), w (T, 5, M, P = 2M + 1),
// mw1/mw2 (T, 2, 2) as [input, output], mb1/mb2 (T, 2), mbh (T, 1),
// noise (T,).  Groups 0-1 are layer 1, 2-3 layer 2, 4 the head.
//
// Both passes run in phases over whole members, on one stream, sharing the
// marginals' two kernels: elbo_k_kernel builds K_xz of a range of groups at
// every row into scratch, and elbo_out_kernel runs out = K_xz W over every
// member and group of the range as a register-tiled GEMM (64 x 128 tiles,
// W through a cp.async ring), with each row's sums of (A S)^2 and A^2 per
// column tile as its epilogue; row_var adds a row's tiles in order.  So the
// forward's per-row means and variances are the backward's, to the bit.
//
// Forward: ten launches, one layer a phase: K_xz and out of layer 1's two
// groups at the B x rows, then elbo_fwd_layer1_kernel (the means, the
// variances and h1 = m + sqrt(max(v, 1e-10)) eps1 of every sample); the
// same at the S B sample rows for layer 2 (h2) and for the head, whose row
// kernel writes each 64-row tile's sum of the expected log-likelihood
// terms; elbo_sum_kernel adds the tiles in order.  out itself never
// reaches scratch: the forward keeps each row's mean (column 0) and
// variance.
//
// Backward: ten launches over whole members, listed above elbo_k_kernel
// below: K_xz and out = K_xz W of every group at every row into scratch,
// then
// the chain backwards one layer a launch (the head's row cotangents, the
// pullback kbar = outbar W^T and g = kbar * K_xz, layer 2's, its pullback,
// layer 1's summed over each x row's samples, its pullback), Wbar =
// K_xz^T outbar, and the small cotangents from the partials.  No atomics:
// every sum has a fixed order, so a result is the same bits on every run.
//
// Ghost rows (past a group's rows) are zero-filled in the GEMMs' slabs, so
// they add nothing to any product; columns past P and inducing points past
// M are masked.  Plain f32 throughout: IEEE division, expf, sqrtf, logf, no
// tensor cores.  Variances are clamped at 1e-10 in the forward; the
// backward takes sqrt(max(var, 1e-10)) and zeroes the variance cotangent
// where the unclipped variance is <= 1e-10, as the JAX package does.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = kThreads;  // one thread per inducing point in the reductions
constexpr int kMaxB = 1024;
constexpr int kGroups = 5;
constexpr int kWbarTile = 128;   // Wbar output tile edge
constexpr int kWbarK = 16;       // scratch rows a ring slab of Wbar
constexpr int kWbarThreads = 256;
constexpr float kVarFloor = 1e-10f;
constexpr float kTwoPi = 6.28318530717958647692f;

// the small cotangents: z-bar (5, M, 2) first, then these slots
constexpr int kSlotEll = 0;     // (5, 2)
constexpr int kSlotS2 = 10;     // (5,)
constexpr int kSlotMw1 = 15;    // (2, 2) [d][o]
constexpr int kSlotMb1 = 19;    // (2,)
constexpr int kSlotMw2 = 21;    // (2, 2)
constexpr int kSlotMb2 = 25;    // (2,)
constexpr int kSlotMbh = 27;
constexpr int kSlotNoise = 28;
constexpr int kSlots = 29;

struct Params {
  const float *x, *y, *eps1, *eps2, *z, *ell, *s2, *w, *mw1, *mb1, *mw2, *mb2,
      *mbh, *noise;
  int t, b, s, m, p;
  int ld;   // row stride of the backward's out scratch: P rounded up to 4
  int kld;  // ... and of the K_xz scratch: M rounded up to 4
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ __forceinline__ int rowbase(const Params& P, int g) {
  // scratch rows per member: B for each layer-1 group, S * B for the others
  const int sb = P.s * P.b;
  return g < 2 ? g * P.b : 2 * P.b + (g - 2) * sb;
}

__host__ __device__ __forceinline__ size_t scratch_rows(const Params& P) {
  return static_cast<size_t>(2 * P.b + 3 * P.s * P.b);
}

// index of eps (T, S, 2, B) and of h1/h2 (T, S, B, 2)
__device__ __forceinline__ size_t eps_at(const Params& P, int t, int s, int o, int b) {
  return ((static_cast<size_t>(t) * P.s + s) * 2 + o) * P.b + b;
}
__device__ __forceinline__ size_t h_at(const Params& P, int t, int s, int b, int o) {
  return ((static_cast<size_t>(t) * P.s + s) * P.b + b) * 2 + o;
}

__global__ void elbo_sum_kernel(const float* __restrict__ partial, float* __restrict__ dt, int t, int ntiles,
                                float count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t) return;
  float s = 0.f;
  for (int j = 0; j < ntiles; ++j) s += partial[static_cast<size_t>(i) * ntiles + j];
  dt[i] = s / count;
}

// ---------------------------------------------------------------------------
// The backward, in phases over whole members (elbo_bwd launches them in
// turn on one stream):
//   elbo_k_kernel           K_xz of every group at every row, into kscr;
//   elbo_out_kernel         out = K_xz W of every group (64 x 128 tiles),
//                           into oscr, with each row's sums of squares per
//                           column tile;
//   elbo_bwd_head_kernel    the head's row cotangents; outbar into oscr;
//   elbo_bwd_pull_kernel    kbar = outbar W^T (64 x 128 tiles), g = kbar * K,
//                           the input cotangent's partial per row and the
//                           column sums of g per row tile, for the head;
//   elbo_bwd_layer2_kernel  h2bar, layer 2's row cotangents, outbar;
//   elbo_bwd_pull_kernel    ... for layer 2;
//   elbo_bwd_layer1_kernel  h1bar, summed over each x row's samples, layer
//                           1's row cotangents, outbar;
//   elbo_bwd_pull_kernel    ... for layer 1 (no input cotangent);
//   elbo_wbar_kernel        Wbar = K_xz^T outbar of every group (128 x 128);
//   elbo_bwd_reduce_kernel  the small cotangents and ybar from the partials.
// The three products are register-tiled FFMA GEMMs (a 8 x 4 or 8 x 8
// micro-tile a thread) whose k-slabs come through a 3-stage cp.async ring;
// each grid spans every member and group, so no phase leaves SMs idle for
// want of blocks.  Every partial has its own slot and is added in a fixed
// order (row tiles, column tiles and W's halves ascending), with no
// atomics.  Scratch rows per member: B for each layer-1 group, S B for each
// other (sample row q = s B + b), in group order.
// ---------------------------------------------------------------------------

constexpr int kRowTile = 64;         // rows a tile of the out and kbar products: 8 warps x 8
constexpr int kColTile = 128;        // out's columns, or kbar's inducing points, a tile: 32 lanes x 4
constexpr int kMaxCt = (2 * kMaxM + 1 + kColTile - 1) / kColTile;  // out's column tiles at most
constexpr int kSlabK = 16;           // k a ring slab
constexpr int kALd = kRowTile + 4;   // row stride of a k-major A slab
constexpr int kBLd = kColTile + 4;   // ... and of a B slab
constexpr int kRing = 3;             // cp.async stages
constexpr int kSlabFloats = kSlabK * (kALd + kBLd);
constexpr int kColSums = 5;          // per inducing point and row tile: g, g h0, g h1, g (h0-z0)^2, g (h1-z1)^2
static_assert(kRowTile == 8 * kWarps && kColTile == 4 * 32, "warp w the rows 8w..8w+7, lane l the columns 4l..4l+3");
static_assert(kRing * kSlabFloats >= kWarps * kColTile * kColSums, "the ring also holds the column sums");

// ---- cp.async: 4 bytes (W's and the k-contiguous operands' rows are not
//      16-byte aligned) or 16 bytes, a copy that is not valid zero-filling ----
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16z(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Where each piece of the backward's small scratch ("partial") lives, per
// member, in floats.
struct BwdLayout {
  int b, sb, nt_b, nt_sb;
  size_t var, head, l2, l1, h1lin, hb_head, hb_l2, col, total;
  __host__ __device__ BwdLayout(int b_, int s_) : b(b_), sb(s_ * b_) {
    nt_b = (b + kRowTile - 1) / kRowTile;
    nt_sb = (sb + kRowTile - 1) / kRowTile;
    var = 0;                                                   // [row][ct][sum of (A S)^2, sum of A^2]
    head = var + static_cast<size_t>(2 * b + 3 * sb) * kMaxCt * 2;  // [q][meanbar, varbar, noisebar, ybar]
    l2 = head + static_cast<size_t>(sb) * 4;                   // [o][q][meanbar, varbar]
    l1 = l2 + static_cast<size_t>(2) * sb * 2;                 // [o][b][meanbar, varbar]
    h1lin = l1 + static_cast<size_t>(2) * b * 2;               // [q][d]: h1bar through layer 2's mean weights
    hb_head = h1lin + static_cast<size_t>(sb) * 2;             // [half][q][d]: h2bar from the head
    hb_l2 = hb_head + static_cast<size_t>(2) * sb * 2;         // [o][half][q][d]: h1bar from layer 2
    col = hb_l2 + static_cast<size_t>(4) * sb * 2;             // [g][tile][m][kColSums]
    total = col + static_cast<size_t>(2 * nt_b + 3 * nt_sb) * kMaxM * kColSums;
  }
  __host__ __device__ int rows(int g) const { return g < 2 ? b : sb; }
  __host__ __device__ int tiles(int g) const { return g < 2 ? nt_b : nt_sb; }
  __host__ __device__ int tile0(int g) const { return g < 2 ? g * nt_b : 2 * nt_b + (g - 2) * nt_sb; }
};

// (group, row tile) of tile index `y` over the groups g0, g0 + 1, ..
__device__ __forceinline__ void group_tile(const BwdLayout& Lb, int g0, int y, int& g, int& tile) {
  g = g0;
  tile = y;
  while (tile >= Lb.tiles(g)) tile -= Lb.tiles(g++);
}

// the rows' inputs: x at layer 1, h1 at layer 2, h2 at the head
__device__ __forceinline__ const float* group_h(const Params& P, const float* h1, const float* h2, int t, int g) {
  if (g < 2) return P.x + static_cast<size_t>(t) * P.b * 2;
  return (g < 4 ? h1 : h2) + static_cast<size_t>(t) * P.s * P.b * 2;
}

// K_xz of groups [g0, g1) at every row, zero past M: kscr[t][rowbase(g) + r][m]
__global__ void __launch_bounds__(kThreads)
elbo_k_kernel(Params P, int g0, int g1, const float* __restrict__ h1, const float* __restrict__ h2,
              float* __restrict__ kscr) {
  const int t = blockIdx.y;
  const size_t rows = scratch_rows(P);
  const size_t first = rowbase(P, g0);
  const size_t end = g1 < kGroups ? static_cast<size_t>(rowbase(P, g1)) : rows;
  const size_t e = first * P.kld + static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= end * P.kld) return;
  const int row = static_cast<int>(e / P.kld), m = static_cast<int>(e % P.kld);
  int g = g0;
  while (g < g1 - 1 && row >= rowbase(P, g + 1)) ++g;
  float kv = 0.f;
  if (m < P.m) {
    const int tg = t * kGroups + g;
    const float* h = group_h(P, h1, h2, t, g) + static_cast<size_t>(row - rowbase(P, g)) * 2;
    const float e0 = P.ell[tg * 2], e1 = P.ell[tg * 2 + 1];
    const float z0 = P.z[(static_cast<size_t>(tg) * P.m + m) * 2] / e0;
    const float z1 = P.z[(static_cast<size_t>(tg) * P.m + m) * 2 + 1] / e1;
    const float xs0 = h[0] / e0, xs1 = h[1] / e1;
    const float quad = fmaxf((xs0 * xs0 + xs1 * xs1) + (z0 * z0 + z1 * z1) - 2.0f * (xs0 * z0 + xs1 * z1), 0.f);
    kv = P.s2[tg] * expf(-0.5f * quad);
  }
  kscr[(static_cast<size_t>(t) * rows + row) * P.kld + m] = kv;
}

// The product of one 64-row tile: acc[i][j] = sum over k of A(k, 8w + i)
// B(k, 4l + j), warp w and lane l, k in slabs of 16 through the ring; `load`
// issues a slab's copies into the stage's A (k-major, row stride kALd) and
// B (kBLd) buffers.
template <class Load>
__device__ __forceinline__ void tile_product(float* ring, int nslab, Load load, float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < nslab) load(s, ring + (s % kRing) * kSlabFloats);
    cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // slab s has landed for every thread; slab s - 1's stage is free
    if (s + kRing - 1 < nslab) load(s + kRing - 1, ring + ((s + kRing - 1) % kRing) * kSlabFloats);
    cp_async_commit();
    const float* a = ring + (s % kRing) * kSlabFloats + warp * 8;
    const float* b = ring + (s % kRing) * kSlabFloats + kSlabK * kALd + lane * 4;
#pragma unroll
    for (int kk = 0; kk < kSlabK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kALd);
      const float4 a1 = *reinterpret_cast<const float4*>(a + kk * kALd + 4);
      const float4 bv = *reinterpret_cast<const float4*>(b + kk * kBLd);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
}

// out = K_xz W of group g (of the groups from g0 on), one (64-row,
// 128-column) tile a block: each row's sums of (A S)^2 and A^2 over the
// tile's columns into the var partial; out into oscr if given (row stride
// P.ld; the columns past P come out zero), and its column 0, the mean, into
// mom[t][row][0] if given.
__global__ void __launch_bounds__(kThreads, 2)
elbo_out_kernel(Params P, int g0, const float* __restrict__ kscr, float* __restrict__ oscr, float* __restrict__ part,
                float* __restrict__ mom) {
  __shared__ __align__(16) float ring[kRing * kSlabFloats];
  const BwdLayout Lb(P.b, P.s);
  const int ct = blockIdx.x, t = blockIdx.z, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int g, tile;
  group_tile(Lb, g0, blockIdx.y, g, tile);
  const int tg = t * kGroups + g, nrows = Lb.rows(g), r0 = tile * kRowTile, c0 = ct * kColTile;
  const size_t row0 = static_cast<size_t>(t) * scratch_rows(P) + rowbase(P, g) + r0;
  const float* K = kscr + row0 * P.kld;
  const float* W = P.w + static_cast<size_t>(tg) * P.m * P.p;
  auto load = [&](int s, float* st) {
    float* as = st;
    float* bs = st + kSlabK * kALd;
    const int m0 = s * kSlabK;
#pragma unroll
    for (int q = 0; q < kSlabK * kRowTile / kThreads; ++q) {  // A(k = m, i = r) = K[r][m]: k-contiguous
      const int e = threadIdx.x + q * kThreads, i = e / kSlabK, kk = e % kSlabK;
      const bool ok = r0 + i < nrows && m0 + kk < P.m;
      cp_async4(as + kk * kALd + i, ok ? K + static_cast<size_t>(i) * P.kld + m0 + kk : K, ok);
    }
#pragma unroll
    for (int q = 0; q < kSlabK * kColTile / kThreads; ++q) {  // B(k = m, j = c) = W[m][c]
      const int e = threadIdx.x + q * kThreads, kk = e / kColTile, j = e % kColTile;
      const bool ok = m0 + kk < P.m && c0 + j < P.p;
      cp_async4(bs + kk * kBLd + j, ok ? W + static_cast<size_t>(m0 + kk) * P.p + c0 + j : W, ok);
    }
  };
  float acc[8][4];
  tile_product(ring, (P.m + kSlabK - 1) / kSlabK, load, acc);
  float* var = part + static_cast<size_t>(t) * Lb.total + Lb.var;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + warp * 8 + i;
    float sas = 0.f, sa = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + lane * 4 + j;
      if (c >= 1 && c <= P.m) sas = fmaf(acc[i][j], acc[i][j], sas);
      else if (c > P.m && c < P.p) sa = fmaf(acc[i][j], acc[i][j], sa);
    }
    sas = warp_sum(sas);
    sa = warp_sum(sa);
    if (r < nrows) {
      if (oscr && c0 + lane * 4 < P.ld)
        *reinterpret_cast<float4*>(oscr + (row0 + warp * 8 + i) * P.ld + c0 + lane * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (lane == 0) {
        float* v = var + (static_cast<size_t>(rowbase(P, g) + r) * kMaxCt + ct) * 2;
        v[0] = sas;
        v[1] = sa;
        if (mom && ct == 0) mom[(row0 + warp * 8 + i) * 2] = acc[i][0];
      }
    }
  }
}

// mean (column 0 of out) and the unclipped variance of scratch row `row`
// of group g: s2 - sum A^2 + sum (A S)^2, the column tiles in order
__device__ __forceinline__ float row_var(const Params& P, const BwdLayout& Lb, const float* part, int t, int g,
                                         int row) {
  const float* v = part + static_cast<size_t>(t) * Lb.total + Lb.var + static_cast<size_t>(rowbase(P, g) + row) * kMaxCt * 2;
  const int nct = (P.p + kColTile - 1) / kColTile;
  float sas = 0.f, sa = 0.f;
#pragma unroll
  for (int ct = 0; ct < kMaxCt; ++ct) {
    if (ct < nct) {
      sas += v[ct * 2];
      sa += v[ct * 2 + 1];
    }
  }
  return (P.s2[t * kGroups + g] - sa) + sas;
}

// ---- the forward's row kernels, a thread a row; mom[t][row] = (mean, the
//      unclipped variance) of every scratch row, the mean without the prior
//      mean (column 0 of out) ----

__device__ __forceinline__ float* mom_at(const Params& P, float* mom, int t, int g, int row) {
  return mom + (static_cast<size_t>(t) * scratch_rows(P) + rowbase(P, g) + row) * 2;
}

// layer 1 at x row b: each output's variance, mean and its S samples into h1
__global__ void __launch_bounds__(kThreads)
elbo_fwd_layer1_kernel(Params P, const float* __restrict__ part, float* __restrict__ mom, float* __restrict__ h1) {
  const BwdLayout Lb(P.b, P.s);
  const int t = blockIdx.y, b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= P.b) return;
  const float x0 = P.x[(static_cast<size_t>(t) * P.b + b) * 2], x1 = P.x[(static_cast<size_t>(t) * P.b + b) * 2 + 1];
  for (int o = 0; o < 2; ++o) {
    float* mo = mom_at(P, mom, t, o, b);
    const float var = row_var(P, Lb, part, t, o, b);
    mo[1] = var;
    const float lin = x0 * P.mw1[t * 4 + o] + x1 * P.mw1[t * 4 + 2 + o];
    const float mean = mo[0] + (lin + P.mb1[t * 2 + o]);
    const float sd = sqrtf(fmaxf(var, kVarFloor));
    for (int s = 0; s < P.s; ++s) h1[h_at(P, t, s, b, o)] = mean + sd * P.eps1[eps_at(P, t, s, o, b)];
  }
}

// layer 2 at sample row q = s B + b: each output's variance, mean and sample into h2
__global__ void __launch_bounds__(kThreads)
elbo_fwd_layer2_kernel(Params P, const float* __restrict__ part, const float* __restrict__ h1,
                       float* __restrict__ mom, float* __restrict__ h2) {
  const BwdLayout Lb(P.b, P.s);
  const int t = blockIdx.y, q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= Lb.sb) return;
  const int s = q / P.b, b = q % P.b;
  const float hq0 = h1[(static_cast<size_t>(t) * Lb.sb + q) * 2], hq1 = h1[(static_cast<size_t>(t) * Lb.sb + q) * 2 + 1];
  for (int o = 0; o < 2; ++o) {
    float* mo = mom_at(P, mom, t, 2 + o, q);
    const float var = row_var(P, Lb, part, t, 2 + o, q);
    mo[1] = var;
    const float lin = hq0 * P.mw2[t * 4 + o] + hq1 * P.mw2[t * 4 + 2 + o];
    const float mean = mo[0] + (lin + P.mb2[t * 2 + o]);
    h2[h_at(P, t, s, b, o)] = mean + sqrtf(fmaxf(var, kVarFloor)) * P.eps2[eps_at(P, t, s, o, b)];
  }
}

// the head at the sample rows of one 64-row tile: each row's variance and
// expected log-likelihood term, the terms added in row order into
// lpart[t][tile]
__global__ void __launch_bounds__(kRowTile)
elbo_fwd_head_kernel(Params P, const float* __restrict__ part, float* __restrict__ mom, float* __restrict__ lpart) {
  __shared__ float terms[kRowTile];
  const BwdLayout Lb(P.b, P.s);
  const int t = blockIdx.y, tile = blockIdx.x, q = tile * kRowTile + threadIdx.x;
  float term = 0.f;
  if (q < Lb.sb) {
    float* mo = mom_at(P, mom, t, 4, q);
    const float var = row_var(P, Lb, part, t, 4, q);
    mo[1] = var;
    const float noise = P.noise[t];
    const float d = P.y[static_cast<size_t>(t) * P.b + q % P.b] - (mo[0] + P.mbh[t]);
    term = -0.5f * (logf(kTwoPi * noise) + (d * d + fmaxf(var, kVarFloor)) / noise);
  }
  terms[threadIdx.x] = term;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int i = 0; i < kRowTile; ++i) sum += terms[i];
    lpart[static_cast<size_t>(t) * Lb.nt_sb + tile] = sum;
  }
}

// mom of every scratch row from the backward's own out scratch (column 0)
// and var partial: what the backward recomputes, for a check against the
// forward's
__global__ void __launch_bounds__(kThreads)
elbo_moments_kernel(Params P, const float* __restrict__ oscr, const float* __restrict__ part, float* __restrict__ mom) {
  const BwdLayout Lb(P.b, P.s);
  const int t = blockIdx.y, row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= static_cast<int>(scratch_rows(P))) return;
  int g = 0;
  while (g < kGroups - 1 && row >= rowbase(P, g + 1)) ++g;
  float* mo = mom + (static_cast<size_t>(t) * scratch_rows(P) + row) * 2;
  mo[0] = oscr[(static_cast<size_t>(t) * scratch_rows(P) + row) * P.ld];
  mo[1] = row_var(P, Lb, part, t, g, row - rowbase(P, g));
}

// out -> outbar in place at scratch row `row` of group g, one warp, 16
// bytes a lane a step: [meanbar, 2 varbar out_S, -2 varbar out_A]; the
// columns past P stay zero
__device__ __forceinline__ void to_outbar(const Params& P, float* oscr, int t, int g, int row, float mb, float vb) {
  float4* o = reinterpret_cast<float4*>(oscr + (static_cast<size_t>(t) * scratch_rows(P) + rowbase(P, g) + row) * P.ld);
  for (int c4 = threadIdx.x & 31; c4 < P.ld / 4; c4 += 32) {
    float4 v = o[c4];
    float* e = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 4 * c4 + u;
      e[u] = c == 0 ? mb : (c <= P.m ? 2.0f * vb * e[u] : -2.0f * vb * e[u]);
    }
    o[c4] = v;
  }
}

// The head's cotangents, a warp a sample row q: meanbar, varbar (zero where
// the variance is on the floor), and this row's noisebar and ybar terms
__global__ void __launch_bounds__(kThreads)
elbo_bwd_head_kernel(Params P, const float* __restrict__ gbar, float* __restrict__ oscr, float* __restrict__ part) {
  const BwdLayout Lb(P.b, P.s);
  const int t = blockIdx.y, lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= Lb.sb) return;
  float mb = 0.f, vb = 0.f;
  if (lane == 0) {
    const float noise = P.noise[t], coef = gbar[t] / static_cast<float>(P.s * P.b);
    const float* o = oscr + (static_cast<size_t>(t) * scratch_rows(P) + rowbase(P, 4) + q) * P.ld;
    const float yv = P.y[static_cast<size_t>(t) * P.b + q % P.b];
    const float mh = o[0] + P.mbh[t];
    const float vhu = row_var(P, Lb, part, t, 4, q);
    const float diff = mh - yv;
    mb = coef * (-diff / noise);
    vb = vhu > kVarFloor ? coef * (-0.5f / noise) : 0.f;
    float* h = part + static_cast<size_t>(t) * Lb.total + Lb.head + static_cast<size_t>(q) * 4;
    h[0] = mb;
    h[1] = vb;
    h[2] = coef * (-0.5f / noise + 0.5f * ((yv - mh) * (yv - mh) + fmaxf(vhu, kVarFloor)) / (noise * noise));
    h[3] = coef * (diff / noise);
  }
  mb = __shfl_sync(0xffffffffu, mb, 0);
  vb = __shfl_sync(0xffffffffu, vb, 0);
  __syncwarp();
  to_outbar(P, oscr, t, 4, q, mb, vb);
}

// kbar = outbar W^T over one (64-row, 128-inducing-point) tile of group g
// (blockIdx.x: which half of the inducing points), then g = kbar * K_xz:
// the input cotangent's part from this half (-(sum g h - sum g z) / l^2,
// a row's sums over the warp's lanes) into hbar[half][row][d] if given,
// and the column sums of g, g h and g (h - z)^2 over the tile's rows (the
// warps in order) into the col partial.
__global__ void __launch_bounds__(kThreads, 2)
elbo_bwd_pull_kernel(Params P, int g0, const float* __restrict__ h1, const float* __restrict__ h2,
                     const float* __restrict__ kscr, const float* __restrict__ oscr, float* __restrict__ part,
                     size_t hbar_at) {
  __shared__ __align__(16) float ring[kRing * kSlabFloats];
  const BwdLayout Lb(P.b, P.s);
  const int half = blockIdx.x, t = blockIdx.z, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int g, tile;
  group_tile(Lb, g0, blockIdx.y, g, tile);
  const int tg = t * kGroups + g, nrows = Lb.rows(g), r0 = tile * kRowTile, mbase = half * kColTile;
  const size_t row0 = static_cast<size_t>(t) * scratch_rows(P) + rowbase(P, g) + r0;
  const float* O = oscr + row0 * P.ld;
  const float* W = P.w + static_cast<size_t>(tg) * P.m * P.p;
  auto load = [&](int s, float* st) {
    float* as = st;
    float* bs = st + kSlabK * kALd;
    const int p0 = s * kSlabK;
#pragma unroll
    for (int q = 0; q < kSlabK * kRowTile / kThreads; ++q) {  // A(k = p, i = r) = outbar[r][p]
      const int e = threadIdx.x + q * kThreads, i = e / kSlabK, kk = e % kSlabK;
      const bool ok = r0 + i < nrows && p0 + kk < P.p;
      cp_async4(as + kk * kALd + i, ok ? O + static_cast<size_t>(i) * P.ld + p0 + kk : O, ok);
    }
#pragma unroll
    for (int q = 0; q < kSlabK * kColTile / kThreads; ++q) {  // B(k = p, j = m) = W[m][p]
      const int e = threadIdx.x + q * kThreads, j = e / kSlabK, kk = e % kSlabK;
      const bool ok = mbase + j < P.m && p0 + kk < P.p;
      cp_async4(bs + kk * kBLd + j, ok ? W + static_cast<size_t>(mbase + j) * P.p + p0 + kk : W, ok);
    }
  };
  float acc[8][4];
  tile_product(ring, (P.p + kSlabK - 1) / kSlabK, load, acc);

  const float e0 = P.ell[tg * 2], e1 = P.ell[tg * 2 + 1];
  const float il0 = 1.0f / (e0 * e0), il1 = 1.0f / (e1 * e1);
  const int m0 = mbase + lane * 4;
  float z0[4], z1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = m0 + j < P.m;
    z0[j] = live ? P.z[(static_cast<size_t>(tg) * P.m + m0 + j) * 2] : 0.f;
    z1[j] = live ? P.z[(static_cast<size_t>(tg) * P.m + m0 + j) * 2 + 1] : 0.f;
  }
  const float* hrow = group_h(P, h1, h2, t, g);
  float cs[4][kColSums];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int u = 0; u < kColSums; ++u) cs[j][u] = 0.f;
  float* pp = part + static_cast<size_t>(t) * Lb.total;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + warp * 8 + i;
    if (r >= nrows) break;  // uniform over the warp
    float kv[4] = {0.f, 0.f, 0.f, 0.f};
    if (m0 < P.m) {
      const float4 k4 = *reinterpret_cast<const float4*>(kscr + (row0 + warp * 8 + i) * P.kld + m0);
      kv[0] = k4.x;
      kv[1] = k4.y;
      kv[2] = k4.z;
      kv[3] = k4.w;
    }
    const float hr0 = hrow[static_cast<size_t>(r) * 2], hr1 = hrow[static_cast<size_t>(r) * 2 + 1];
    float rs0 = 0.f, rs1 = 0.f, rs2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float gv = acc[i][j] * kv[j];  // zero past M
      rs0 += gv;
      rs1 += gv * z0[j];
      rs2 += gv * z1[j];
      cs[j][0] += gv;
      cs[j][1] += gv * hr0;
      cs[j][2] += gv * hr1;
      cs[j][3] += gv * ((hr0 - z0[j]) * (hr0 - z0[j]));
      cs[j][4] += gv * ((hr1 - z1[j]) * (hr1 - z1[j]));
    }
    if (hbar_at) {
      rs0 = warp_sum(rs0);
      rs1 = warp_sum(rs1);
      rs2 = warp_sum(rs2);
      if (lane == 0) {
        float* hb = pp + hbar_at + ((static_cast<size_t>(g - g0) * 2 + half) * Lb.sb + r) * 2;
        hb[0] = -(rs0 * hr0 - rs1) * il0;
        hb[1] = -(rs0 * hr1 - rs2) * il1;
      }
    }
  }
  float* red = ring;  // [warp][m][kColSums]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int u = 0; u < kColSums; ++u) red[(warp * kColTile + lane * 4 + j) * kColSums + u] = cs[j][u];
  __syncthreads();
  if (threadIdx.x < kColTile && mbase + static_cast<int>(threadIdx.x) < P.m) {
    const int m = threadIdx.x;
    float* col = pp + Lb.col + (static_cast<size_t>(Lb.tile0(g) + tile) * kMaxM + mbase + m) * kColSums;
#pragma unroll
    for (int u = 0; u < kColSums; ++u) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += red[(w * kColTile + m) * kColSums + u];
      col[u] = v;
    }
  }
}

// Layer 2's cotangents, a warp a sample row q: h2bar from the head's two
// halves in order, then per output o meanbar = h2bar[o] and varbar =
// meanbar eps2 / (2 sqrt(max(var, floor))) (zero on the floor), outbar;
// h1bar's part through the mean weights
__global__ void __launch_bounds__(kThreads)
elbo_bwd_layer2_kernel(Params P, float* __restrict__ oscr, float* __restrict__ part) {
  const BwdLayout Lb(P.b, P.s);
  const int t = blockIdx.y, lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= Lb.sb) return;
  float* pp = part + static_cast<size_t>(t) * Lb.total;
  float mb[2] = {0.f, 0.f}, vb[2] = {0.f, 0.f};
  if (lane == 0) {
    const int s = q / P.b, b = q % P.b;
    float lin0 = 0.f, lin1 = 0.f;
    for (int o = 0; o < 2; ++o) {
      mb[o] = pp[Lb.hb_head + static_cast<size_t>(q) * 2 + o] + pp[Lb.hb_head + (static_cast<size_t>(Lb.sb) + q) * 2 + o];
      const float v2u = row_var(P, Lb, part, t, 2 + o, q);
      const float v2b = mb[o] * P.eps2[eps_at(P, t, s, o, b)] * 0.5f / sqrtf(fmaxf(v2u, kVarFloor));
      vb[o] = v2u > kVarFloor ? v2b : 0.f;
      lin0 += mb[o] * P.mw2[t * 4 + o];
      lin1 += mb[o] * P.mw2[t * 4 + 2 + o];
      float* l2 = pp + Lb.l2 + (static_cast<size_t>(o) * Lb.sb + q) * 2;
      l2[0] = mb[o];
      l2[1] = vb[o];
    }
    pp[Lb.h1lin + static_cast<size_t>(q) * 2] = lin0;
    pp[Lb.h1lin + static_cast<size_t>(q) * 2 + 1] = lin1;
  }
  for (int o = 0; o < 2; ++o) {
    const float m_o = __shfl_sync(0xffffffffu, mb[o], 0), v_o = __shfl_sync(0xffffffffu, vb[o], 0);
    to_outbar(P, oscr, t, 2 + o, q, m_o, v_o);
  }
}

// Layer 1's cotangents, a warp an x row b: h1bar of each of its samples
// (the mean weights' part, then layer 2's two groups, each W half in
// order), summed over the samples into meanbar and varbar (zero on the
// floor), outbar
__global__ void __launch_bounds__(kThreads)
elbo_bwd_layer1_kernel(Params P, float* __restrict__ oscr, float* __restrict__ part) {
  const BwdLayout Lb(P.b, P.s);
  const int t = blockIdx.y, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= P.b) return;
  float* pp = part + static_cast<size_t>(t) * Lb.total;
  float mb[2] = {0.f, 0.f}, vb[2] = {0.f, 0.f};
  if (lane == 0) {
    float v1u[2], sd1[2];
    for (int o = 0; o < 2; ++o) {
      v1u[o] = row_var(P, Lb, part, t, o, b);
      sd1[o] = sqrtf(fmaxf(v1u[o], kVarFloor));
    }
    float m1[2] = {0.f, 0.f}, v1[2] = {0.f, 0.f};
    for (int s = 0; s < P.s; ++s) {
      const int q = s * P.b + b;
      for (int o = 0; o < 2; ++o) {
        float hb = pp[Lb.h1lin + static_cast<size_t>(q) * 2 + o];
        for (int k = 0; k < 4; ++k) hb += pp[Lb.hb_l2 + (static_cast<size_t>(k) * Lb.sb + q) * 2 + o];
        m1[o] += hb;
        v1[o] += hb * P.eps1[eps_at(P, t, s, o, b)] * 0.5f / sd1[o];
      }
    }
    for (int o = 0; o < 2; ++o) {
      mb[o] = m1[o];
      vb[o] = v1u[o] > kVarFloor ? v1[o] : 0.f;
      float* l1 = pp + Lb.l1 + (static_cast<size_t>(o) * P.b + b) * 2;
      l1[0] = mb[o];
      l1[1] = vb[o];
    }
  }
  for (int o = 0; o < 2; ++o) {
    const float m_o = __shfl_sync(0xffffffffu, mb[o], 0), v_o = __shfl_sync(0xffffffffu, vb[o], 0);
    to_outbar(P, oscr, t, o, b, m_o, v_o);
  }
}

// Wbar[t][g][i][c] = sum over the group's scratch rows k of K[k][i] outbar[k][c]:
// one 128 x 128 output tile a block, 256 threads, each an 8 x 8 FFMA
// micro-tile (rows ty 4 + {0..3} and 64 + ty 4 + {0..3}, columns likewise
// in tx); 16-row slabs of both operands through a 3-stage cp.async ring of
// 16-byte copies (the scratch rows are 16-byte aligned: strides P.kld and
// P.ld); each entry summed over the rows in ascending order.
__global__ void __launch_bounds__(kWbarThreads, 2)
elbo_wbar_kernel(Params P, const float* __restrict__ kscr, const float* __restrict__ oscr,
                 float* __restrict__ wbar) {
  extern __shared__ __align__(16) float wsm[];
  float* as = wsm;                                  // [stage][kk][ii] = K[k0 + kk][i0 + ii]
  float* bs = wsm + kRing * kWbarK * kWbarTile;     // [stage][kk][cc] = outbar[k0 + kk][c0 + cc]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * kWbarTile, i0 = blockIdx.y * kWbarTile;
  const int t = blockIdx.z / kGroups, g = blockIdx.z % kGroups;
  const int nrows = g < 2 ? P.b : P.s * P.b;
  const size_t base = static_cast<size_t>(t) * scratch_rows(P) + rowbase(P, g);
  const float* K = kscr + base * P.kld;
  const float* O = oscr + base * P.ld;
  float* W = wbar + static_cast<size_t>(t * kGroups + g) * P.m * P.p;
  const int nslab = (nrows + kWbarK - 1) / kWbarK;

  auto load = [&](int sl) {
    float* a = as + (sl % kRing) * kWbarK * kWbarTile;
    float* b = bs + (sl % kRing) * kWbarK * kWbarTile;
#pragma unroll
    for (int q = 0; q < kWbarK * kWbarTile / 4 / kWbarThreads; ++q) {
      const int e = tid + q * kWbarThreads;
      const int kk = e / (kWbarTile / 4), c4 = 4 * (e % (kWbarTile / 4));
      const int k = sl * kWbarK + kk;
      const bool row = k < nrows;
      const int ab = row ? max(0, min(16, 4 * (P.kld - (i0 + c4)))) : 0;
      const int bb = row ? max(0, min(16, 4 * (P.ld - (c0 + c4)))) : 0;
      cp_async16z(a + kk * kWbarTile + c4, ab ? K + static_cast<size_t>(k) * P.kld + i0 + c4 : K, ab);
      cp_async16z(b + kk * kWbarTile + c4, bb ? O + static_cast<size_t>(k) * P.ld + c0 + c4 : O, bb);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int sl = 0; sl < kRing - 1; ++sl) {
    if (sl < nslab) load(sl);
    cp_async_commit();
  }
  for (int sl = 0; sl < nslab; ++sl) {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    if (sl + kRing - 1 < nslab) load(sl + kRing - 1);
    cp_async_commit();
    const float* a = as + (sl % kRing) * kWbarK * kWbarTile;
    const float* b = bs + (sl % kRing) * kWbarK * kWbarTile;
#pragma unroll
    for (int kk = 0; kk < kWbarK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kWbarTile + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + kk * kWbarTile + kWbarTile / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + kk * kWbarTile + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b + kk * kWbarTile + kWbarTile / 2 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ii = i0 + (i < 4 ? 0 : kWbarTile / 2) + ty * 4 + (i & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = c0 + (j < 4 ? 0 : kWbarTile / 2) + tx * 4 + (j & 3);
      if (ii < P.m && cc < P.p) W[static_cast<size_t>(ii) * P.p + cc] = acc[i][j];
    }
  }
}

// The small cotangents of member blockIdx.x from the partials, each sum in
// a fixed order: z-bar per (group, m) over the row tiles; per group the ell
// and s2 terms over m; over the rows, the mean weights, mbh, sigma2-bar and
// each group's varbar (for s2-bar); ybar per x row over its samples.  A
// sum over m or over rows runs in two stages: each thread its strided
// share in order, then a fixed tree over the block.  small: z-bar (5, M, 2),
// then kSlots.
constexpr int kRowSums = 19;  // layer 1: mw1 (4), mb1 (2), varbar (2); layer 2: the same; head: mbh, sigma2, varbar

__device__ void tree_sum(float (*red)[kRowSums], int nq) {
  for (int w = kThreads / 2; w >= 1; w >>= 1) {
    if (static_cast<int>(threadIdx.x) < w)
      for (int u = 0; u < nq; ++u) red[threadIdx.x][u] += red[threadIdx.x + w][u];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
elbo_bwd_reduce_kernel(Params P, const float* __restrict__ h1, const float* __restrict__ part,
                       float* __restrict__ small, float* __restrict__ ybar) {
  __shared__ float red[kThreads][kRowSums];
  const BwdLayout Lb(P.b, P.s);
  const int t = blockIdx.x, tid = threadIdx.x;
  const float* pp = part + static_cast<size_t>(t) * Lb.total;
  float* out = small + static_cast<size_t>(t) * (kGroups * P.m * 2 + kSlots);
  float* slots = out + kGroups * P.m * 2;
  float ms[kGroups][3];  // per group: sum of g, g (h0 - z0)^2, g (h1 - z1)^2 over the rows and m
  for (int g = 0; g < kGroups; ++g) {
    const int tg = t * kGroups + g;
    float c[kColSums] = {0.f, 0.f, 0.f, 0.f, 0.f};
    const int m = tid;
    if (m < P.m) {
      for (int tile = 0; tile < Lb.tiles(g); ++tile) {
        const float* col = pp + Lb.col + (static_cast<size_t>(Lb.tile0(g) + tile) * kMaxM + m) * kColSums;
#pragma unroll
        for (int u = 0; u < kColSums; ++u) c[u] += col[u];
      }
      const float e0 = P.ell[tg * 2], e1 = P.ell[tg * 2 + 1];
      const float z0 = P.z[(static_cast<size_t>(tg) * P.m + m) * 2], z1 = P.z[(static_cast<size_t>(tg) * P.m + m) * 2 + 1];
      out[(g * P.m + m) * 2] = -(c[0] * z0 - c[1]) / (e0 * e0);
      out[(g * P.m + m) * 2 + 1] = -(c[0] * z1 - c[2]) / (e1 * e1);
    }
    ms[g][0] = c[0];
    ms[g][1] = c[3];
    ms[g][2] = c[4];
  }
  for (int g = 0; g < kGroups; ++g)
    for (int u = 0; u < 3; ++u) red[tid][g * 3 + u] = ms[g][u];
  __syncthreads();
  tree_sum(red, kGroups * 3);
  for (int g = 0; g < kGroups; ++g)
    for (int u = 0; u < 3; ++u) ms[g][u] = red[0][g * 3 + u];
  __syncthreads();

  float acc[kRowSums];
#pragma unroll
  for (int u = 0; u < kRowSums; ++u) acc[u] = 0.f;
  for (int b = tid; b < P.b; b += kThreads) {
    const float x0 = P.x[(static_cast<size_t>(t) * P.b + b) * 2], x1 = P.x[(static_cast<size_t>(t) * P.b + b) * 2 + 1];
    for (int o = 0; o < 2; ++o) {
      const float* l1 = pp + Lb.l1 + (static_cast<size_t>(o) * P.b + b) * 2;
      acc[o] += x0 * l1[0];      // mw1[0][o]
      acc[2 + o] += x1 * l1[0];  // mw1[1][o]
      acc[4 + o] += l1[0];       // mb1[o]
      acc[6 + o] += l1[1];       // varbar of group o
    }
  }
  for (int q = tid; q < Lb.sb; q += kThreads) {
    const float x0 = h1[(static_cast<size_t>(t) * Lb.sb + q) * 2], x1 = h1[(static_cast<size_t>(t) * Lb.sb + q) * 2 + 1];
    for (int o = 0; o < 2; ++o) {
      const float* l2 = pp + Lb.l2 + (static_cast<size_t>(o) * Lb.sb + q) * 2;
      acc[8 + o] += x0 * l2[0];
      acc[10 + o] += x1 * l2[0];
      acc[12 + o] += l2[0];
      acc[14 + o] += l2[1];
    }
    const float* hd = pp + Lb.head + static_cast<size_t>(q) * 4;
    acc[16] += hd[0];  // mbh
    acc[17] += hd[2];  // sigma2-bar
    acc[18] += hd[1];  // varbar of the head
  }
#pragma unroll
  for (int u = 0; u < kRowSums; ++u) red[tid][u] = acc[u];
  __syncthreads();
  tree_sum(red, kRowSums);
  if (tid == 0) {
    const float* r = red[0];
    for (int o = 0; o < 2; ++o) {
      slots[kSlotMw1 + o] = r[o];
      slots[kSlotMw1 + 2 + o] = r[2 + o];
      slots[kSlotMb1 + o] = r[4 + o];
      slots[kSlotMw2 + o] = r[8 + o];
      slots[kSlotMw2 + 2 + o] = r[10 + o];
      slots[kSlotMb2 + o] = r[12 + o];
    }
    slots[kSlotMbh] = r[16];
    slots[kSlotNoise] = r[17];
    const float vb[kGroups] = {r[6], r[7], r[14], r[15], r[18]};
    for (int g = 0; g < kGroups; ++g) {
      const int tg = t * kGroups + g;
      const float e0 = P.ell[tg * 2], e1 = P.ell[tg * 2 + 1];
      slots[kSlotEll + g * 2] = ms[g][1] / (e0 * e0 * e0);
      slots[kSlotEll + g * 2 + 1] = ms[g][2] / (e1 * e1 * e1);
      slots[kSlotS2 + g] = ms[g][0] / P.s2[tg] + vb[g];
    }
  }
  for (int b = tid; b < P.b; b += kThreads) {
    float acc_y = 0.f;
    for (int s = 0; s < P.s; ++s) acc_y += pp[Lb.head + (static_cast<size_t>(s) * P.b + b) * 4 + 3];
    ybar[static_cast<size_t>(t) * P.b + b] = acc_y;
  }
}

cudaError_t prepare(Params& P, const void* const* in, int t, int b, int s, int m) {
  if (t < 1 || t * kGroups > 65535 || b < 1 || b > kMaxB || s < 1 || m < 1 || m > kMaxM) return cudaErrorInvalidValue;
  P.x = static_cast<const float*>(in[0]);
  P.y = static_cast<const float*>(in[1]);
  P.eps1 = static_cast<const float*>(in[2]);
  P.eps2 = static_cast<const float*>(in[3]);
  P.z = static_cast<const float*>(in[4]);
  P.ell = static_cast<const float*>(in[5]);
  P.s2 = static_cast<const float*>(in[6]);
  P.w = static_cast<const float*>(in[7]);
  P.mw1 = static_cast<const float*>(in[8]);
  P.mb1 = static_cast<const float*>(in[9]);
  P.mw2 = static_cast<const float*>(in[10]);
  P.mb2 = static_cast<const float*>(in[11]);
  P.mbh = static_cast<const float*>(in[12]);
  P.noise = static_cast<const float*>(in[13]);
  P.t = t;
  P.b = b;
  P.s = s;
  P.m = m;
  P.p = 2 * m + 1;
  P.ld = (P.p + 3) / 4 * 4;
  P.kld = (m + 3) / 4 * 4;
  return cudaSuccess;
}

// The marginals of groups [g0, g1) at every row, two launches on `st`: K_xz
// into kscr, then out = K_xz W with each row's sums of squares per column
// tile into part's var region, out itself into oscr and the means into mom
// where given.  Both passes call this, so their marginals are the same bits.
void launch_marginals(const Params& P, int g0, int g1, const float* h1, const float* h2, float* kscr, float* oscr,
                      float* part, float* mom, cudaStream_t st) {
  const BwdLayout Lb(P.b, P.s);
  const size_t end = g1 < kGroups ? static_cast<size_t>(rowbase(P, g1)) : scratch_rows(P);
  const size_t kel = (end - rowbase(P, g0)) * P.kld;
  elbo_k_kernel<<<dim3(static_cast<unsigned>((kel + kThreads - 1) / kThreads), P.t), kThreads, 0, st>>>(
      P, g0, g1, h1, h2, kscr);
  int tiles = 0;
  for (int g = g0; g < g1; ++g) tiles += Lb.tiles(g);
  elbo_out_kernel<<<dim3((P.p + kColTile - 1) / kColTile, tiles, P.t), kThreads, 0, st>>>(P, g0, kscr, oscr, part,
                                                                                          mom);
}

}  // namespace

extern "C" {

// the length of a member's small cotangents (z-bar, then kSlots scalars)
int elbo_small_len(int m) { return kGroups * m * 2 + kSlots; }
// both passes' small scratch per member, in floats, the forward's
// log-likelihood tiles per member, and the row strides of the out and K_xz
// scratch
int elbo_partial_len(int b, int s) { return static_cast<int>(BwdLayout(b, s).total); }
int elbo_fwd_tiles(int b, int s) { return BwdLayout(b, s).nt_sb; }
int elbo_out_ld(int m) { return (2 * m + 1 + 3) / 4 * 4; }
int elbo_k_ld(int m) { return (m + 3) / 4 * 4; }
// dynamic shared memory of the backward's Wbar kernel; the others' is static
int elbo_wbar_smem() { return 2 * kRing * kWbarK * kWbarTile * static_cast<int>(sizeof(float)); }

// The forward: kscr (T, 2B + 3SB, elbo_k_ld(M)), partial (T,
// elbo_partial_len(B, S)) and lpart (T, elbo_fwd_tiles(B, S)) scratch; mom
// (T, 2B + 3SB, 2), each scratch row's mean and unclipped variance, dt (T,),
// h1, h2 (T, S, B, 2) out.  Ten launches in turn on `stream`, one layer a
// phase; returns the first launch error as an int (0 = launched).
int elbo_fwd(const void* x, const void* y, const void* eps1, const void* eps2, const void* z, const void* ell,
             const void* s2, const void* w, const void* mw1, const void* mb1, const void* mw2, const void* mb2,
             const void* mbh, const void* noise, void* kscr, void* partial, void* mom, void* lpart, void* dt,
             void* h1, void* h2, int t, int b, int s, int m, void* stream) {
  const void* in[14] = {x, y, eps1, eps2, z, ell, s2, w, mw1, mb1, mw2, mb2, mbh, noise};
  Params P;
  cudaError_t e = prepare(P, in, t, b, s, m);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdLayout Lb(b, s);
  float* pk = static_cast<float*>(kscr);
  float* pp = static_cast<float*>(partial);
  float* pm = static_cast<float*>(mom);
  float* lp = static_cast<float*>(lpart);
  float* ph1 = static_cast<float*>(h1);
  float* ph2 = static_cast<float*>(h2);
  launch_marginals(P, 0, 2, ph1, ph2, pk, nullptr, pp, pm, st);
  elbo_fwd_layer1_kernel<<<dim3((b + kThreads - 1) / kThreads, t), kThreads, 0, st>>>(P, pp, pm, ph1);
  launch_marginals(P, 2, 4, ph1, ph2, pk, nullptr, pp, pm, st);
  elbo_fwd_layer2_kernel<<<dim3((Lb.sb + kThreads - 1) / kThreads, t), kThreads, 0, st>>>(P, pp, ph1, pm, ph2);
  launch_marginals(P, 4, kGroups, ph1, ph2, pk, nullptr, pp, pm, st);
  elbo_fwd_head_kernel<<<dim3(Lb.nt_sb, t), kRowTile, 0, st>>>(P, pp, pm, lp);
  elbo_sum_kernel<<<(t + 127) / 128, 128, 0, st>>>(lp, static_cast<float*>(dt), t, Lb.nt_sb,
                                                   static_cast<float>(s) * static_cast<float>(b));
  return static_cast<int>(cudaGetLastError());
}

// The backward, given the forward's h1, h2 and the output cotangent gbar
// (T,): kscr (T, 2B + 3SB, elbo_k_ld(M)), oscr (T, 2B + 3SB,
// elbo_out_ld(M)) and partial (T, elbo_partial_len(B, S)) scratch;
// wbar (T, 5, M, P), small (T, elbo_small_len(M)) and ybar (T, B) out.
// Ten launches in turn on `stream`; returns the first launch error as an
// int (0 = launched).
int elbo_bwd(const void* x, const void* y, const void* eps1, const void* eps2, const void* z, const void* ell,
             const void* s2, const void* w, const void* mw1, const void* mb1, const void* mw2, const void* mb2,
             const void* mbh, const void* noise, const void* h1, const void* h2, const void* gbar, void* kscr,
             void* oscr, void* partial, void* wbar, void* small, void* ybar, int t, int b, int s, int m,
             void* stream) {
  const void* in[14] = {x, y, eps1, eps2, z, ell, s2, w, mw1, mb1, mw2, mb2, mbh, noise};
  Params P;
  cudaError_t e = prepare(P, in, t, b, s, m);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdLayout Lb(b, s);
  const float* ph1 = static_cast<const float*>(h1);
  const float* ph2 = static_cast<const float*>(h2);
  float* pk = static_cast<float*>(kscr);
  float* po = static_cast<float*>(oscr);
  float* pp = static_cast<float*>(partial);
  launch_marginals(P, 0, kGroups, ph1, ph2, pk, po, pp, nullptr, st);
  const unsigned sb_blocks = (Lb.sb + kWarps - 1) / kWarps;
  elbo_bwd_head_kernel<<<dim3(sb_blocks, t), kThreads, 0, st>>>(P, static_cast<const float*>(gbar), po, pp);
  elbo_bwd_pull_kernel<<<dim3(2, Lb.nt_sb, t), kThreads, 0, st>>>(P, 4, ph1, ph2, pk, po, pp, Lb.hb_head);
  elbo_bwd_layer2_kernel<<<dim3(sb_blocks, t), kThreads, 0, st>>>(P, po, pp);
  elbo_bwd_pull_kernel<<<dim3(2, 2 * Lb.nt_sb, t), kThreads, 0, st>>>(P, 2, ph1, ph2, pk, po, pp, Lb.hb_l2);
  elbo_bwd_layer1_kernel<<<dim3((b + kWarps - 1) / kWarps, t), kThreads, 0, st>>>(P, po, pp);
  elbo_bwd_pull_kernel<<<dim3(2, 2 * Lb.nt_b, t), kThreads, 0, st>>>(P, 0, ph1, ph2, pk, po, pp, 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int wbytes = elbo_wbar_smem();
  e = cudaFuncSetAttribute(elbo_wbar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wbytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((P.p + kWbarTile - 1) / kWbarTile, (m + kWbarTile - 1) / kWbarTile, t * kGroups);
  elbo_wbar_kernel<<<grid, kWbarThreads, wbytes, st>>>(P, pk, po, static_cast<float*>(wbar));
  elbo_bwd_reduce_kernel<<<t, kThreads, 0, st>>>(P, ph1, pp, static_cast<float*>(small), static_cast<float*>(ybar));
  return static_cast<int>(cudaGetLastError());
}

// The backward's own recomputation of the marginals, for a check against
// the forward's: its first two launches (launch_marginals over every
// group, as elbo_bwd makes them, into kscr, oscr and partial as there),
// then mom (T, 2B + 3SB, 2) from oscr's column 0 and the var partial.
// Returns the first launch error as an int (0 = launched).
int elbo_bwd_moments(const void* x, const void* y, const void* eps1, const void* eps2, const void* z,
                     const void* ell, const void* s2, const void* w, const void* mw1, const void* mb1,
                     const void* mw2, const void* mb2, const void* mbh, const void* noise, const void* h1,
                     const void* h2, void* kscr, void* oscr, void* partial, void* mom, int t, int b, int s, int m,
                     void* stream) {
  const void* in[14] = {x, y, eps1, eps2, z, ell, s2, w, mw1, mb1, mw2, mb2, mbh, noise};
  Params P;
  cudaError_t e = prepare(P, in, t, b, s, m);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(oscr);
  float* pp = static_cast<float*>(partial);
  launch_marginals(P, 0, kGroups, static_cast<const float*>(h1), static_cast<const float*>(h2),
                   static_cast<float*>(kscr), po, pp, nullptr, st);
  elbo_moments_kernel<<<dim3(static_cast<unsigned>((scratch_rows(P) + kThreads - 1) / kThreads), t), kThreads, 0,
                        st>>>(P, po, pp, static_cast<float*>(mom));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
