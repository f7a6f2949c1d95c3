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
// Forward: elbo_fwd_kernel, one 256-thread block per (x-row tile, member).
// A tile holds XR = max(1, 32 / S) x rows and all S samples of each, so the
// chain layer 1 -> layer 2 -> head -> likelihood runs inside the block; the
// S * XR sample rows go through in chunks of 32.  Per group, K_xz (rows x M)
// is built in shared memory (thread m owns inducing point m), then
// out = K_xz W with one thread per two columns of W, W read from L2 (it
// does not fit in shared memory), and out is reduced at once to its mean (column 0)
// and the sums of squares of its two halves: a warp transpose-reduction,
// then a fixed-order sum over the 8 warps.  Each block writes its partial
// sum of the log-likelihood terms; elbo_sum_kernel adds them in tile order.
//
// Backward: elbo_bwd_kernel, the same blocks, recomputes each group's K_xz
// and out, writes K_xz and out to scratch, turns out into outbar in place
// once the row's cotangents are known, forms kbar = outbar W^T with W
// staged through shared memory 32 columns at a time (thread m owns row m
// of W), and from g = kbar * K_xz the input cotangent (row sums over m,
// transpose-reduced) and this block's z, ell and s2 cotangents.  Layer 1's
// mean and variance cotangents are summed over each x row's samples inside
// the block.  elbo_wbar_kernel then forms Wbar = K_xz^T outbar per group as
// 64 x 64 tiles summed over rows in ascending order, and elbo_small_kernel
// adds the blocks' small partials in tile order.  No atomics: every sum has
// a fixed order, so a result is the same bits on every run.
//
// Ghost rows (past B, or past a chunk's end) have K_xz = 0, so they add
// nothing to any product; columns past P and inducing points past M are
// masked.  Plain f32 throughout: IEEE division, expf, sqrtf, logf, no
// tensor cores.  Variances are clamped at 1e-10 in the forward; the
// backward takes sqrt(max(var, 1e-10)) and zeroes the variance cotangent
// where the unclipped variance is <= 1e-10, as the JAX package does.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 32;           // sample rows per chunk (one per lane in the reductions)
constexpr int kMaxM = kThreads;  // one thread per inducing point
constexpr int kMaxB = 1024;
constexpr int kGroups = 5;
constexpr int kKs = kR + 4;      // row stride of K_xz^T in shared memory (16-byte aligned)
constexpr int kWT = 32;          // W columns staged per step of kbar
constexpr int kObs = kR + 4;     // row stride of the staged outbar tile
constexpr int kWbarTile = 64;    // Wbar output tile edge
constexpr int kWbarK = 16;       // scratch rows staged per step of Wbar
constexpr int kWbarThreads = 256;
constexpr float kVarFloor = 1e-10f;
constexpr float kTwoPi = 6.28318530717958647692f;

// the per-block small partials: z-bar (5, M, 2) first, then these slots
constexpr int kSlotEll = 0;     // (5, 2)
constexpr int kSlotS2 = 10;     // (5,)
constexpr int kSlotMw1 = 15;    // (2, 2) [d][o]
constexpr int kSlotMb1 = 19;    // (2,)
constexpr int kSlotMw2 = 21;    // (2, 2)
constexpr int kSlotMb2 = 25;    // (2,)
constexpr int kSlotMbh = 27;
constexpr int kSlotNoise = 28;
constexpr int kSlots = 29;

static_assert(kR == 32, "the transpose reduction gives lane l row l");

struct Params {
  const float *x, *y, *eps1, *eps2, *z, *ell, *s2, *w, *mw1, *mb1, *mw2, *mb2,
      *mbh, *noise;
  int t, b, s, m, p, xr, ntiles;
};

struct Shared {
  float k[kMaxM * kKs];        // K_xz^T of the current group: k[m * kKs + r]
  float ob[kWT * kObs];        // staged outbar tile: ob[c * kObs + r]
  float wt[kMaxM * (kWT + 1)];  // staged W tile: wt[m * (kWT + 1) + c]
  float zacc[kGroups * kMaxM * 2];  // this block's z-bar per group
  float zr[kMaxM * 2];         // z of the current group
  float red[kWarps * 3 * kR];  // per-warp row sums
  float red3[kWarps * 4];      // per-warp block scalars
  float hx[kR * 2];            // the tile's x rows
  float h1[kR * 2];            // the chunk's layer-1 samples
  float h2[kR * 2];            // the chunk's layer-2 samples
  float h1bar[kR * 2];
  float h2bar[kR * 2];
  float mean[kR];              // the current group's mean (no prior mean)
  float var[kR];               // ... and unclipped variance
  float meanbar[kR];
  float varbar[kR];
  float tmpa[kR];
  float tmpb[kR];
  float ybar[kR];
  float m1[2 * kR];            // layer 1 per x row: mean (forward)
  float sd1[2 * kR];           // sqrt(max(var, floor))
  float v1u[2 * kR];           // unclipped variance (backward)
  float m1bar[2 * kR];
  float v1bar[2 * kR];
  float scal[32];              // this block's small partials (kSlots used)
};

__device__ __forceinline__ Shared& shared() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return *reinterpret_cast<Shared*>(smem_raw);
}

// lane l returns the sum over the warp's lanes of v[l]; v is destroyed
__device__ __forceinline__ float warp_transpose_sum(float (&v)[kR]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < off; ++i) {
      const float send = upper ? v[i] : v[i + off];
      const float keep = upper ? v[i + off] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int rowbase(const Params& P, int g) {
  // scratch rows per member: B for each layer-1 group, S * B for the others
  const int sb = P.s * P.b;
  return g < 2 ? g * P.b : 2 * P.b + (g - 2) * sb;
}

__device__ __forceinline__ size_t scratch_rows(const Params& P) {
  return static_cast<size_t>(2 * P.b + 3 * P.s * P.b);
}

// K_xz^T of group g at the first `nrows` rows of h (shared, [r][2]) into
// sh.k (zero for ghost rows and m >= M), and z of the group into sh.zr;
// if kscr is given, K_xz's rows go there too ([r][M]).
__device__ void build_k(Shared& sh, const Params& P, int t, int g, const float* h, int nrows, float* kscr) {
  const int m = threadIdx.x;
  const int tg = t * kGroups + g;
  const float e0 = P.ell[tg * 2], e1 = P.ell[tg * 2 + 1];
  const float s2v = P.s2[tg];
  float zs0 = 0.f, zs1 = 0.f, zsq = 0.f;
  if (m < P.m) {
    const float z0 = P.z[(static_cast<size_t>(tg) * P.m + m) * 2];
    const float z1 = P.z[(static_cast<size_t>(tg) * P.m + m) * 2 + 1];
    sh.zr[m * 2] = z0;
    sh.zr[m * 2 + 1] = z1;
    zs0 = z0 / e0;
    zs1 = z1 / e1;
    zsq = zs0 * zs0 + zs1 * zs1;
  } else {
    sh.zr[m * 2] = 0.f;
    sh.zr[m * 2 + 1] = 0.f;
  }
  for (int r = 0; r < kR; ++r) {
    float kv = 0.f;
    if (m < P.m && r < nrows) {
      const float xs0 = h[r * 2] / e0, xs1 = h[r * 2 + 1] / e1;
      const float xsq = xs0 * xs0 + xs1 * xs1;
      const float cross = xs0 * zs0 + xs1 * zs1;
      const float quad = fmaxf(xsq + zsq - 2.0f * cross, 0.f);
      kv = s2v * expf(-0.5f * quad);
      if (kscr) kscr[static_cast<size_t>(r) * P.m + m] = kv;
    }
    sh.k[m * kKs + r] = kv;
  }
  __syncthreads();
}

// One column c of out for the rows in sh.k: its mean (column 0) or its
// square into the sums of its half, and its rows into oscr if given.
__device__ __forceinline__ void take_column(Shared& sh, const Params& P, int c, int nrows, float* oscr,
                                            const float (&acc)[kR], float (&sas)[kR], float (&sa)[kR]) {
  if (c == 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r) sh.mean[r] = acc[r];
  } else if (c <= P.m) {
#pragma unroll
    for (int r = 0; r < kR; ++r) sas[r] += acc[r] * acc[r];
  } else {
#pragma unroll
    for (int r = 0; r < kR; ++r) sa[r] += acc[r] * acc[r];
  }
  if (oscr) {
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (r < nrows) oscr[static_cast<size_t>(r) * P.p + c] = acc[r];
  }
}

// out = K_xz W_g for the rows in sh.k, reduced to sh.mean (column 0) and
// sh.var (s2 - sum A^2 + sum (A S)^2, unclipped); if oscr is given, out's
// rows go there ([r][P], the first nrows rows).
__device__ void group_out(Shared& sh, const Params& P, int t, int g, int nrows, float* oscr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tg = t * kGroups + g;
  const float* wg = P.w + static_cast<size_t>(tg) * P.m * P.p;
  float sas[kR], sa[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) sas[r] = sa[r] = 0.f;
  // each thread takes two columns at once, c0 and c0 + kThreads (its
  // second one past P is computed on c0's data and dropped), so every
  // broadcast read of K_xz feeds two FMAs and two loads of W are in flight
  for (int c0 = tid; c0 < P.p; c0 += 2 * kThreads) {
    const int c1 = c0 + kThreads;
    const bool has1 = c1 < P.p;
    float acc0[kR], acc1[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc0[r] = acc1[r] = 0.f;
    const float* w0 = wg + c0;
    const float* w1 = wg + (has1 ? c1 : c0);
#pragma unroll 4
    for (int mm = 0; mm < P.m; ++mm) {
      const float wv0 = w0[static_cast<size_t>(mm) * P.p];
      const float wv1 = w1[static_cast<size_t>(mm) * P.p];
      const float4* kr = reinterpret_cast<const float4*>(sh.k + mm * kKs);
#pragma unroll
      for (int q = 0; q < kR / 4; ++q) {
        const float4 kv = kr[q];
        acc0[4 * q] += kv.x * wv0;
        acc0[4 * q + 1] += kv.y * wv0;
        acc0[4 * q + 2] += kv.z * wv0;
        acc0[4 * q + 3] += kv.w * wv0;
        acc1[4 * q] += kv.x * wv1;
        acc1[4 * q + 1] += kv.y * wv1;
        acc1[4 * q + 2] += kv.z * wv1;
        acc1[4 * q + 3] += kv.w * wv1;
      }
    }
    take_column(sh, P, c0, nrows, oscr, acc0, sas, sa);
    if (has1) take_column(sh, P, c1, nrows, oscr, acc1, sas, sa);
  }
  const float vas = warp_transpose_sum(sas);
  const float va = warp_transpose_sum(sa);
  sh.red[warp * 2 * kR + lane] = vas;
  sh.red[warp * 2 * kR + kR + lane] = va;
  __syncthreads();
  if (tid < kR) {
    float s_as = 0.f, s_a = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) {
      s_as += sh.red[wi * 2 * kR + tid];
      s_a += sh.red[wi * 2 * kR + kR + tid];
    }
    sh.var[tid] = (P.s2[tg] - s_a) + s_as;
  }
  __syncthreads();
}

// The pullback of group g's marginals at rows h (the K_xz in sh.k, out in
// oscr), given sh.meanbar and sh.varbar (already masked by the clip):
// outbar replaces out in oscr; hbar (if given) gets the input cotangent
// added; this block's z-bar, ell-bar and s2-bar of the group accumulate in
// sh.zacc and sh.scal.
__device__ void group_bwd(Shared& sh, const Params& P, int t, int g, const float* h, int nrows, float* oscr,
                          float* hbar) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tg = t * kGroups + g;
  const float* wg = P.w + static_cast<size_t>(tg) * P.m * P.p;
  // (1) out -> outbar, each thread its own entries of group_out
  for (int c = tid; c < P.p; c += kThreads) {
    for (int r = 0; r < nrows; ++r) {
      float* o = oscr + static_cast<size_t>(r) * P.p + c;
      if (c == 0) *o = sh.meanbar[r];
      else if (c <= P.m) *o = 2.0f * sh.varbar[r] * *o;
      else *o = -2.0f * sh.varbar[r] * *o;
    }
  }
  __syncthreads();
  // (2) kbar[r][m] = sum_c outbar[r][c] W[m][c], thread m
  float acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0.f;
  for (int c0 = 0; c0 < P.p; c0 += kWT) {
    for (int idx = tid; idx < kMaxM * kWT; idx += kThreads) {
      const int mm = idx / kWT, cc = idx % kWT;
      sh.wt[mm * (kWT + 1) + cc] =
          (mm < P.m && c0 + cc < P.p) ? wg[static_cast<size_t>(mm) * P.p + c0 + cc] : 0.f;
    }
    for (int idx = tid; idx < kR * kWT; idx += kThreads) {
      const int r = idx / kWT, cc = idx % kWT;
      sh.ob[cc * kObs + r] = (r < nrows && c0 + cc < P.p) ? oscr[static_cast<size_t>(r) * P.p + c0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < kWT; ++cc) {
      const float wv = sh.wt[tid * (kWT + 1) + cc];
      const float4* obr = reinterpret_cast<const float4*>(sh.ob + cc * kObs);
#pragma unroll
      for (int q = 0; q < kR / 4; ++q) {
        const float4 ov = obr[q];
        acc[4 * q] += ov.x * wv;
        acc[4 * q + 1] += ov.y * wv;
        acc[4 * q + 2] += ov.z * wv;
        acc[4 * q + 3] += ov.w * wv;
      }
    }
    __syncthreads();
  }
  // (3) g = kbar * K_xz (zero at ghost rows and m >= M, where K_xz is 0)
  const float4* kr = reinterpret_cast<const float4*>(sh.k + tid * kKs);
#pragma unroll
  for (int q = 0; q < kR / 4; ++q) {
    const float4 kv = kr[q];
    acc[4 * q] *= kv.x;
    acc[4 * q + 1] *= kv.y;
    acc[4 * q + 2] *= kv.z;
    acc[4 * q + 3] *= kv.w;
  }
  const float z0 = sh.zr[tid * 2], z1 = sh.zr[tid * 2 + 1];
  const float e0 = P.ell[tg * 2], e1 = P.ell[tg * 2 + 1];
  const float il0 = 1.0f / (e0 * e0), il1 = 1.0f / (e1 * e1);
  float gcol = 0.f, gh0 = 0.f, gh1 = 0.f, el0 = 0.f, el1 = 0.f;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float hr0 = h[r * 2], hr1 = h[r * 2 + 1];
    gcol += acc[r];
    gh0 += acc[r] * hr0;
    gh1 += acc[r] * hr1;
    el0 += acc[r] * ((hr0 - z0) * (hr0 - z0));
    el1 += acc[r] * ((hr1 - z1) * (hr1 - z1));
  }
  float* za = sh.zacc + (g * kMaxM + tid) * 2;
  za[0] += -(gcol * z0 - gh0) * il0;
  za[1] += -(gcol * z1 - gh1) * il1;
  // (4) the input cotangent: row sums over m of g, g z0, g z1
  if (hbar) {
    float tmp[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) tmp[r] = acc[r] * z0;
    const float s1 = warp_transpose_sum(tmp);
#pragma unroll
    for (int r = 0; r < kR; ++r) tmp[r] = acc[r] * z1;
    const float s2r = warp_transpose_sum(tmp);
    const float s0 = warp_transpose_sum(acc);
    sh.red[warp * 3 * kR + lane] = s0;
    sh.red[warp * 3 * kR + kR + lane] = s1;
    sh.red[warp * 3 * kR + 2 * kR + lane] = s2r;
  }
  // (5) the block's scalars: sum over m of g, and of the ell terms
  const float wg_sum = warp_sum(gcol), we0 = warp_sum(el0), we1 = warp_sum(el1);
  if (lane == 0) {
    sh.red3[warp * 4] = wg_sum;
    sh.red3[warp * 4 + 1] = we0;
    sh.red3[warp * 4 + 2] = we1;
  }
  __syncthreads();
  if (hbar && tid < nrows) {
    float s0 = 0.f, s1 = 0.f, s2r = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) {
      s0 += sh.red[wi * 3 * kR + tid];
      s1 += sh.red[wi * 3 * kR + kR + tid];
      s2r += sh.red[wi * 3 * kR + 2 * kR + tid];
    }
    hbar[tid * 2] += -(s0 * h[tid * 2] - s1) * il0;
    hbar[tid * 2 + 1] += -(s0 * h[tid * 2 + 1] - s2r) * il1;
  }
  if (tid == 0) {
    float gs = 0.f, es0 = 0.f, es1 = 0.f, vb = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) {
      gs += sh.red3[wi * 4];
      es0 += sh.red3[wi * 4 + 1];
      es1 += sh.red3[wi * 4 + 2];
    }
    for (int r = 0; r < nrows; ++r) vb += sh.varbar[r];
    sh.scal[kSlotEll + g * 2] += es0 / (e0 * e0 * e0);
    sh.scal[kSlotEll + g * 2 + 1] += es1 / (e1 * e1 * e1);
    sh.scal[kSlotS2 + g] += gs / P.s2[tg] + vb;
  }
  __syncthreads();
}

__device__ __forceinline__ void load_x(Shared& sh, const Params& P, int t, int b0, int nx) {
  const int tid = threadIdx.x;
  if (tid < kR * 2) {
    const int r = tid / 2;
    sh.hx[tid] = r < nx ? P.x[(static_cast<size_t>(t) * P.b + b0 + r) * 2 + tid % 2] : 0.f;
  }
  __syncthreads();
}

// index of eps (T, S, 2, B) and of h1/h2 (T, S, B, 2)
__device__ __forceinline__ size_t eps_at(const Params& P, int t, int s, int o, int b) {
  return ((static_cast<size_t>(t) * P.s + s) * 2 + o) * P.b + b;
}
__device__ __forceinline__ size_t h_at(const Params& P, int t, int s, int b, int o) {
  return ((static_cast<size_t>(t) * P.s + s) * P.b + b) * 2 + o;
}

__global__ void __launch_bounds__(kThreads)
elbo_fwd_kernel(Params P, float* __restrict__ partial, float* __restrict__ h1o, float* __restrict__ h2o) {
  Shared& sh = shared();
  const int tile = blockIdx.x, t = blockIdx.y, tid = threadIdx.x;
  const int b0 = tile * P.xr;
  const int nx = min(P.xr, P.b - b0);
  const float noise = P.noise[t];
  load_x(sh, P, t, b0, nx);

  // layer 1, once per x row
  for (int o = 0; o < 2; ++o) {
    build_k(sh, P, t, o, sh.hx, nx, nullptr);
    group_out(sh, P, t, o, nx, nullptr);
    if (tid < nx) {
      const float lin = sh.hx[tid * 2] * P.mw1[t * 4 + o] + sh.hx[tid * 2 + 1] * P.mw1[t * 4 + 2 + o];
      sh.m1[o * kR + tid] = sh.mean[tid] + (lin + P.mb1[t * 2 + o]);
      sh.sd1[o * kR + tid] = sqrtf(fmaxf(sh.var[tid], kVarFloor));
    }
    __syncthreads();
  }

  float total = 0.f;
  const int nq_all = nx * P.s;
  for (int q0 = 0; q0 < nq_all; q0 += kR) {
    const int nq = min(kR, nq_all - q0);
    if (tid < kR * 2) {
      const int q = tid / 2, o = tid % 2;
      float v = 0.f;
      if (q < nq) {
        const int s = (q0 + q) / nx, r = (q0 + q) % nx;
        v = sh.m1[o * kR + r] + sh.sd1[o * kR + r] * P.eps1[eps_at(P, t, s, o, b0 + r)];
        h1o[h_at(P, t, s, b0 + r, o)] = v;
      }
      sh.h1[tid] = v;
    }
    __syncthreads();
    for (int o = 0; o < 2; ++o) {
      build_k(sh, P, t, 2 + o, sh.h1, nq, nullptr);
      group_out(sh, P, t, 2 + o, nq, nullptr);
      if (tid < kR) {
        float v = 0.f;
        if (tid < nq) {
          const int s = (q0 + tid) / nx, r = (q0 + tid) % nx;
          const float lin = sh.h1[tid * 2] * P.mw2[t * 4 + o] + sh.h1[tid * 2 + 1] * P.mw2[t * 4 + 2 + o];
          const float mean = sh.mean[tid] + (lin + P.mb2[t * 2 + o]);
          v = mean + sqrtf(fmaxf(sh.var[tid], kVarFloor)) * P.eps2[eps_at(P, t, s, o, b0 + r)];
          h2o[h_at(P, t, s, b0 + r, o)] = v;
        }
        sh.h2[tid * 2 + o] = v;
      }
      __syncthreads();
    }
    build_k(sh, P, t, 4, sh.h2, nq, nullptr);
    group_out(sh, P, t, 4, nq, nullptr);
    if (tid == 0) {
      const float lg = logf(kTwoPi * noise);
      for (int q = 0; q < nq; ++q) {
        const int r = (q0 + q) % nx;
        const float d = P.y[static_cast<size_t>(t) * P.b + b0 + r] - (sh.mean[q] + P.mbh[t]);
        total += -0.5f * (lg + (d * d + fmaxf(sh.var[q], kVarFloor)) / noise);
      }
    }
    __syncthreads();
  }
  if (tid == 0) partial[static_cast<size_t>(t) * P.ntiles + tile] = total;
}

__global__ void elbo_sum_kernel(const float* __restrict__ partial, float* __restrict__ dt, int t, int ntiles,
                                float count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t) return;
  float s = 0.f;
  for (int j = 0; j < ntiles; ++j) s += partial[static_cast<size_t>(i) * ntiles + j];
  dt[i] = s / count;
}

__global__ void __launch_bounds__(kThreads)
elbo_bwd_kernel(Params P, const float* __restrict__ h1i, const float* __restrict__ h2i,
                const float* __restrict__ gbar, float* __restrict__ kscr, float* __restrict__ oscr,
                float* __restrict__ partial, float* __restrict__ ybar) {
  Shared& sh = shared();
  const int tile = blockIdx.x, t = blockIdx.y, tid = threadIdx.x;
  const int b0 = tile * P.xr;
  const int nx = min(P.xr, P.b - b0);
  const float noise = P.noise[t];
  const float coef = gbar[t] / static_cast<float>(P.s * P.b);
  const size_t rows = scratch_rows(P);
  float* kmem = kscr + static_cast<size_t>(t) * rows * P.m;
  float* omem = oscr + static_cast<size_t>(t) * rows * P.p;
  auto krows = [&](int g, int row) { return kmem + static_cast<size_t>(rowbase(P, g) + row) * P.m; };
  auto orows = [&](int g, int row) { return omem + static_cast<size_t>(rowbase(P, g) + row) * P.p; };

  for (int g = 0; g < kGroups; ++g) {
    sh.zacc[(g * kMaxM + tid) * 2] = 0.f;
    sh.zacc[(g * kMaxM + tid) * 2 + 1] = 0.f;
  }
  if (tid < 32) sh.scal[tid] = 0.f;
  if (tid < 2 * kR) sh.m1bar[tid] = sh.v1bar[tid] = 0.f;
  if (tid < kR) sh.ybar[tid] = 0.f;
  load_x(sh, P, t, b0, nx);

  // layer 1's variances (and out, into scratch) at the tile's x rows
  for (int o = 0; o < 2; ++o) {
    build_k(sh, P, t, o, sh.hx, nx, nullptr);
    group_out(sh, P, t, o, nx, orows(o, b0));
    if (tid < nx) {
      sh.v1u[o * kR + tid] = sh.var[tid];
      sh.sd1[o * kR + tid] = sqrtf(fmaxf(sh.var[tid], kVarFloor));
    }
    __syncthreads();
  }

  const int nq_all = nx * P.s;
  for (int q0 = 0; q0 < nq_all; q0 += kR) {
    const int nq = min(kR, nq_all - q0);
    const int row0 = b0 * P.s + q0;  // scratch row of this chunk's first sample row
    if (tid < kR * 2) {
      const int q = tid / 2, o = tid % 2;
      float v1 = 0.f, v2 = 0.f;
      if (q < nq) {
        const int s = (q0 + q) / nx, r = (q0 + q) % nx;
        v1 = h1i[h_at(P, t, s, b0 + r, o)];
        v2 = h2i[h_at(P, t, s, b0 + r, o)];
      }
      sh.h1[tid] = v1;
      sh.h2[tid] = v2;
      sh.h1bar[tid] = 0.f;
      sh.h2bar[tid] = 0.f;
    }
    __syncthreads();

    // head
    build_k(sh, P, t, 4, sh.h2, nq, krows(4, row0));
    group_out(sh, P, t, 4, nq, orows(4, row0));
    if (tid < kR) {
      float mb = 0.f, vb = 0.f, nb = 0.f, yb = 0.f;
      if (tid < nq) {
        const int r = (q0 + tid) % nx;
        const float yv = P.y[static_cast<size_t>(t) * P.b + b0 + r];
        const float mh = sh.mean[tid] + P.mbh[t];
        const float vhu = sh.var[tid];
        const float vh = fmaxf(vhu, kVarFloor);
        const float diff = mh - yv;
        mb = coef * (-diff / noise);
        vb = vhu > kVarFloor ? coef * (-0.5f / noise) : 0.f;
        nb = coef * (-0.5f / noise + 0.5f * ((yv - mh) * (yv - mh) + vh) / (noise * noise));
        yb = coef * (diff / noise);
      }
      sh.meanbar[tid] = mb;
      sh.varbar[tid] = vb;
      sh.tmpa[tid] = nb;
      sh.tmpb[tid] = yb;
    }
    __syncthreads();
    if (tid == 0) {
      for (int q = 0; q < nq; ++q) {
        sh.scal[kSlotNoise] += sh.tmpa[q];
        sh.scal[kSlotMbh] += sh.meanbar[q];
        sh.ybar[(q0 + q) % nx] += sh.tmpb[q];
      }
    }
    group_bwd(sh, P, t, 4, sh.h2, nq, orows(4, row0), sh.h2bar);

    // layer 2
    for (int o = 0; o < 2; ++o) {
      build_k(sh, P, t, 2 + o, sh.h1, nq, krows(2 + o, row0));
      group_out(sh, P, t, 2 + o, nq, orows(2 + o, row0));
      if (tid < kR) {
        float mb = 0.f, vb = 0.f;
        if (tid < nq) {
          const int s = (q0 + tid) / nx, r = (q0 + tid) % nx;
          const float v2u = sh.var[tid];
          mb = sh.h2bar[tid * 2 + o];
          const float v2b = mb * P.eps2[eps_at(P, t, s, o, b0 + r)] * 0.5f / sqrtf(fmaxf(v2u, kVarFloor));
          vb = v2u > kVarFloor ? v2b : 0.f;
          sh.h1bar[tid * 2] += mb * P.mw2[t * 4 + o];
          sh.h1bar[tid * 2 + 1] += mb * P.mw2[t * 4 + 2 + o];
        }
        sh.meanbar[tid] = mb;
        sh.varbar[tid] = vb;
      }
      __syncthreads();
      if (tid == 0) {
        for (int q = 0; q < nq; ++q) {
          sh.scal[kSlotMw2 + o] += sh.h1[q * 2] * sh.meanbar[q];
          sh.scal[kSlotMw2 + 2 + o] += sh.h1[q * 2 + 1] * sh.meanbar[q];
          sh.scal[kSlotMb2 + o] += sh.meanbar[q];
        }
      }
      group_bwd(sh, P, t, 2 + o, sh.h1, nq, orows(2 + o, row0), sh.h1bar);
    }

    // layer 1's mean and variance cotangents, summed over each row's samples
    if (tid < 2 * kR) {
      const int o = tid / kR, r = tid % kR;
      if (r < nx) {
        for (int q = 0; q < nq; ++q) {
          if ((q0 + q) % nx != r) continue;
          const int s = (q0 + q) / nx;
          const float hb = sh.h1bar[q * 2 + o];
          sh.m1bar[o * kR + r] += hb;
          sh.v1bar[o * kR + r] += hb * P.eps1[eps_at(P, t, s, o, b0 + r)] * 0.5f / sh.sd1[o * kR + r];
        }
      }
    }
    __syncthreads();
  }

  // layer 1's pullback (x takes no cotangent)
  for (int o = 0; o < 2; ++o) {
    build_k(sh, P, t, o, sh.hx, nx, krows(o, b0));
    if (tid < kR) {
      const bool live = tid < nx;
      sh.meanbar[tid] = live ? sh.m1bar[o * kR + tid] : 0.f;
      sh.varbar[tid] = live && sh.v1u[o * kR + tid] > kVarFloor ? sh.v1bar[o * kR + tid] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      for (int r = 0; r < nx; ++r) {
        sh.scal[kSlotMw1 + o] += sh.hx[r * 2] * sh.meanbar[r];
        sh.scal[kSlotMw1 + 2 + o] += sh.hx[r * 2 + 1] * sh.meanbar[r];
        sh.scal[kSlotMb1 + o] += sh.meanbar[r];
      }
    }
    group_bwd(sh, P, t, o, sh.hx, nx, orows(o, b0), nullptr);
  }

  if (tid < nx) ybar[static_cast<size_t>(t) * P.b + b0 + tid] = sh.ybar[tid];
  const int kp = kGroups * P.m * 2 + kSlots;
  float* part = partial + (static_cast<size_t>(t) * P.ntiles + tile) * kp;
  if (tid < P.m) {
    for (int g = 0; g < kGroups; ++g) {
      part[(g * P.m + tid) * 2] = sh.zacc[(g * kMaxM + tid) * 2];
      part[(g * P.m + tid) * 2 + 1] = sh.zacc[(g * kMaxM + tid) * 2 + 1];
    }
  }
  if (tid < kSlots) part[kGroups * P.m * 2 + tid] = sh.scal[tid];
}

// Wbar[t][g][i][c] = sum over the group's scratch rows k of K[k][i] outbar[k][c],
// one 64 x 64 output tile per block, 4 x 4 outputs per thread, the rows
// staged 16 at a time and summed in ascending order
__global__ void __launch_bounds__(kWbarThreads)
elbo_wbar_kernel(Params P, const float* __restrict__ kscr, const float* __restrict__ oscr,
                 float* __restrict__ wbar) {
  __shared__ __align__(16) float a_tile[kWbarK][kWbarTile];  // a_tile[kk][ii] = K[k0 + kk][i0 + ii]
  __shared__ __align__(16) float b_tile[kWbarK][kWbarTile];  // b_tile[kk][cc] = outbar[k0 + kk][c0 + cc]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * kWbarTile, i0 = blockIdx.y * kWbarTile;
  const int t = blockIdx.z / kGroups, g = blockIdx.z % kGroups;
  const int nrows = g < 2 ? P.b : P.s * P.b;
  const size_t base = static_cast<size_t>(t) * scratch_rows(P) + rowbase(P, g);
  const float* K = kscr + base * P.m;
  const float* O = oscr + base * P.p;
  float* W = wbar + static_cast<size_t>(t * kGroups + g) * P.m * P.p;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < nrows; k0 += kWbarK) {
#pragma unroll
    for (int e = tid; e < kWbarK * kWbarTile; e += kWbarThreads) {
      const int kk = e / kWbarTile, jj = e % kWbarTile;
      const int k = k0 + kk;
      a_tile[kk][jj] = (k < nrows && i0 + jj < P.m) ? K[static_cast<size_t>(k) * P.m + i0 + jj] : 0.f;
      b_tile[kk][jj] = (k < nrows && c0 + jj < P.p) ? O[static_cast<size_t>(k) * P.p + c0 + jj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWbarK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a_tile[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_tile[kk][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w}, b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ii = i0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = c0 + tx * 4 + j;
      if (ii < P.m && cc < P.p) W[static_cast<size_t>(ii) * P.p + cc] = acc[i][j];
    }
  }
}

// small[t][k] = sum over tiles, in order, of the blocks' partials
__global__ void elbo_small_kernel(const float* __restrict__ partial, float* __restrict__ small, int ntiles,
                                  int kp) {
  const int t = blockIdx.x;
  for (int k = threadIdx.x; k < kp; k += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < ntiles; ++j) s += partial[(static_cast<size_t>(t) * ntiles + j) * kp + k];
    small[static_cast<size_t>(t) * kp + k] = s;
  }
}

int x_rows_per_tile(int s) { return s >= kR ? 1 : kR / s; }

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
  P.xr = x_rows_per_tile(s);
  P.ntiles = (b + P.xr - 1) / P.xr;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// tiles of x rows per member (the grid's x extent), and the length of a
// block's small partial (z-bar, then kSlots scalars)
int elbo_num_tiles(int b, int s) {
  const int xr = x_rows_per_tile(s);
  return (b + xr - 1) / xr;
}
int elbo_small_len(int m) { return kGroups * m * 2 + kSlots; }

// The forward: partial (T, ntiles) scratch; dt (T,), h1, h2 (T, S, B, 2)
// out.  Returns the first launch error as an int (0 = launched).
int elbo_fwd(const void* x, const void* y, const void* eps1, const void* eps2, const void* z, const void* ell,
             const void* s2, const void* w, const void* mw1, const void* mb1, const void* mw2, const void* mb2,
             const void* mbh, const void* noise, void* partial, void* dt, void* h1, void* h2, int t, int b,
             int s, int m, void* stream) {
  const void* in[14] = {x, y, eps1, eps2, z, ell, s2, w, mw1, mb1, mw2, mb2, mbh, noise};
  Params P;
  cudaError_t e = prepare(P, in, t, b, s, m);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = static_cast<int>(sizeof(Shared));
  e = cudaFuncSetAttribute(elbo_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  elbo_fwd_kernel<<<dim3(P.ntiles, t), kThreads, bytes, st>>>(P, static_cast<float*>(partial),
                                                              static_cast<float*>(h1), static_cast<float*>(h2));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  elbo_sum_kernel<<<(t + 127) / 128, 128, 0, st>>>(static_cast<const float*>(partial), static_cast<float*>(dt),
                                                   t, P.ntiles, static_cast<float>(s) * static_cast<float>(b));
  return static_cast<int>(cudaGetLastError());
}

// The backward, given the forward's h1, h2 and the output cotangent gbar
// (T,): kscr (T, 2B + 3SB, M), oscr (T, 2B + 3SB, P) and partial
// (T, ntiles, elbo_small_len(M)) scratch; wbar (T, 5, M, P), small
// (T, elbo_small_len(M)) and ybar (T, B) out.
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
  const int bytes = static_cast<int>(sizeof(Shared));
  e = cudaFuncSetAttribute(elbo_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  elbo_bwd_kernel<<<dim3(P.ntiles, t), kThreads, bytes, st>>>(
      P, static_cast<const float*>(h1), static_cast<const float*>(h2), static_cast<const float*>(gbar),
      static_cast<float*>(kscr), static_cast<float*>(oscr), static_cast<float*>(partial),
      static_cast<float*>(ybar));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((P.p + kWbarTile - 1) / kWbarTile, (m + kWbarTile - 1) / kWbarTile, t * kGroups);
  elbo_wbar_kernel<<<grid, kWbarThreads, 0, st>>>(
      P, static_cast<const float*>(kscr), static_cast<const float*>(oscr), static_cast<float*>(wbar));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  elbo_small_kernel<<<t, kThreads, 0, st>>>(static_cast<const float*>(partial), static_cast<float*>(small),
                                            P.ntiles, elbo_small_len(m));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
