// Gibbs Gram-times-V (K2), the fused backward panel sweep of the
// matrix-free MLL (K3) and the SE-ARD (RBF) Gram-times-V (K6), with the
// Gram never in memory.  Hopper (sm_90a) ports of the TPU kernels
//   K2 nonstationary_precip_tpu/ops/pallas_matvec.py::make_gibbs_matvec
//   K3 nonstationary_precip_tpu/ops/pallas_matvec.py::packed_gibbs_panel_grads
//      (and packed_gibbs_panel_grads_rows)
//   K6 nonstationary_precip_tpu/ops/pallas_matvec.py::make_rbf_matvec.
// The wrappers, the plain PyTorch versions and the design notes are in
// nonstationary_precip_tpu_torch/ops/matvec.py.
//
// K2, K6 and K3 are one Gram-times-V walk, gibbs_rows_kernel, whose element
// is a template policy (GibbsElem, RbfElem, PanelElem).  It walks in
// register tiles of rows: a block of kK2Threads threads owns Elem::kRows
// rows, kRowsPerThread a thread (rows tid, tid + kK2Threads, ..; K2 2, K6 4,
// K3 kK3RowsPerThread), with their payloads and their accumulators each in
// registers, so every column payload and V row read from shared memory
// feeds kRowsPerThread elements; at d = 2 and R <= Elem::kCapR the
// registers are capped so that Elem::kMinBlocks blocks share an SM (1
// leaves them free).  Column passes of Elem::kPass columns are
// double-buffered: the raw payload and V's rows of pass n + 1 come in by
// cp.async while pass n is computed, and at d = 2 the element's column
// factors are made once a pass.
//   K2 at d = 2, the JAX kernel's own element (pallas_matvec.py:118-141):
//     p = ss_0 ss_1,  rs = rsqrt(p),  quadnum = d_0^2 ss_1 + d_1^2 ss_0,
//     K = (2 sqrt(l_i0 l_i1)) sqrt(l_j0 l_j1) rs exp(-quadnum rs^2)
//   (gibbs_elem.cuh's d2_elem); other d, its per-dim element.
//   K6 from the payload z = x / ell that the wrapper prescales once (the TPU
//   kernel's _pack_scaled): K(i,j) = exp(-0.5 sum_k (z_ik - z_jk)^2), the
//   quadratic formed from the differences (no cancellation, so no clamp).
//   At d = 2 the rows' payload (in registers) and each pass's columns are
//   scaled by c = sqrt(log2(e) / 2), so K = 2^-((c z_i0 - c z_j0)^2 +
//   (c z_i1 - c z_j1)^2): 5 f32 operations (an FMA as 2) and one ex2;
//   other d, the per-dim differences and expf.
//   K3 walks with the rows' cotangent factors f1_i (fw = 1 + 2R of them) in
//   registers where K2 holds V's accumulators, each pass's column factors
//   f2_j staged where K2 stages V's rows, and 1 + 2D pullback sums a row:
//   P = (f1_i . f2_j) K(i, j), then sum P, sum P d_k/ss_k and
//   sum P (2 d_k^2/ss_k - 1)/ss_k.  At d = 2 its element is K2's rewrite
//   with the reciprocals read off rs^2 = 1/(s_0 s_1) (no division):
//   h_k = s_(1-k) rs^2 = 1/(ss_k ln 2), m_k = d_k^2 h_k = d_k^2/(ss_k ln 2),
//   K = (n_i n_j) rs 2^-(m_0 + m_1), and the sums carry the ln 2 that the
//   second kernel puts back; other d, gibbs_elem.cuh's per-dim element.
//
// The column range is cut into `splits` slices (gridDim.y).  Each slice
// writes its partial row sums to a scratch buffer; a second kernel adds the
// slices in a fixed order (and for K3 applies the closed forms).  No
// atomics: the result is the same bits on every run.  The walk uses no
// tensor cores.
//
// K2's and K6's 'default' and 'high3' contractions (the TPU kernel's
// _contract, pallas_matvec.py:90-112) are a second walk, gibbs_mma_kernel,
// on the tensor cores: each Gram element is built in f32 by the same
// element policy, rounded to bf16 (hi = bf16(k), lo = bf16(k - hi)) and
// contracted with V's bf16 hi and lo parts, which the wrapper splits once a
// call and packs in column pairs (the B fragments' layout), by
// mma.sync.m16n8k16 with f32 accumulators: hi.hi for 'default' (one pass),
// hi.hi + hi.lo + lo.hi for 'high3' (three).  A warp owns kMmaMT tiles of
// 16 rows; in each 16-column step a thread builds its A fragments' elements
// directly in registers: rows g and g + 8 of each tile (g = lane / 4)
// against columns 2t, 2t + 1, 2t + 8, 2t + 9 (t = lane % 4), so every
// element is built once.  Columns come in passes of kMmaPass through
// shared memory, double-buffered by cp.async, as in the walk; the column
// splits and their fixed-order sum are the walk's.  'vpu' is the walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "gibbs_elem.cuh"

namespace {

using gibbs::exp2_approx;
using gibbs::gibbs_elem;
using gibbs::kLn2;
using gibbs::kMaxD;
using gibbs::kTwoLn2;
using gibbs::live;
using gibbs::rsqrt_approx;

constexpr int kCols = 128;   // K2, K6: columns staged in shared memory per pass
constexpr int kGroup = 32;   // K2, K6: right-hand sides one block contracts
constexpr int kMaxR = 128;   // K2, K6: right-hand sides one launch takes
constexpr int kMaxF = 65;    // K3: cotangent factors a launch takes, 1 + 2R with R <= 32
constexpr int kK2Threads = 256;  // threads a block of the walk
// Rows a thread owns, and blocks an SM the compiler must fit (registers) at
// d = 2 and R <= 9 (K3: 1 + 2R <= 17), the paths' shape (elsewhere the
// accumulators need more registers than that leaves; 1 leaves them free),
// for K2, K6 and K3, as measured (tools/bench_k2.py and tools/bench_k3.py
// time the choices)
constexpr int kK2RowsPerThread = 2;
constexpr int kK2MinBlocks = 4;
constexpr int kK6RowsPerThread = 4;
constexpr int kK6MinBlocks = 1;
constexpr int kK3RowsPerThread = 2;
constexpr int kK3MinBlocks = 3;
constexpr int kK3Cols = 64;  // K3's columns a pass: 1 + 2R factors a column fit 48 KB at R <= 32
constexpr int kK2Rows = kK2Threads * kK2RowsPerThread;  // rows a K2 block owns
constexpr int kK6Rows = kK2Threads * kK6RowsPerThread;  // rows a K6 block owns
constexpr int kK3Rows = kK2Threads * kK3RowsPerThread;  // rows a K3 block owns
// sqrt(log2(e) / 2): K6's d = 2 payload scale, exp(-q / 2) = 2^-(c^2 q)
constexpr float kRbfScale = 0.849321800288019111f;

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// Row payload of row i into registers; an inactive row (i >= n) gets a
// harmless x = 0, l = 1.
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ x,
                                         const float* __restrict__ l, int i,
                                         bool active, int d, float* xi,
                                         float* li) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const bool ok = active && live<D>(k, d);
    xi[k] = ok ? x[static_cast<size_t>(i) * d + k] : 0.0f;
    li[k] = ok ? l[static_cast<size_t>(i) * d + k] : 1.0f;
  }
}

// ---- the Gram-times-V walk (K2, K6, K3) ----

// 4-byte cp.async into shared memory; a copy that is not valid zero-fills
// (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The element policies of the walk.  Each says whether the columns' l is
// staged beside x (kL), the floats of a column's d = 2 factors made once a
// pass (kCook), the columns a pass (kPass), whether it accumulates K3's
// pullback sums (kPull) in place of R products, and at d = 2 the row
// factors (Row, from x_i and l_i in registers), the column factors (cook,
// into the pass's cook area; Col, read back) and the element from both
// (elem2; K3: pull2, the element with its pullback terms); at other d, the
// per-dim element (elem).

// K2: the Gibbs element.  At d = 2 gibbs_elem.cuh's d2_elem (the JAX
// kernel's rewrite with its squared lengthscales prescaled by ln 2) from
// its row and column factors: 15 f32 operations (an FMA as 2) and 2
// special-function ones.  A zero-filled column past the slice's end gets
// n_j = 0 (other d: l_j = 0), so its element is 0.
struct GibbsElem {
  static constexpr int kRowsPerThread = kK2RowsPerThread;
  static constexpr int kRows = kK2Rows;
  static constexpr int kMinBlocks = kK2MinBlocks;
  static constexpr int kCapR = 9;
  static constexpr int kPass = kCols;
  static constexpr bool kPull = false;
  static constexpr bool kL = true;
  static constexpr int kCook = 5;  // (x_j, q_j) as a float4, then n_j
  using Row = gibbs::D2Row;
  struct Col {
    float4 xq;
    float n;
  };
  __device__ static Row row(const float* xi, const float* li) { return gibbs::d2_row(xi, li); }
  template <int kP>
  __device__ static void cook(float* ck, const float* xs, const float* ls, int j) {
    const float l0 = ls[2 * j], l1 = ls[2 * j + 1];
    reinterpret_cast<float4*>(ck)[j] = gibbs::d2_col_xq(xs[2 * j], xs[2 * j + 1], l0, l1);
    ck[4 * kP + j] = gibbs::d2_col_n(l0, l1);
  }
  template <int kP>
  __device__ static Col col(const float* ck, int j) {
    return {reinterpret_cast<const float4*>(ck)[j], ck[4 * kP + j]};
  }
  __device__ static float elem2(const Row& r, const Col& c) { return gibbs::d2_elem(r, c.xq, c.n); }
  template <int D>
  __device__ static float elem(const float* xi, const float* li, const float* xj, const float* lj, int d) {
    float diff[D], inv_ss[D];
    return gibbs_elem<D>(xi, li, xj, lj, d, diff, inv_ss);
  }
};

// K6: the RBF element on the prescaled z (x is z; l is not read).  At
// d = 2 the rows' z and each pass's columns are scaled by kRbfScale once,
// and K = 2^-(d_0^2 + d_1^2) from the differences: 5 f32 operations (an
// FMA as 2) and one ex2.  Other d: exp(-0.5 sum_k (z_ik - z_jk)^2) with
// expf.  A zero-filled column gets a finite element, and V's zero row.
struct RbfElem {
  static constexpr int kRowsPerThread = kK6RowsPerThread;
  static constexpr int kRows = kK6Rows;
  static constexpr int kMinBlocks = kK6MinBlocks;
  static constexpr int kCapR = 9;
  static constexpr int kPass = kCols;
  static constexpr bool kPull = false;
  static constexpr bool kL = false;
  static constexpr int kCook = 2;  // c z_j as a float2
  struct Row {
    float z0, z1;
  };
  using Col = float2;
  __device__ static Row row(const float* xi, const float*) { return {xi[0] * kRbfScale, xi[1] * kRbfScale}; }
  template <int kP>
  __device__ static void cook(float* ck, const float* xs, const float*, int j) {
    reinterpret_cast<float2*>(ck)[j] = make_float2(xs[2 * j] * kRbfScale, xs[2 * j + 1] * kRbfScale);
  }
  template <int kP>
  __device__ static Col col(const float* ck, int j) { return reinterpret_cast<const float2*>(ck)[j]; }
  __device__ static float elem2(const Row& r, const Col& c) {
    const float d0 = r.z0 - c.x;
    const float d1 = r.z1 - c.y;
    return exp2_approx(-fmaf(d1, d1, d0 * d0));
  }
  template <int D>
  __device__ static float elem(const float* zi, const float*, const float* zj, const float*, int d) {
    float quad = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (live<D>(k, d)) {
        const float dk = zi[k] - zj[k];
        quad += dk * dk;
      }
    }
    return expf(-0.5f * quad);
  }
};

// K3: the pullback sums of P = W K with W(i, j) = f1_i . f2_j.  The walk's
// V is f2 (RB its bucket of fw factors) and each row's accumulators are
// acc[0] = sum P, acc[1 + k] = sum P d_k/ss_k, acc[1 + D + k] =
// sum P (2 d_k^2/ss_k - 1)/ss_k.  At d = 2 K2's row and column factors and
// the element with its pullback terms from rs^2 (pull2): 17 f32
// operations (an FMA as 2) and 2 special-function ones for P given W, 7 a
// dim for the sums; the d = 2 sums of d_k/ss_k and (..)/ss_k come out
// divided by ln 2, which panel_grads_finish_kernel multiplies back.  A
// zero-filled column past the slice's end gets n_j = 0 (other d: l_j = 0)
// and f2_j = 0, so P = 0.
struct PanelElem {
  static constexpr int kRowsPerThread = kK3RowsPerThread;
  static constexpr int kRows = kK3Rows;
  static constexpr int kMinBlocks = kK3MinBlocks;
  static constexpr int kCapR = 17;
  static constexpr int kPass = kK3Cols;
  static constexpr bool kPull = true;
  static constexpr bool kL = true;
  static constexpr int kCook = GibbsElem::kCook;
  using Row = GibbsElem::Row;
  using Col = GibbsElem::Col;
  __device__ static Row row(const float* xi, const float* li) { return GibbsElem::row(xi, li); }
  template <int kP>
  __device__ static void cook(float* ck, const float* xs, const float* ls, int j) {
    GibbsElem::cook<kP>(ck, xs, ls, j);
  }
  template <int kP>
  __device__ static Col col(const float* ck, int j) { return GibbsElem::col<kP>(ck, j); }
  template <int RB>
  __device__ static void pull2(float (&acc)[5], const Row& r, const Col& c, const float (&fi)[RB],
                               const float* vj) {
    const float s0 = gibbs::d2_s(r.a0, c.xq.z);
    const float s1 = gibbs::d2_s(r.a1, c.xq.w);
    const float rs = rsqrt_approx(s0 * s1);
    const float r2 = rs * rs;
    const float d0 = r.x0 - c.xq.x;
    const float d1 = r.x1 - c.xq.y;
    const float h0 = s1 * r2;  // 1/(ss_0 ln 2)
    const float h1 = s0 * r2;
    const float m0 = (d0 * d0) * h0;  // d_0^2/(ss_0 ln 2)
    const float m1 = (d1 * d1) * h1;
    const float e = exp2_approx(-(m0 + m1));
    float w = 0.0f;
#pragma unroll
    for (int f = 0; f < RB; ++f) w = fmaf(fi[f], vj[f], w);
    const float p = ((w * (r.n * c.n)) * rs) * e;
    acc[0] += p;
    const float g0 = p * h0;
    const float g1 = p * h1;
    acc[1] = fmaf(g0, d0, acc[1]);
    acc[2] = fmaf(g1, d1, acc[2]);
    acc[3] = fmaf(g0, fmaf(m0, kTwoLn2, -1.0f), acc[3]);
    acc[4] = fmaf(g1, fmaf(m1, kTwoLn2, -1.0f), acc[4]);
  }
};

// Blocks an SM the registers of the walk must fit.
template <class Elem>
constexpr int min_blocks(int d, int rb) { return d == 2 && rb <= Elem::kCapR ? Elem::kMinBlocks : 1; }

// Shared memory of a block, in floats: the raw column payload (x, then
// for K2 and K3 l, kPass * D each) and V's rows (kPass * pad4(RB)) of two
// passes, then at d = 2 the column factors of the current pass.
template <class Elem, int D, int RB>
struct RowsSmem {
  static constexpr int kRaw = (Elem::kL ? 2 : 1) * Elem::kPass * D;
  static constexpr int kV = Elem::kPass * pad4(RB);
  static constexpr int kStage = kRaw + kV;
  static constexpr int kCook = D == 2 ? Elem::kCook * Elem::kPass : 0;
  static constexpr int kFloats = 2 * kStage + kCook;
  static_assert(kFloats * 4 <= 48 * 1024, "the walk's shared memory is static: 48 KB at most");
};

// K2 and K6.  part[s, i, g0 + r] = sum over slice s of K(i, j) v[j, g0 + r]
// for the rhs group g0 = kGroup * blockIdx.z, r < min(kGroup, rc - g0),
// with thread tid owning rows blockIdx.x * Elem::kRows + tid + u * kK2Threads,
// u < Elem::kRowsPerThread.
// K3 (Elem::kPull): v is f2 (rc = fw factors a column, one group), f1 the
// rows' factors (n1 x fw), and part[s, i, :] = [sum P, sum P d_k/ss_k (k < d),
// sum P (2 d_k^2/ss_k - 1)/ss_k (k < d)] over slice s (d = 2: the last 2d
// divided by ln 2).
template <class Elem, int D, int RB>
__global__ void __launch_bounds__(kK2Threads, min_blocks<Elem>(D, RB))
gibbs_rows_kernel(const float* __restrict__ x1, const float* __restrict__ l1,
                  int n1, const float* __restrict__ x2,
                  const float* __restrict__ l2, int n2,
                  const float* __restrict__ v, int ldv, int rc, int d,
                  int cols_per_split, float* __restrict__ part,
                  const float* __restrict__ f1) {
  constexpr int RP = pad4(RB);
  constexpr int TR = Elem::kRowsPerThread;
  constexpr int kP = Elem::kPass;
  constexpr int kAcc = Elem::kPull ? 1 + 2 * D : RB;  // accumulators a row
  using S = RowsSmem<Elem, D, RB>;
  __shared__ __align__(16) float sm[S::kFloats];
  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const int g0 = blockIdx.z * kGroup;
  const int gw = Elem::kPull ? rc : min(kGroup, rc - g0);  // <= RB by the host's choice of RB
  const int row0 = blockIdx.x * Elem::kRows + tid;

  // the rows' payloads; an inactive row gets x = 0, l = 1
  float xi[TR][D], li[TR][D];
#pragma unroll
  for (int u = 0; u < TR; ++u) {
    const int i = row0 + u * kK2Threads;
    load_row<D>(x1, l1, i, i < n1, d, xi[u], li[u]);
  }
  typename Elem::Row rf[TR];  // d = 2: the element's row factors
  if constexpr (D == 2) {
#pragma unroll
    for (int u = 0; u < TR; ++u) rf[u] = Elem::row(xi[u], li[u]);
  }
  // K3: the rows' cotangent factors; an inactive row's are 0
  float fi[TR][Elem::kPull ? RB : 1];
  if constexpr (Elem::kPull) {
#pragma unroll
    for (int u = 0; u < TR; ++u) {
      const int i = row0 + u * kK2Threads;
#pragma unroll
      for (int f = 0; f < RB; ++f) fi[u][f] = i < n1 && f < rc ? f1[static_cast<size_t>(i) * rc + f] : 0.0f;
    }
  }
  float acc[TR][kAcc];
#pragma unroll
  for (int u = 0; u < TR; ++u)
#pragma unroll
    for (int r = 0; r < kAcc; ++r) acc[u][r] = 0.0f;

  const int c_begin = s * cols_per_split;
  const int c_end = min(n2, c_begin + cols_per_split);
  const int npass = (c_end - c_begin + kP - 1) / kP;
  // pass n's columns [c0, c0 + jn) into stage b: x (and l) at [j * D + k]
  // (dims past d unread), V's rows at [j * RP + r] (columns past jn and
  // right-hand sides past gw zero)
  auto stage = [&](int n, int b) {
    float* xs = sm + b * S::kStage;
    float* ls = xs + kP * D;
    float* vs = xs + S::kRaw;
    const int c0 = c_begin + n * kP;
    const int jn = min(kP, c_end - c0);
    for (int e = tid; e < kP * d; e += kK2Threads) {
      const int j = e / d, k = e % d;
      const bool ok = j < jn;
      const size_t g = static_cast<size_t>(c0 + j) * d + k;
      cp_async4(xs + j * D + k, ok ? x2 + g : x2, ok);
      if constexpr (Elem::kL) cp_async4(ls + j * D + k, ok ? l2 + g : l2, ok);
    }
    for (int e = tid; e < kP * RP; e += kK2Threads) {
      const int j = e / RP, r = e % RP;
      const bool ok = j < jn && r < gw;
      cp_async4(vs + e, ok ? v + static_cast<size_t>(c0 + j) * ldv + g0 + r : v, ok);
    }
    cp_async_commit();
  };

  stage(0, 0);
  for (int n = 0; n < npass; ++n) {
    const int b = n & 1;
    cp_async_wait_all();
    __syncthreads();  // pass n has landed; every thread is done with pass n - 1
    if (n + 1 < npass) stage(n + 1, b ^ 1);
    const float* xs = sm + b * S::kStage;
    const float* ls = xs + kP * D;
    const float* vs = xs + S::kRaw;
    if constexpr (D == 2) {
      // the column factors, once a pass
      float* ck = sm + 2 * S::kStage;
      for (int j = tid; j < kP; j += kK2Threads) Elem::template cook<kP>(ck, xs, ls, j);
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < kP; ++j) {
        const typename Elem::Col cj = Elem::template col<kP>(ck, j);
        float vj[RP];
#pragma unroll
        for (int r = 0; r < RP; r += 4) {
          const float4 t = *reinterpret_cast<const float4*>(vs + j * RP + r);
          vj[r] = t.x;
          vj[r + 1] = t.y;
          vj[r + 2] = t.z;
          vj[r + 3] = t.w;
        }
#pragma unroll
        for (int u = 0; u < TR; ++u) {
          if constexpr (Elem::kPull) {
            Elem::template pull2<RB>(acc[u], rf[u], cj, fi[u], vj);
          } else {
            const float kij = Elem::elem2(rf[u], cj);
#pragma unroll
            for (int r = 0; r < RB; ++r) acc[u][r] = fmaf(kij, vj[r], acc[u][r]);
          }
        }
      }
    } else {
#pragma unroll 2
      for (int j = 0; j < kP; ++j) {
#pragma unroll
        for (int u = 0; u < TR; ++u) {
          if constexpr (Elem::kPull) {
            float diff[D], inv_ss[D];
            const float kij = gibbs_elem<D>(xi[u], li[u], xs + j * D, ls + j * D, d, diff, inv_ss);
            float w = 0.0f;
#pragma unroll
            for (int f = 0; f < RB; ++f) w = fmaf(fi[u][f], vs[j * RP + f], w);
            const float p = w * kij;
            acc[u][0] += p;
#pragma unroll
            for (int k = 0; k < D; ++k) {
              if (live<D>(k, d)) {
                acc[u][1 + k] = fmaf(p, diff[k] * inv_ss[k], acc[u][1 + k]);
                acc[u][1 + D + k] =
                    fmaf(p, inv_ss[k] * (2.0f * diff[k] * diff[k] * inv_ss[k] - 1.0f), acc[u][1 + D + k]);
              }
            }
          } else {
            const float kij = Elem::template elem<D>(xi[u], li[u], xs + j * D, ls + j * D, d);
#pragma unroll
            for (int r = 0; r < RB; ++r) acc[u][r] = fmaf(kij, vs[j * RP + r], acc[u][r]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < TR; ++u) {
    const int i = row0 + u * kK2Threads;
    if (i < n1) {
      if constexpr (Elem::kPull) {
        float* out = part + (static_cast<size_t>(s) * n1 + i) * (1 + 2 * d);
        out[0] = acc[u][0];
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (live<D>(k, d)) {
            out[1 + k] = acc[u][1 + k];
            out[1 + d + k] = acc[u][1 + D + k];
          }
        }
      } else {
        float* out = part + (static_cast<size_t>(s) * n1 + i) * rc + g0;
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (r < gw) out[r] = acc[u][r];
      }
    }
  }
}

// K2 and K6, second pass: out[i, r] = sum_s part[s, i, r], s in order.
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits,
                                  int n1, int rc, float* __restrict__ out,
                                  int ldo) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t m = static_cast<size_t>(n1) * rc;
  if (e >= m) return;
  float t = part[e];
  for (int s = 1; s < splits; ++s) t += part[s * m + e];
  const size_t i = e / rc;
  out[i * ldo + e % rc] = t;
}

// K3, second pass: adds the slices in order and applies the per-row
// closed forms  gx_k = -2 sum P d_k/ss_k,
//               gl_k = sp / (2 l_ik) + l_ik sum P (2 d_k^2/ss_k - 1)/ss_k,
// each sum of the last two the walk's times `scale` (ln 2 at d = 2, else 1).
__global__ void panel_grads_finish_kernel(const float* __restrict__ part,
                                          int splits, int nr, int d,
                                          const float* __restrict__ lr, float scale,
                                          float* __restrict__ gx,
                                          float* __restrict__ gl,
                                          float* __restrict__ sp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nr) return;
  const int w = 1 + 2 * d;
  const size_t stride = static_cast<size_t>(nr) * w;
  const float* p = part + static_cast<size_t>(i) * w;
  float spi = p[0];
  for (int s = 1; s < splits; ++s) spi += p[s * stride];
  sp[i] = spi;
  for (int k = 0; k < d; ++k) {
    float a = p[1 + k];
    float t = p[1 + d + k];
    for (int s = 1; s < splits; ++s) {
      a += p[s * stride + 1 + k];
      t += p[s * stride + 1 + d + k];
    }
    const float l = lr[static_cast<size_t>(i) * d + k];
    gx[static_cast<size_t>(i) * d + k] = (-2.0f * scale) * a;
    gl[static_cast<size_t>(i) * d + k] = spi / (2.0f * l) + l * (scale * t);
  }
}

struct MatvecArgs {
  const float *x1, *l1, *x2, *l2, *v;
  float *out, *part;
  int n1, n2, d, ldv, rc, ldo, splits, cols_per_split;
  const float* f1;  // K3: the rows' cotangent factors (v: the columns')
};

// K2 (GibbsElem), K6 (RbfElem) or K3 (PanelElem: one group of rc factors)
template <class Elem, int D, int RB>
void launch_matvec(const MatvecArgs& a, cudaStream_t s) {
  const dim3 grid((a.n1 + Elem::kRows - 1) / Elem::kRows, a.splits,
                  Elem::kPull ? 1 : (a.rc + kGroup - 1) / kGroup);
  gibbs_rows_kernel<Elem, D, RB><<<grid, kK2Threads, 0, s>>>(
      a.x1, a.l1, a.n1, a.x2, a.l2, a.n2, a.v, a.ldv, a.rc, a.d,
      a.cols_per_split, a.part, a.f1);
}

// Accumulators per row: the smallest bucket that holds one rhs group
// (mBCG's 1 + 8 probes take 9 exactly).
template <class Elem, int D>
void matvec_rb(const MatvecArgs& a, cudaStream_t s) {
  const int w = a.rc < kGroup ? a.rc : kGroup;
  if (w <= 1) launch_matvec<Elem, D, 1>(a, s);
  else if (w <= 4) launch_matvec<Elem, D, 4>(a, s);
  else if (w <= 9) launch_matvec<Elem, D, 9>(a, s);
  else if (w <= 16) launch_matvec<Elem, D, 16>(a, s);
  else launch_matvec<Elem, D, kGroup>(a, s);
}

// The launches of K2 or K6: the walk, then the fixed-order sum of the
// column slices.
template <class Elem>
int run_matvec(const MatvecArgs& a, cudaStream_t s) {
  switch (a.d) {
    case 1: matvec_rb<Elem, 1>(a, s); break;
    case 2: matvec_rb<Elem, 2>(a, s); break;
    case 3: matvec_rb<Elem, 3>(a, s); break;
    default: matvec_rb<Elem, kMaxD>(a, s); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t m = static_cast<size_t>(a.n1) * a.rc;
  sum_splits_kernel<<<static_cast<unsigned>((m + 255) / 256), 256, 0, s>>>(
      a.part, a.splits, a.n1, a.rc, a.out, a.ldo);
  return static_cast<int>(cudaGetLastError());
}

bool matvec_args_ok(int n1, int n2, int d, int ldv, int rc, int ldo,
                    int splits, int cols_per_split) {
  return n1 >= 1 && n2 >= 1 && d >= 1 && d <= kMaxD && rc >= 1 &&
         rc <= kMaxR && ldv >= rc && ldo >= rc && splits >= 1 &&
         cols_per_split >= 1 &&
         static_cast<long long>(splits) * cols_per_split >= n2;
}

// K3's factors a column, 1 + 2R: the smallest bucket that holds them (the
// path's R = 8 probes take 17 exactly).
template <int D>
void panel_fb(const MatvecArgs& a, cudaStream_t s) {
  if (a.rc <= 3) launch_matvec<PanelElem, D, 3>(a, s);
  else if (a.rc <= 9) launch_matvec<PanelElem, D, 9>(a, s);
  else if (a.rc <= 17) launch_matvec<PanelElem, D, 17>(a, s);
  else if (a.rc <= 33) launch_matvec<PanelElem, D, 33>(a, s);
  else launch_matvec<PanelElem, D, kMaxF>(a, s);
}


// ---- the tensor-core contraction of K2 and K6 ('default', 'high3') ----

constexpr int kMmaMT = 2;      // 16-row tiles a warp owns
constexpr int kMmaRows = (kK2Threads / 32) * kMmaMT * 16;  // rows a block owns
constexpr int kMmaPass = 64;   // columns a shared-memory pass
constexpr int kMmaGroup = 32;  // right-hand sides a block contracts: 4 tiles of 8

// u32 words between two packed column-pair rows of V in shared memory: the
// group's tiles of 8, padded so that the B-fragment loads of a warp (pair
// rows t and t + 4 at columns g) fall in 32 distinct banks.
__host__ __device__ constexpr int mma_stride(int nt) { return nt * 8 + (nt % 2 == 0 ? 8 : 0); }

// Two elements as bf16 hi parts (the lower column in the low half, as the
// A fragment wants it) and the bf16 rounding of what they leave, the lo
// parts (k - hi is exact in f32).
__device__ __forceinline__ void bf16_split(float k0, float k1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(k0, k1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(k0 - hf.x, k1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// c += a b on the tensor cores: a the 16 x 16 bf16 A fragment (4 words), b
// the 16 x 8 bf16 B fragment (2 words), c the 16 x 8 f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of the tensor-core walk, in 4-byte words: the raw column
// payload (x, then for K2 l, kMmaPass * D each) and V's packed hi and lo
// pair rows (kMmaPass / 2 of them, mma_stride(NT) words each) of two
// passes, then at d = 2 the column factors of the current pass.
template <class Elem, int D, int NT>
struct MmaSmem {
  static constexpr int kRaw = (Elem::kL ? 2 : 1) * kMmaPass * D;
  static constexpr int kS = mma_stride(NT);
  static constexpr int kV = (kMmaPass / 2) * kS;
  static constexpr int kStage = kRaw + 2 * kV;
  static constexpr int kCook = D == 2 ? Elem::kCook * kMmaPass : 0;
  static constexpr int kWords = 2 * kStage + kCook;
  static_assert(kWords * 4 <= 48 * 1024, "the tensor-core walk's shared memory is static: 48 KB at most");
};

// part[s, i, g0 + r] = sum over slice s of contract(K(i, j), v[j, g0 + r])
// for the rhs group g0 = kMmaGroup * blockIdx.z, r < min(kMmaGroup, rc - g0),
// where contract is hi.hi ('default') or hi.hi + hi.lo + lo.hi ('high3').
// vhi, vlo: V's bf16 parts packed in column pairs, word [p * ldp + r] =
// (v[2p, r], v[2p + 1, r]), npair rows (v's rows padded to even with 0),
// ldp >= rc words a row (the columns past rc 0).
template <class Elem, int D, int NT>
__global__ void __launch_bounds__(kK2Threads)
gibbs_mma_kernel(const float* __restrict__ x1, const float* __restrict__ l1, int n1,
                 const float* __restrict__ x2, const float* __restrict__ l2, int n2,
                 const uint32_t* __restrict__ vhi, const uint32_t* __restrict__ vlo, int ldp,
                 int npair, int rc, int d, int cols_per_split, int high3,
                 float* __restrict__ part) {
  using S = MmaSmem<Elem, D, NT>;
  constexpr int kP = kMmaPass;
  __shared__ __align__(16) float sm[S::kWords];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;  // the fragments' row (A, C) and column (B) within a tile
  const int t = lane & 3;   // their column pair (A, C) and row pair (B)
  const int s = blockIdx.y;
  const int g0 = blockIdx.z * kMmaGroup;
  const int gw = min(kMmaGroup, rc - g0);
  const int row0 = blockIdx.x * kMmaRows + (tid >> 5) * (kMmaMT * 16) + g;

  // the rows' payloads: rows row0 + 16 mt + 8 h; an inactive row gets x = 0, l = 1
  float xi[kMmaMT][2][D], li[kMmaMT][2][D];
  typename Elem::Row rf[kMmaMT][2];
#pragma unroll
  for (int mt = 0; mt < kMmaMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + 16 * mt + 8 * h;
      load_row<D>(x1, l1, i, i < n1, d, xi[mt][h], li[mt][h]);
      if constexpr (D == 2) rf[mt][h] = Elem::row(xi[mt][h], li[mt][h]);
    }
  float acc[kMmaMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMmaMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;

  const int c_begin = s * cols_per_split;  // even: a split is whole kCols
  const int c_end = min(n2, c_begin + cols_per_split);
  const int npass = (c_end - c_begin + kP - 1) / kP;
  // pass n's columns [c0, c0 + jn) into stage b: x (and l) at [j * D + k],
  // zero past jn; V's pair rows c0 / 2 + p at [p * kS + r] (hi, then lo
  // for 'high3'), zero past npair and past the group
  auto stage = [&](int n, int b) {
    float* xs = sm + b * S::kStage;
    float* ls = xs + kP * D;
    uint32_t* vh = reinterpret_cast<uint32_t*>(xs + S::kRaw);
    const int c0 = c_begin + n * kP;
    const int jn = min(kP, c_end - c0);
    for (int e = tid; e < kP * d; e += kK2Threads) {
      const int j = e / d, k = e % d;
      const bool ok = j < jn;
      const size_t gi = static_cast<size_t>(c0 + j) * d + k;
      cp_async4(xs + j * D + k, ok ? x2 + gi : x2, ok);
      if constexpr (Elem::kL) cp_async4(ls + j * D + k, ok ? l2 + gi : l2, ok);
    }
    for (int e = tid; e < (kP / 2) * (NT * 8); e += kK2Threads) {
      const int p = e / (NT * 8), r = e % (NT * 8);
      const int pg = c0 / 2 + p;
      const bool ok = pg < npair && r < gw;
      const size_t gi = static_cast<size_t>(pg) * ldp + g0 + r;
      cp_async4(reinterpret_cast<float*>(vh + p * S::kS + r),
                reinterpret_cast<const float*>(ok ? vhi + gi : vhi), ok);
      if (high3)
        cp_async4(reinterpret_cast<float*>(vh + S::kV + p * S::kS + r),
                  reinterpret_cast<const float*>(ok ? vlo + gi : vlo), ok);
    }
    cp_async_commit();
  };

  stage(0, 0);
  for (int n = 0; n < npass; ++n) {
    const int b = n & 1;
    cp_async_wait_all();
    __syncthreads();  // pass n has landed; every thread is done with pass n - 1
    if (n + 1 < npass) stage(n + 1, b ^ 1);
    const float* xs = sm + b * S::kStage;
    const float* ls = xs + kP * D;
    const uint32_t* vh = reinterpret_cast<const uint32_t*>(xs + S::kRaw);
    const uint32_t* vl = vh + S::kV;
    const int jn = min(kP, c_end - (c_begin + n * kP));
    float* ck = sm + 2 * S::kStage;
    if constexpr (D == 2) {
      for (int j = tid; j < kP; j += kK2Threads) Elem::template cook<kP>(ck, xs, ls, j);
      __syncthreads();
    }
#pragma unroll 1
    for (int jb = 0; jb < kP; jb += 16) {
      // this thread's columns of the step: the A fragment's 2t, 2t + 1,
      // 2t + 8, 2t + 9; a column past the slice's end gives 0
      int cj[4] = {jb + 2 * t, jb + 2 * t + 1, jb + 2 * t + 8, jb + 2 * t + 9};
      float kv[kMmaMT][2][4];
      if constexpr (D == 2) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const typename Elem::Col c = Elem::template col<kP>(ck, cj[q]);
#pragma unroll
          for (int mt = 0; mt < kMmaMT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) kv[mt][h][q] = cj[q] < jn ? Elem::elem2(rf[mt][h], c) : 0.0f;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int mt = 0; mt < kMmaMT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              kv[mt][h][q] = cj[q] < jn ? Elem::template elem<D>(xi[mt][h], li[mt][h], xs + cj[q] * D,
                                                                 ls + cj[q] * D, d)
                                        : 0.0f;
      }
      // B fragments: pair rows jb/2 + t (columns 2t, 2t + 1) and
      // jb/2 + t + 4 (2t + 8, 2t + 9), right-hand side g of each tile
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int w0 = (jb / 2 + t) * S::kS + nt * 8 + g;
        const int w1 = w0 + 4 * S::kS;
        bh[nt][0] = vh[w0];
        bh[nt][1] = vh[w1];
        bl[nt][0] = high3 ? vl[w0] : 0u;
        bl[nt][1] = high3 ? vl[w1] : 0u;
      }
#pragma unroll
      for (int mt = 0; mt < kMmaMT; ++mt) {
        // A fragment words: (row g, cols 2t, 2t+1), (g+8, 2t, 2t+1),
        // (g, 2t+8, 2t+9), (g+8, 2t+8, 2t+9)
        uint32_t ah[4], al[4];
        bf16_split(kv[mt][0][0], kv[mt][0][1], ah[0], al[0]);
        bf16_split(kv[mt][1][0], kv[mt][1][1], ah[1], al[1]);
        bf16_split(kv[mt][0][2], kv[mt][0][3], ah[2], al[2]);
        bf16_split(kv[mt][1][2], kv[mt][1][3], ah[3], al[3]);
        // the tensor cores' f32 accumulation truncates: chained over a
        // split's columns it would drop up to an ulp of the running sum a
        // step, all in one direction.  A step's mma run into a zeroed
        // fragment, added to the sum in FP32 (round to nearest).
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(c, ah, bh[nt][0], bh[nt][1]);
          if (high3) {
            mma_bf16(c, ah, bl[nt][0], bl[nt][1]);
            mma_bf16(c, al, bh[nt][0], bh[nt][1]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += c[q];
        }
      }
    }
  }
  // C fragment: (row g, rhs 2t, 2t + 1) then (row g + 8, the same) of each tile
#pragma unroll
  for (int mt = 0; mt < kMmaMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + 16 * mt + 8 * h;
      if (i >= n1) continue;
      float* out = part + (static_cast<size_t>(s) * n1 + i) * rc + g0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = nt * 8 + 2 * t + e;
          if (r < gw) out[r] = acc[mt][nt][2 * h + e];
        }
    }
}

struct MmaArgs {
  const float *x1, *l1, *x2, *l2;
  const uint32_t *vhi, *vlo;
  float *out, *part;
  int n1, n2, d, ldp, npair, rc, ldo, splits, cols_per_split, high3;
};

template <class Elem, int D, int NT>
void launch_mma(const MmaArgs& a, cudaStream_t s) {
  const dim3 grid((a.n1 + kMmaRows - 1) / kMmaRows, a.splits, (a.rc + kMmaGroup - 1) / kMmaGroup);
  gibbs_mma_kernel<Elem, D, NT><<<grid, kK2Threads, 0, s>>>(
      a.x1, a.l1, a.n1, a.x2, a.l2, a.n2, a.vhi, a.vlo, a.ldp, a.npair, a.rc, a.d,
      a.cols_per_split, a.high3, a.part);
}

// Tiles of 8 right-hand sides a block contracts: the fewest that hold one
// group (mBCG's 1 + 8 probes take 2).
template <class Elem, int D>
void mma_nt(const MmaArgs& a, cudaStream_t s) {
  const int w = a.rc < kMmaGroup ? a.rc : kMmaGroup;
  if (w <= 8) launch_mma<Elem, D, 1>(a, s);
  else if (w <= 16) launch_mma<Elem, D, 2>(a, s);
  else launch_mma<Elem, D, 4>(a, s);
}

// The launches of K2's or K6's mode: the tensor-core walk, then the
// fixed-order sum of the column slices.
template <class Elem>
int run_mma(const MmaArgs& a, cudaStream_t s) {
  switch (a.d) {
    case 1: mma_nt<Elem, 1>(a, s); break;
    case 2: mma_nt<Elem, 2>(a, s); break;
    case 3: mma_nt<Elem, 3>(a, s); break;
    default: mma_nt<Elem, kMaxD>(a, s); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t m = static_cast<size_t>(a.n1) * a.rc;
  sum_splits_kernel<<<static_cast<unsigned>((m + 255) / 256), 256, 0, s>>>(
      a.part, a.splits, a.n1, a.rc, a.out, a.ldo);
  return static_cast<int>(cudaGetLastError());
}

bool mma_args_ok(int n1, int n2, int d, int ldp, int npair, int rc, int ldo, int splits,
                 int cols_per_split) {
  return matvec_args_ok(n1, n2, d, ldp, rc, ldo, splits, cols_per_split) &&
         npair == (n2 + 1) / 2 && cols_per_split % kCols == 0;
}

}  // namespace

extern "C" {

// K2.  x1, l1: (n1, d); x2, l2: (n2, d); v: rows of stride ldv, columns
// [0, rc); out: rows of stride ldo, columns [0, rc); part: splits*n1*rc
// scratch.  All f32, row-major.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
int gibbs_matvec(const void* x1, const void* l1, int n1, const void* x2,
                 const void* l2, int n2, int d, const void* v, int ldv,
                 int rc, void* out, int ldo, void* part, int splits,
                 int cols_per_split, void* stream) {
  if (!matvec_args_ok(n1, n2, d, ldv, rc, ldo, splits, cols_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const MatvecArgs a{static_cast<const float*>(x1), static_cast<const float*>(l1),
                     static_cast<const float*>(x2), static_cast<const float*>(l2),
                     static_cast<const float*>(v),  static_cast<float*>(out),
                     static_cast<float*>(part),     n1, n2, d, ldv, rc, ldo,
                     splits, cols_per_split};
  return run_matvec<GibbsElem>(a, static_cast<cudaStream_t>(stream));
}

// K6.  z1: (n1, d) and z2: (n2, d), the prescaled x / ell; v, out and part
// as in gibbs_matvec.  Launches on `stream` and returns cudaGetLastError()
// as an int.
int rbf_matvec(const void* z1, int n1, const void* z2, int n2, int d,
               const void* v, int ldv, int rc, void* out, int ldo, void* part,
               int splits, int cols_per_split, void* stream) {
  if (!matvec_args_ok(n1, n2, d, ldv, rc, ldo, splits, cols_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* pz1 = static_cast<const float*>(z1);
  const float* pz2 = static_cast<const float*>(z2);
  const MatvecArgs a{pz1, pz1, pz2, pz2, static_cast<const float*>(v),
                     static_cast<float*>(out), static_cast<float*>(part),
                     n1, n2, d, ldv, rc, ldo, splits, cols_per_split};
  return run_matvec<RbfElem>(a, static_cast<cudaStream_t>(stream));
}

// K3.  Rows xr, lr: (nr, d), f1r: (nr, fw); columns xc, lc: (n, d),
// f2c: (n, fw); outputs gx, gl: (nr, d), sp: (nr,); part: splits*nr*(1+2d)
// scratch.  All f32, row-major.  Launches the walk and the fixed-order sum
// on `stream` and returns cudaGetLastError() as an int.
int gibbs_panel_grads(const void* xr, const void* lr, const void* f1r, int nr,
                      const void* xc, const void* lc, const void* f2c, int n,
                      int d, int fw, void* gx, void* gl, void* sp, void* part,
                      int splits, int cols_per_split, void* stream) {
  if (nr < 1 || n < 1 || d < 1 || d > kMaxD || fw < 1 || fw > kMaxF ||
      splits < 1 || cols_per_split < 1 ||
      static_cast<long long>(splits) * cols_per_split < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* plr = static_cast<const float*>(lr);
  const MatvecArgs a{static_cast<const float*>(xr), plr,
                     static_cast<const float*>(xc), static_cast<const float*>(lc),
                     static_cast<const float*>(f2c), nullptr, static_cast<float*>(part),
                     nr, n, d, fw, fw, fw, splits, cols_per_split,
                     static_cast<const float*>(f1r)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: panel_fb<1>(a, s); break;
    case 2: panel_fb<2>(a, s); break;
    case 3: panel_fb<3>(a, s); break;
    default: panel_fb<kMaxD>(a, s); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  panel_grads_finish_kernel<<<(nr + 127) / 128, 128, 0, s>>>(
      a.part, splits, nr, d, plr, d == 2 ? kLn2 : 1.0f, static_cast<float*>(gx),
      static_cast<float*>(gl), static_cast<float*>(sp));
  return static_cast<int>(cudaGetLastError());
}

// K2's 'default' (high3 = 0) and 'high3' (high3 = 1) contractions.  x1, l1,
// x2, l2 as in gibbs_matvec; vhi, vlo: V's bf16 hi and lo parts packed in
// column pairs, npair = (n2 + 1) / 2 rows of ldp >= rc words (vlo unread
// when high3 = 0); out, part as in gibbs_matvec; cols_per_split a multiple
// of 128.  Launches on `stream` and returns cudaGetLastError() as an int.
int gibbs_matvec_mma(const void* x1, const void* l1, int n1, const void* x2,
                     const void* l2, int n2, int d, const void* vhi, const void* vlo,
                     int ldp, int npair, int rc, void* out, int ldo, void* part,
                     int splits, int cols_per_split, int high3, void* stream) {
  if (!mma_args_ok(n1, n2, d, ldp, npair, rc, ldo, splits, cols_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const MmaArgs a{static_cast<const float*>(x1), static_cast<const float*>(l1),
                  static_cast<const float*>(x2), static_cast<const float*>(l2),
                  static_cast<const uint32_t*>(vhi), static_cast<const uint32_t*>(vlo),
                  static_cast<float*>(out), static_cast<float*>(part),
                  n1, n2, d, ldp, npair, rc, ldo, splits, cols_per_split, high3 != 0};
  return run_mma<GibbsElem>(a, static_cast<cudaStream_t>(stream));
}

// K6's 'default' and 'high3' contractions on the prescaled z = x / ell; the
// rest as in gibbs_matvec_mma.
int rbf_matvec_mma(const void* z1, int n1, const void* z2, int n2, int d,
                   const void* vhi, const void* vlo, int ldp, int npair, int rc,
                   void* out, int ldo, void* part, int splits, int cols_per_split,
                   int high3, void* stream) {
  if (!mma_args_ok(n1, n2, d, ldp, npair, rc, ldo, splits, cols_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* pz1 = static_cast<const float*>(z1);
  const float* pz2 = static_cast<const float*>(z2);
  const MmaArgs a{pz1, pz1, pz2, pz2,
                  static_cast<const uint32_t*>(vhi), static_cast<const uint32_t*>(vlo),
                  static_cast<float*>(out), static_cast<float*>(part),
                  n1, n2, d, ldp, npair, rc, ldo, splits, cols_per_split, high3 != 0};
  return run_mma<RbfElem>(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
