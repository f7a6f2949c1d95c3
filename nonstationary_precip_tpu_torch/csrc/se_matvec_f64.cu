// K12: the log-normal prior's Scale(RBF-ARD) Gram times V in float64, with
// the Gram never in memory, for Hopper (sm_90a).  The function of K6
// (nonstationary_precip_tpu/ops/pallas_matvec.py::make_rbf_matvec) at the
// prior's precision (ROADMAP F6): the JAX package runs the prior's
// matrix-free solves as plain panels
// (nonstationary_precip_tpu/priors/lognormal_process.py, _lazy_matvec over
// _dim_cross), and the port's plain version is those panels in float64.
// The wrapper, the plain version and the design notes are in
// nonstationary_precip_tpu_torch/ops/matvec.py.
//
//   out[i, c] = s2 * sum_j exp(-|z1_i - z2_j|^2) v[j, c]  (+ sigma2 v[i, c]
//               where `square`: z1 is z2, the jittered operator)
//
// with z = x / (ell sqrt 2) prescaled by the wrapper, in float64
// throughout: payload, element, exp and accumulators.
//
// One walk, simple by design: a block of kThreads threads owns
// kThreads * RowsPerThread rows, each thread RowsPerThread of them (rows
// tid, tid + kThreads, ..), with their z and RB accumulators in registers;
// the block walks its slice of the columns in passes of kCols, staging z2
// and V's rows of each pass in shared memory, and every element is built
// and contracted at once.  The exponential dominates an element and has no
// special-function unit in float64, so the tensor cores cannot help.  A
// launch's gridDim.z covers V's columns in groups of RB <= kGroup, each
// group building its elements again.  The column range is cut into
// `splits` slices (gridDim.y), each writing its partial row sums to a
// scratch buffer, and a second kernel adds the slices in a fixed order,
// scales by s2 and adds the jitter: no atomics, so a result is the same
// bits on every run.  Offsets are 64-bit: N * N passes 2^31 from N = 46341.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kCols = 64;      // columns a shared-memory pass
constexpr int kGroup = 16;     // right-hand sides a block contracts
constexpr int kMaxD = 8;       // input dims

__host__ __device__ inline int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

// Rows a thread owns: 4 while its accumulators are few, 2 for 8 and 16.
template <int RB>
__host__ __device__ constexpr int rows_per_thread() {
  return RB <= 4 ? 4 : 2;
}

template <int D, int RB>
__global__ void __launch_bounds__(kThreads)
    se_f64_rows_kernel(const double* __restrict__ z1, int64_t n1,
                       const double* __restrict__ z2, int64_t n2,
                       const double* __restrict__ v, int64_t ldv, int r,
                       double* __restrict__ part, int64_t per) {
  constexpr int kRpt = rows_per_thread<RB>();
  __shared__ double zs[kCols * D];
  __shared__ double vs[kCols * RB];
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (kThreads * kRpt);
  const int c0 = blockIdx.z * RB;  // this group's first right-hand side
  const int rc = static_cast<int>(lmin(RB, r - c0));
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * per;
  const int64_t j1 = lmin(n2, j0 + per);

  double zi[kRpt][D];
  double acc[kRpt][RB];
#pragma unroll
  for (int u = 0; u < kRpt; ++u) {
    const int64_t i = row0 + tid + static_cast<int64_t>(u) * kThreads;
#pragma unroll
    for (int k = 0; k < D; ++k) zi[u][k] = i < n1 ? z1[i * D + k] : 0.0;
#pragma unroll
    for (int c = 0; c < RB; ++c) acc[u][c] = 0.0;
  }

  for (int64_t jb = j0; jb < j1; jb += kCols) {
    const int jn = static_cast<int>(lmin(kCols, j1 - jb));
    __syncthreads();
    for (int t = tid; t < kCols * D; t += kThreads)
      zs[t] = t < jn * D ? z2[jb * D + t] : 0.0;
    for (int t = tid; t < kCols * RB; t += kThreads) {
      const int j = t / RB, c = t - j * RB;
      vs[t] = (j < jn && c < rc) ? v[(jb + j) * ldv + c0 + c] : 0.0;
    }
    __syncthreads();
    for (int j = 0; j < jn; ++j) {
      double zj[D], vj[RB];
#pragma unroll
      for (int k = 0; k < D; ++k) zj[k] = zs[j * D + k];
#pragma unroll
      for (int c = 0; c < RB; ++c) vj[c] = vs[j * RB + c];
#pragma unroll
      for (int u = 0; u < kRpt; ++u) {
        // the quadratic from the differences: D subtractions, a product
        // and D - 1 FMAs; then exp and one FMA a right-hand side
        double dk = zi[u][0] - zj[0];
        double q = dk * dk;
#pragma unroll
        for (int k = 1; k < D; ++k) {
          dk = zi[u][k] - zj[k];
          q = fma(dk, dk, q);
        }
        const double e = exp(-q);
#pragma unroll
        for (int c = 0; c < RB; ++c) acc[u][c] = fma(e, vj[c], acc[u][c]);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kRpt; ++u) {
    const int64_t i = row0 + tid + static_cast<int64_t>(u) * kThreads;
    if (i >= n1) continue;
    double* o = part + (static_cast<int64_t>(blockIdx.y) * n1 + i) * r + c0;
#pragma unroll
    for (int c = 0; c < RB; ++c)
      if (c < rc) o[c] = acc[u][c];
  }
}

// Second pass: out[i, c] = s2 * sum_s part[s, i, c] (s in order), plus
// sigma2 * v[i, c] for the square operator.
__global__ void se_f64_finish_kernel(const double* __restrict__ part,
                                     int splits, int64_t n1, int r, double s2,
                                     const double* __restrict__ v, int64_t ldv,
                                     double sigma2, int square,
                                     double* __restrict__ out, int64_t ldo) {
  const int64_t m = n1 * r;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < m; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    double t = part[e];
    for (int s = 1; s < splits; ++s) t += part[s * m + e];
    const int64_t i = e / r;
    const int c = static_cast<int>(e - i * r);
    double o = s2 * t;
    if (square) o = fma(sigma2, v[i * ldv + c], o);
    out[i * ldo + c] = o;
  }
}

template <int D, int RB>
cudaError_t launch_rows(const double* z1, int64_t n1, const double* z2,
                        int64_t n2, const double* v, int64_t ldv, int r,
                        double* part, int splits, int64_t per,
                        cudaStream_t stream) {
  constexpr int kRows = kThreads * rows_per_thread<RB>();
  const dim3 grid(static_cast<unsigned>((n1 + kRows - 1) / kRows),
                  static_cast<unsigned>(splits),
                  static_cast<unsigned>((r + RB - 1) / RB));
  se_f64_rows_kernel<D, RB><<<grid, kThreads, 0, stream>>>(z1, n1, z2, n2, v,
                                                           ldv, r, part, per);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bucket(int rb, const double* z1, int64_t n1,
                          const double* z2, int64_t n2, const double* v,
                          int64_t ldv, int r, double* part, int splits,
                          int64_t per, cudaStream_t stream) {
  switch (rb) {
    case 1: return launch_rows<D, 1>(z1, n1, z2, n2, v, ldv, r, part, splits, per, stream);
    case 2: return launch_rows<D, 2>(z1, n1, z2, n2, v, ldv, r, part, splits, per, stream);
    case 4: return launch_rows<D, 4>(z1, n1, z2, n2, v, ldv, r, part, splits, per, stream);
    case 8: return launch_rows<D, 8>(z1, n1, z2, n2, v, ldv, r, part, splits, per, stream);
    case 16: return launch_rows<D, 16>(z1, n1, z2, n2, v, ldv, r, part, splits, per, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The exponential alone, as the walk calls it: its SASS is what the bound
// counts (chip_smoke.py reads it with cuobjdump).
__global__ void exp_f64_probe(const double* __restrict__ q, double* __restrict__ e,
                              int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) e[i] = exp(-q[i]);
}

extern "C" {

// K12.  z1: (n1, d), z2: (n2, d), the prescaled x / (ell sqrt 2); v: rows of
// stride ldv, columns [0, r); out: rows of stride ldo; part: splits*n1*r
// scratch; rb: the accumulators a thread keeps a row (1, 2, 4, 8 or 16; r
// is covered in groups of rb); cols_per_split a multiple of kCols; square:
// add sigma2 * v (z1 is z2).  All float64, row-major.  Launches the walk and
// the fixed-order sum on `stream` and returns cudaGetLastError() as an int
// (0 = launched).
int se_matvec_f64(const void* z1, long long n1, const void* z2, long long n2,
                  int d, const void* v, long long ldv, int r, int rb,
                  double s2, double sigma2, int square, void* out,
                  long long ldo, void* part, int splits,
                  long long cols_per_split, void* stream) {
  if (n1 < 1 || n2 < 1 || d < 1 || d > kMaxD || r < 1 || rb < 1 ||
      rb > kGroup || (r > rb && rb != kGroup) || ldv < r || ldo < r ||
      splits < 1 || cols_per_split < 1 || cols_per_split % kCols != 0 ||
      (square && n1 != n2) ||
      static_cast<long long>(splits - 1) * cols_per_split >= n2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pz1 = static_cast<const double*>(z1);
  const auto* pz2 = static_cast<const double*>(z2);
  const auto* pv = static_cast<const double*>(v);
  auto* ppart = static_cast<double*>(part);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 1: err = launch_bucket<1>(rb, pz1, n1, pz2, n2, pv, ldv, r, ppart, splits, cols_per_split, st); break;
    case 2: err = launch_bucket<2>(rb, pz1, n1, pz2, n2, pv, ldv, r, ppart, splits, cols_per_split, st); break;
    case 3: err = launch_bucket<3>(rb, pz1, n1, pz2, n2, pv, ldv, r, ppart, splits, cols_per_split, st); break;
    case 4: err = launch_bucket<4>(rb, pz1, n1, pz2, n2, pv, ldv, r, ppart, splits, cols_per_split, st); break;
    case 5: err = launch_bucket<5>(rb, pz1, n1, pz2, n2, pv, ldv, r, ppart, splits, cols_per_split, st); break;
    case 6: err = launch_bucket<6>(rb, pz1, n1, pz2, n2, pv, ldv, r, ppart, splits, cols_per_split, st); break;
    case 7: err = launch_bucket<7>(rb, pz1, n1, pz2, n2, pv, ldv, r, ppart, splits, cols_per_split, st); break;
    default: err = launch_bucket<8>(rb, pz1, n1, pz2, n2, pv, ldv, r, ppart, splits, cols_per_split, st); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t m = static_cast<int64_t>(n1) * r;
  const int blocks = static_cast<int>(lmin((m + 255) / 256, 4096));
  se_f64_finish_kernel<<<blocks, 256, 0, st>>>(ppart, splits, n1, r, s2, pv, ldv,
                                               sigma2, square,
                                               static_cast<double*>(out), ldo);
  return static_cast<int>(cudaGetLastError());
}

// The probe: e = exp(-q), n elements, on `stream`.
int se_exp_probe(const void* q, void* e, int n, void* stream) {
  exp_f64_probe<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(q), static_cast<double*>(e), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
