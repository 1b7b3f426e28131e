// K12, the solve: RANSAC's homographies from their minimal sets
// (dlt4_solve_kernel), and the eigenvector of the smallest eigenvalue of
// symmetric 9x9 matrices (jacobi9_kernel, the refit's system), both by
// Jacobi rotations in float64 in one warp a system.
//
// No TPU kernel: the JAX package solves RANSAC's DLT with XLA ops and
// `jnp.linalg.eigh` (efficient_features_tpu/ops/ransac.py:51 `_dlt`, eigh at
// :71).  The port's counterpart of eigh, `torch.linalg.eigh`, reads its
// solver's status back to the host on every call, and the DLT around it
// was some 40 small torch launches; here a RANSAC call solves all its sets
// in one launch and reads nothing back (ops/ransac.solve_minimal_sets,
// ops/ransac.smallest_eigvec9).
//
// Semantics, op by op as the plain versions (ops/ransac.py):
//   - a set (minimal_set_systems): its 4 pairs gathered, each side
//     Hartley-normalised with weights 1 (centroid ((p0 + p1) + p2) + p3
//     times 1/4, the mean of the 4 distances likewise, s = sqrt(2) /
//     max(mean, 1e-8)), the 8x9 design (the four (x, y, 1, 0, 0, 0, -ux,
//     -uy, -u) rows, then the four (0, 0, 0, x, y, 1, -vx, -vy, -v) rows)
//     and A^T A in float32, each entry the sum of its 8 products in row
//     order;
//   - the Jacobi body (_jacobi9) on the float64 matrix, V = I: up to
//     `sweeps` sweeps of the round-robin rounds of ops/ransac.jacobi_rounds
//     (4 disjoint pairs p < q a round), stopping before a sweep once every
//     off-diagonal |a_pq| <= tol * max |a_ii|.  A round takes its four
//     rotations from the matrix as the round finds it: d = a_qq - a_pp,
//     e = 2 a_pq, r = sqrt(d^2 + e^2), w = |d| + r, n = sqrt(w^2 + e^2),
//     c = w (1 / n), s = +-e (1 / n) (+ for d >= 0), and c = 1, s = 0 where
//     a_pq = 0; then the pairs' columns of the matrix and of V, then the
//     matrix's rows, with zeros at (p, q) and (q, p);
//   - V's column at the smallest diagonal entry (the first on ties), in
//     float32;
//   - for a set (_denormalize): H = Td^-1 Hn Ts in closed form and H / h22
//     unless |h22| < 1e-12.
// Every step is one IEEE operation, rounded alone (`-fmad=false`,
// correctly rounded division, reciprocal and square root), so the kernels
// and the plain versions give the same bits.
//
// What bounds it on the H100: latency.  A RANSAC call solves `iters` sets
// in one launch and the refit's one matrix in another, so the card is
// nearly empty and the time is one system's chain: up to 8 sweeps of 9
// rounds (6 or 7 sweeps on RANSAC's sets), each round a chain of about 18
// dependent float64 steps (the rotation's subtract, multiply, add, square
// root, add, multiply, add, square root, reciprocal and multiply; then a
// load, multiply, subtract and store for the columns and again for the
// rows).  The design shortens that chain: one reciprocal and two square
// roots a rotation (the kernel before had three divisions and two square
// roots in a row); lanes 0-3 compute the round's four rotations, shuffled
// to every lane; the schedule's indices are compile-time constants (the
// rounds unrolled); the columns of the matrix (lanes 0-8) and of V (lanes
// 16-24) are one pass and the rows another (pairs 0-1 in lanes 0-8, 2-3
// in lanes 16-24), so a round has two `__syncwarp`s, not four; and a
// converged matrix stops.  A warp holds one system in shared memory; in
// the column pass a lane owns a row, in the row pass a column of two
// pairs' rows, so no two lanes write one entry in a pass.  (The kernel
// before this design, three divisions a rotation and four passes a round,
// took 0.0803 ms a launch of 257 systems on an H100 SXM.)
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"

namespace {

constexpr int kN = 9;
constexpr int kPairs = 4;                 // per round
constexpr int kRounds = 9;                // per sweep
constexpr int kWarps = 4;                 // systems per block, one a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSqrt2 = 0x1.6a09e6p+0f;  // float32 sqrt(2)
constexpr float kEpsMean = 1e-8f;         // Hartley's mean distance floor
constexpr float kEpsH22 = 1e-12f;         // |h22| below it: no rescale

// The round-robin schedule of ops/ransac.jacobi_rounds: ten players, 0
// fixed and 1-9 turning one place a round (9 the bye); round r's position
// j holds `player(r, j)`, and its pairs are positions (i, 9 - i), i < 5,
// without the one that holds player 9, in order of i.
__host__ __device__ constexpr int player(int r, int j) {
  return j == 0 ? 0 : 1 + ((j - 1 - r) % 9 + 9) % 9;
}
__host__ __device__ constexpr int pair_pos(int r, int k) {
  return k < ((r + 8) % 9 + 1 < 9 - ((r + 8) % 9 + 1)
                  ? (r + 8) % 9 + 1 : 9 - ((r + 8) % 9 + 1))
             ? k : k + 1;
}
__host__ __device__ constexpr int pair_p(int r, int k) {
  return player(r, pair_pos(r, k)) < player(r, 9 - pair_pos(r, k))
             ? player(r, pair_pos(r, k)) : player(r, 9 - pair_pos(r, k));
}
__host__ __device__ constexpr int pair_q(int r, int k) {
  return player(r, pair_pos(r, k)) < player(r, 9 - pair_pos(r, k))
             ? player(r, 9 - pair_pos(r, k)) : player(r, pair_pos(r, k));
}
// Pair i (a lane index, 0-3) of compile-time round r: its p or its q.
__device__ __forceinline__ int pair_index(int r, int i, bool want_p) {
  const int p0 = want_p ? pair_p(r, 0) : pair_q(r, 0);
  const int p1 = want_p ? pair_p(r, 1) : pair_q(r, 1);
  const int p2 = want_p ? pair_p(r, 2) : pair_q(r, 2);
  const int p3 = want_p ? pair_p(r, 3) : pair_q(r, 3);
  return i == 0 ? p0 : i == 1 ? p1 : i == 2 ? p2 : p3;
}
static_assert(pair_p(0, 0) == 1 && pair_q(0, 0) == 8 && pair_p(2, 1) == 6 &&
                  pair_q(2, 1) == 8 && pair_p(8, 3) == 5 &&
                  pair_q(8, 3) == 6 && pair_p(6, 3) == 7,
              "the schedule of ops/ransac.jacobi_rounds");

// The Jacobi body on one warp's matrix a (9x9, float64, row-major, shared)
// with v = I on entry; on exit a is rotated and v holds the rotations.
__device__ __forceinline__ void jacobi9(double* a, double* v, int lane,
                                        int sweeps, double tol) {
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    double dmax = fabs(a[0]);
#pragma unroll
    for (int j = 1; j < kN; ++j) {
      const double x = fabs(a[j * kN + j]);
      dmax = (x > dmax || x != x) ? x : dmax;     // NaN propagates
    }
    const double thr = dmax * tol;
    bool ok = true;
    if (lane < kN) {
#pragma unroll
      for (int j = 0; j < kN; ++j)
        ok = ok && (j == lane || fabs(a[lane * kN + j]) <= thr);
    }
    if (__all_sync(kFull, ok)) break;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      // lane i < 4: the rotation of pair i, shuffled to every lane
      double my_c = 1.0, my_s = 0.0;
      if (lane < kPairs) {
        const int p = pair_index(r, lane, true);
        const int q = pair_index(r, lane, false);
        const double app = a[p * kN + p], aqq = a[q * kN + q];
        const double apq = a[p * kN + q];
        const double d = aqq - app;
        const double e = apq + apq;
        const double w = fabs(d) + __dsqrt_rn(d * d + e * e);
        const double inv = __drcp_rn(__dsqrt_rn(w * w + e * e));
        if (apq != 0.0) {
          my_c = w * inv;
          my_s = (d >= 0.0 ? e : -e) * inv;
        }
      }
      double c[kPairs], s[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        c[i] = __shfl_sync(kFull, my_c, i);
        s[i] = __shfl_sync(kFull, my_s, i);
      }
      // the pairs' columns: row `lane` of the matrix, row `lane - 16` of V
      if (lane < kN || (lane >= 16 && lane < 16 + kN)) {
        double* row = lane < kN ? a + lane * kN : v + (lane - 16) * kN;
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const int p = pair_p(r, i), q = pair_q(r, i);
          const double g = row[p], h = row[q];
          row[p] = c[i] * g - s[i] * h;
          row[q] = s[i] * g + c[i] * h;
        }
      }
      __syncwarp();
      // the pairs' rows: column `lane & 15` of the matrix, pairs 0 and 1 in
      // lanes 0-8, pairs 2 and 3 in lanes 16-24
      const int k = lane & 15, half = lane >> 4;
      if (k < kN) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = half ? pair_p(r, 2 + j) : pair_p(r, j);
          const int q = half ? pair_q(r, 2 + j) : pair_q(r, j);
          const double cj = half ? c[2 + j] : c[j];
          const double sj = half ? s[2 + j] : s[j];
          const double g = a[p * kN + k], h = a[q * kN + k];
          a[p * kN + k] = k == q ? 0.0 : cj * g - sj * h;
          a[q * kN + k] = k == p ? 0.0 : sj * g + cj * h;
        }
      }
      __syncwarp();
    }
  }
}

// The index of a's smallest diagonal entry, the first on ties.
__device__ __forceinline__ int smallest_diagonal(const double* a) {
  int best = 0;
#pragma unroll
  for (int j = 1; j < kN; ++j)
    if (a[j * kN + j] < a[best * kN + best]) best = j;
  return best;
}

__device__ __forceinline__ void identity9(double* v, int lane) {
  for (int e = lane; e < kN * kN; e += 32)
    v[e] = e / kN == e % kN ? 1.0 : 0.0;
}

__global__ void __launch_bounds__(kWarps * 32)
jacobi9_kernel(const float* __restrict__ ata, int n, int sweeps, double tol,
               float* __restrict__ vec) {
  __shared__ double s_a[kWarps][kN * kN];
  __shared__ double s_v[kWarps][kN * kN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= n) return;                     // warp-uniform
  double* a = s_a[warp];
  double* v = s_v[warp];
  for (int e = lane; e < kN * kN; e += 32)
    a[e] = static_cast<double>(ata[static_cast<size_t>(m) * kN * kN + e]);
  identity9(v, lane);
  __syncwarp();
  jacobi9(a, v, lane, sweeps, tol);
  const int best = smallest_diagonal(a);
  if (lane < kN)
    vec[static_cast<size_t>(m) * kN + lane] =
        static_cast<float>(v[lane * kN + best]);
}

struct Norm {
  float s, cx, cy;
};

// Hartley normalisation of 4 points with weights 1 (ops/ransac._hartley4):
// x, y become the normalised coordinates.
__device__ __forceinline__ Norm hartley4(float* x, float* y) {
  Norm t;
  t.cx = (((x[0] + x[1]) + x[2]) + x[3]) * 0.25f;
  t.cy = (((y[0] + y[1]) + y[2]) + y[3]) * 0.25f;
  float dist[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = x[k] - t.cx;
    y[k] = y[k] - t.cy;
    dist[k] = __fsqrt_rn(x[k] * x[k] + y[k] * y[k]);
  }
  const float mean = (((dist[0] + dist[1]) + dist[2]) + dist[3]) * 0.25f;
  t.s = __fdiv_rn(kSqrt2, mean < kEpsMean ? kEpsMean : mean);  // NaN stays
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = x[k] * t.s;
    y[k] = y[k] * t.s;
  }
  return t;
}

__global__ void __launch_bounds__(kWarps * 32)
dlt4_solve_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                  const int64_t* __restrict__ idx, int m, int sweeps,
                  double tol, float* __restrict__ H) {
  __shared__ double s_a[kWarps][kN * kN];
  __shared__ double s_v[kWarps][kN * kN];
  __shared__ float s_d[kWarps][8 * kN];   // the design A, 8 rows of 9
  __shared__ float s_h[kWarps][kN];       // the null vector Hn
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int set = blockIdx.x * kWarps + warp;
  if (set >= m) return;                   // warp-uniform
  double* a = s_a[warp];
  double* v = s_v[warp];
  float* A = s_d[warp];
  // every lane: the set's pairs, normalised
  float x[4], y[4], u[4], w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t j = idx[static_cast<size_t>(set) * 4 + k];
    x[k] = src[2 * j];
    y[k] = src[2 * j + 1];
    u[k] = dst[2 * j];
    w[k] = dst[2 * j + 1];
  }
  const Norm ns = hartley4(x, y);
  const Norm nd = hartley4(u, w);
  // the design: entry e of row-major A (8 x 9) stored by lane e % 32
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float r1[kN] = {x[k], y[k], 1.0f, 0.0f, 0.0f, 0.0f, -u[k] * x[k],
                          -u[k] * y[k], -u[k]};
    const float r2[kN] = {0.0f, 0.0f, 0.0f, x[k], y[k], 1.0f, -w[k] * x[k],
                          -w[k] * y[k], -w[k]};
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (((k * kN + j) & 31) == lane) A[k * kN + j] = r1[j];
      if ((((4 + k) * kN + j) & 31) == lane) A[(4 + k) * kN + j] = r2[j];
    }
  }
  identity9(v, lane);
  __syncwarp();
  // A^T A: upper-triangle entry t (of 45) by lane t % 32, mirrored
  for (int t = lane; t < kN * (kN + 1) / 2; t += 32) {
    int i = 0, rest = t;
    while (rest >= kN - i) {
      rest -= kN - i;
      ++i;
    }
    const int j = i + rest;
    float acc = A[i] * A[j];
#pragma unroll
    for (int r = 1; r < 8; ++r) acc = acc + A[r * kN + i] * A[r * kN + j];
    a[i * kN + j] = static_cast<double>(acc);
    a[j * kN + i] = static_cast<double>(acc);
  }
  __syncwarp();
  jacobi9(a, v, lane, sweeps, tol);
  const int best = smallest_diagonal(a);
  if (lane < kN) s_h[warp][lane] = static_cast<float>(v[lane * kN + best]);
  __syncwarp();
  // H = Td^-1 Hn Ts, then / h22 (ops/ransac._denormalize), in every lane
  const float* h = s_h[warp];
  const float tx = -(ns.s * ns.cx), ty = -(ns.s * ns.cy);
  const float isd = __fdiv_rn(1.0f, nd.s);
  float hm[kN];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    hm[3 * i] = h[3 * i] * ns.s;
    hm[3 * i + 1] = h[3 * i + 1] * ns.s;
    hm[3 * i + 2] = (h[3 * i] * tx + h[3 * i + 1] * ty) + h[3 * i + 2];
  }
  float out[kN];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[j] = hm[j] * isd + nd.cx * hm[6 + j];
    out[3 + j] = hm[3 + j] * isd + nd.cy * hm[6 + j];
    out[6 + j] = hm[6 + j];
  }
  const float den = fabsf(out[8]) < kEpsH22 ? 1.0f : out[8];
#pragma unroll
  for (int k = 0; k < kN; ++k)
    if (k == lane)
      H[static_cast<size_t>(set) * kN + k] = __fdiv_rn(out[k], den);
}

}  // namespace

extern "C" int eff_jacobi_eigh9(const float* ata, int n, int sweeps,
                                double tol, float* vec, void* stream) {
  if (n < 1 || sweeps < 0) return cudaErrorInvalidValue;
  jacobi9_kernel<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(ata, n, sweeps, tol,
                                                        vec);
  return cudaGetLastError();
}

extern "C" int eff_dlt4_solve(const float* src, const float* dst,
                              const int64_t* idx, int m, int sweeps,
                              double tol, float* H, void* stream) {
  if (m < 1 || sweeps < 0) return cudaErrorInvalidValue;
  dlt4_solve_kernel<<<(m + kWarps - 1) / kWarps, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(src, dst, idx, m,
                                                           sweeps, tol, H);
  return cudaGetLastError();
}
