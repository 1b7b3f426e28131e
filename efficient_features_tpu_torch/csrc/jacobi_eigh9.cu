// K12: the eigenvector of the smallest eigenvalue of a batch of symmetric
// 9x9 matrices, by Jacobi rotations in float64.
//
// No TPU kernel: the JAX package solves RANSAC's DLT systems with
// `jnp.linalg.eigh` (efficient_features_tpu/ops/ransac.py:71), an XLA op.
// The port's counterpart, `torch.linalg.eigh`, checks its solver's status
// and so reads it back to the host on every call; this kernel reads
// nothing back, so a RANSAC call only enqueues work
// (ops/ransac.smallest_eigvec9).
//
// Semantics, per matrix, op by op as the plain version
// (ops/ransac.smallest_eigvec9_ref): the float32 matrix in float64, V = I,
// then `sweeps` sweeps of a round-robin schedule of 9 rounds, each of 4
// disjoint pairs (p < q) given by the wrapper.  A round takes each pair's
// rotation from the matrix as the round finds it:
//   theta = (a_qq - a_pp) / (2 a_pq),
//   t = +-1 / (|theta| + sqrt(theta^2 + 1)) (+ for theta >= 0), 0 if a_pq = 0,
//   c = 1 / sqrt(t^2 + 1), s = t c,
// then rotates the four pairs' columns of the matrix, then their rows, sets
// a_pp - t a_pq, a_qq + t a_pq and two zeros in place of the pairs' 2x2
// blocks, and rotates V's columns.  The result is V's column at the
// smallest diagonal entry (the first on ties), in float32.  Every step is
// one IEEE operation, rounded alone (`-fmad=false`, correctly rounded
// division and square root), so the kernel and the plain version give the
// same bits.
//
// What bounds it on the H100: latency.  A RANSAC call solves iters + 1
// matrices in two launches (256 or 512, then 1), about 51k float64
// operations each, so the card is nearly empty and the time is the chain
// of one matrix's rounds: four rotations whose division and square roots
// depend on each other, then the updates.  A warp holds one matrix and
// its V in shared memory: lanes 0-3 compute the round's four rotations,
// shuffled to all, then lane k (k < 9) rotates row k's entries of the
// four column pairs, then column k's entries of the four row pairs, then
// row k of V while lanes 9-12 set the four 2x2 blocks.  No two lanes
// write one entry within a pass, and every entry sees the plain version's
// operations in its order.  (The first design, one thread per matrix,
// took 0.336 ms a launch of 257 systems on an H100 SXM: each round's
// updates one after the other.)
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"

namespace {

constexpr int kN = 9;
constexpr int kPairs = 4;                 // per round
constexpr int kRounds = 9;                // per sweep
constexpr int kWarps = 4;                 // matrices per block, one a warp
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
jacobi9_kernel(const float* __restrict__ ata, int n,
               const int64_t* __restrict__ schedule, int sweeps,
               float* __restrict__ vec) {
  __shared__ double s_a[kWarps][kN * kN];
  __shared__ double s_v[kWarps][kN * kN];
  __shared__ int s_sched[kRounds * 2 * kPairs];
  for (int i = threadIdx.x; i < kRounds * 2 * kPairs; i += kWarps * 32)
    s_sched[i] = static_cast<int>(schedule[i]);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= n) return;                     // warp-uniform
  double* a = s_a[warp];
  double* v = s_v[warp];
#define A(i, j) a[(i) * kN + (j)]
#define V(i, j) v[(i) * kN + (j)]
  for (int e = lane; e < kN * kN; e += 32) {
    a[e] = static_cast<double>(ata[static_cast<size_t>(m) * kN * kN + e]);
    v[e] = e / kN == e % kN ? 1.0 : 0.0;
  }
  __syncwarp();
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int r = 0; r < kRounds; ++r) {
      const int* pr = s_sched + r * 2 * kPairs;    // p[4], then q[4]
      // lanes 0-3: the rotation of pair `lane`, from the round's matrix
      double my_c = 0.0, my_s = 0.0, my_t = 0.0, my_app = 0.0, my_aqq = 0.0,
             my_apq = 0.0;
      if (lane < kPairs) {
        const int p = pr[lane], q = pr[kPairs + lane];
        my_app = A(p, p);
        my_aqq = A(q, q);
        my_apq = A(p, q);
        const double theta = (my_aqq - my_app) / (2.0 * my_apq);
        const double rcp = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
        const double ti = theta >= 0.0 ? rcp : -rcp;
        my_t = my_apq == 0.0 ? 0.0 : ti;
        my_c = 1.0 / sqrt(my_t * my_t + 1.0);
        my_s = my_t * my_c;
      }
      double c[kPairs], s[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        c[i] = __shfl_sync(kFull, my_c, i);
        s[i] = __shfl_sync(kFull, my_s, i);
      }
      const double t = __shfl_sync(kFull, my_t, (lane - kN) & 3);
      const double app = __shfl_sync(kFull, my_app, (lane - kN) & 3);
      const double aqq = __shfl_sync(kFull, my_aqq, (lane - kN) & 3);
      const double apq = __shfl_sync(kFull, my_apq, (lane - kN) & 3);
      __syncwarp();
      if (lane < kN) {                           // row `lane` of the columns
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const int p = pr[i], q = pr[kPairs + i];
          const double g = A(lane, p), h = A(lane, q);
          A(lane, p) = c[i] * g - s[i] * h;
          A(lane, q) = s[i] * g + c[i] * h;
        }
      }
      __syncwarp();
      if (lane < kN) {                           // column `lane` of the rows
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const int p = pr[i], q = pr[kPairs + i];
          const double g = A(p, lane), h = A(q, lane);
          A(p, lane) = c[i] * g - s[i] * h;
          A(q, lane) = s[i] * g + c[i] * h;
        }
      }
      __syncwarp();
      if (lane < kN) {                           // row `lane` of V
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const int p = pr[i], q = pr[kPairs + i];
          const double g = V(lane, p), h = V(lane, q);
          V(lane, p) = c[i] * g - s[i] * h;
          V(lane, q) = s[i] * g + c[i] * h;
        }
      } else if (lane < kN + kPairs) {           // pair lane - 9's block
        const int i = lane - kN;
        const int p = pr[i], q = pr[kPairs + i];
        A(p, p) = app - t * apq;
        A(q, q) = aqq + t * apq;
        A(p, q) = 0.0;
        A(q, p) = 0.0;
      }
      __syncwarp();
    }
  }
  int best = 0;
  for (int j = 1; j < kN; ++j)
    if (A(j, j) < A(best, best)) best = j;
  if (lane < kN) {
    vec[static_cast<size_t>(m) * kN + lane] =
        static_cast<float>(V(lane, best));
  }
#undef A
#undef V
}

}  // namespace

extern "C" int eff_jacobi_eigh9(const float* ata, int n,
                                const int64_t* schedule, int sweeps,
                                float* vec, void* stream) {
  if (n < 1 || sweeps < 0) return cudaErrorInvalidValue;
  jacobi9_kernel<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(ata, n, schedule,
                                                        sweeps, vec);
  return cudaGetLastError();
}
