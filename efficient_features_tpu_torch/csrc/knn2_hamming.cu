// K6: streaming best-2 Hamming search with validity masks.
//
// Replaces the TPU kernel `_knn2_kernel`
// (efficient_features_tpu/ops/matcher.py:144, launched by `_fused_topk2`
// :183).  For each query row it finds the lowest-index nearest train row,
// its distance and the second-smallest distance.  A pair with an invalid
// side (mask 0) has distance 1 << 30, the JAX dense path's sentinel; with a
// single train row the second distance stays INT32_MAX.  Integer math
// throughout, so it is bit-exact with the plain version
// (ops/matcher.knn2_topk2_ref).
//
// The TPU kernel works in dot space: a +-1 bf16 GEMM per (query block,
// train block) grid step, a running best-2 in the revisited output block,
// merged across the sequential train axis.  Here the distance is
// popc(q ^ t) summed over the words, and the sequential train axis becomes a
// loop inside one block, so there is no cross-block merge.
//
// What bounds it on the H100, at 40000 x 40000 per direction: the work is
// n1 * n2 * nbits bit comparisons; the descriptor bytes (2.6 MB at 512
// bits) are negligible, so it is compute-bound.  On the int8 tensor cores
// (2 * n1 * n2 * nbits ops at 1979 TOP/s) that is 0.41 ms at 256 bits and
// 0.83 ms at 512.  This design runs on the CUDA cores instead: n1 * n2 *
// nbits / 32 `popc` at 16 per SM per clock (cc 9.0) is about 3 ms at 256
// bits on 132 SMs, which is what it can reach.
//
// Design: one thread per query row, which it holds in registers (8 or 16
// words).  A block of 128 threads stages train tiles of 256 rows and their
// validity in shared memory with coalesced 16-byte loads; every thread then
// reads the same row at the same time (a broadcast, no bank conflicts) and
// scans the tile in ascending j with
//   d < best        -> second = best, best = d, idx = j
//   else d < second -> second = d
// from best = second = INT32_MAX.  The ascending scan with strict compares
// gives the lowest index on ties, and second == best on a duplicate, as
// argmin and top_k do.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"

namespace {

constexpr int kThreads = 128;          // query rows per block
constexpr int kTile = 256;             // train rows per shared-memory tile
constexpr int kBig = 1 << 30;          // distance of a masked pair
constexpr int kInt32Max = 0x7fffffff;

// W: 32-bit words per descriptor, 8 (256 bits) or 16 (512 bits).
template <int W>
__global__ void __launch_bounds__(kThreads)
knn2_kernel(const uint4* __restrict__ q, const uint8_t* __restrict__ valid_q,
            int n1, const uint4* __restrict__ t,
            const uint8_t* __restrict__ valid_t, int n2,
            int32_t* __restrict__ out_idx, int32_t* __restrict__ out_best,
            int32_t* __restrict__ out_second) {
  constexpr int V = W / 4;             // 16-byte words per descriptor
  __shared__ uint4 s_t[kTile * V];
  __shared__ uint8_t s_v[kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n1;
  uint32_t qw[W];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const uint4 x = live ? q[static_cast<size_t>(i) * V + k]
                         : make_uint4(0u, 0u, 0u, 0u);
    qw[4 * k] = x.x;
    qw[4 * k + 1] = x.y;
    qw[4 * k + 2] = x.z;
    qw[4 * k + 3] = x.w;
  }
  const bool qvalid = live && (valid_q == nullptr || valid_q[i] != 0);

  int best = kInt32Max, second = kInt32Max, idx = 0;
  for (int base = 0; base < n2; base += kTile) {
    const int rows = min(kTile, n2 - base);
    __syncthreads();                   // the previous tile is consumed
    const uint4* src = t + static_cast<size_t>(base) * V;
    for (int e = threadIdx.x; e < rows * V; e += kThreads) s_t[e] = src[e];
    for (int r = threadIdx.x; r < rows; r += kThreads)
      s_v[r] = valid_t == nullptr ? 1 : valid_t[base + r];
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      int d = 0;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const uint4 tv = s_t[r * V + k];
        d += __popc(qw[4 * k] ^ tv.x) + __popc(qw[4 * k + 1] ^ tv.y) +
             __popc(qw[4 * k + 2] ^ tv.z) + __popc(qw[4 * k + 3] ^ tv.w);
      }
      if (!qvalid || s_v[r] == 0) d = kBig;
      const bool lt1 = d < best;
      const bool lt2 = d < second;
      second = lt1 ? best : (lt2 ? d : second);
      best = lt1 ? d : best;
      idx = lt1 ? base + r : idx;
    }
  }
  if (live) {
    out_idx[i] = idx;
    out_best[i] = best;
    out_second[i] = second;
  }
}

template <int W>
int launch(const uint8_t* q, const uint8_t* valid_q, int n1,
           const uint8_t* t, const uint8_t* valid_t, int n2,
           int32_t* best_idx, int32_t* best, int32_t* second,
           cudaStream_t stream) {
  const int blocks = (n1 + kThreads - 1) / kThreads;
  knn2_kernel<W><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(q), valid_q, n1,
      reinterpret_cast<const uint4*>(t), valid_t, n2, best_idx, best,
      second);
  return cudaGetLastError();
}

}  // namespace

extern "C" int eff_knn2_hamming(const uint8_t* q, const uint8_t* valid_q,
                                int n1, const uint8_t* t,
                                const uint8_t* valid_t, int n2, int nbytes,
                                int32_t* best_idx, int32_t* best,
                                int32_t* second, void* stream) {
  if (n1 < 1 || n2 < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbytes == 32)
    return launch<8>(q, valid_q, n1, t, valid_t, n2, best_idx, best, second,
                     s);
  if (nbytes == 64)
    return launch<16>(q, valid_q, n1, t, valid_t, n2, best_idx, best, second,
                      s);
  return cudaErrorInvalidValue;
}
