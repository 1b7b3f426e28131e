// K6: streaming best-2 Hamming search with validity masks, on the tensor
// cores.
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
// The TPU kernel forms a +-1 matrix product per (query block, train block)
// on the matrix unit and keeps a running best-2 in the revisited output
// block.  Here the product is Hopper's 1-bit warpgroup MMA on the packed
// descriptors as they are:
//   wgmma.mma_async m64n128k256 .s32.b1.b1.and.popc
// gives acc = popc(q & t) for 64 query rows x 128 train rows and one whole
// 256-bit descriptor per instruction (two instructions at 512 bits), exact
// in int32, and hamming = popc(q) + popc(t) - 2 * acc.  The other exact
// form, an int8 product of the bits unpacked to a byte each
// (m64n128k32.s32.s8.s8), was measured as a product alone and not built
// out: on an NVIDIA H100 80GB HBM3 at 700 W, 40000 x 40000, 256 / 512 bits,
// the int8 product takes 0.45 / 0.94 ms, the 1-bit product 0.062 / 0.116
// ms, and this kernel whole 0.45 / 0.55 ms.
//
// What bounds it on the H100, at 40000 x 40000 per direction: the operand
// bytes (2.6 MB at 512 bits) are nothing, and the 1-bit product alone takes
// 0.062 / 0.116 ms, 0.83 / 0.89 of 8 x the card's stated int8 rate.  What is
// left is the fold of 1.6e9 distances into a best-2 per row on the CUDA
// cores, which no exact search can do in less than one min per distance
// (0.096 ms at 64 int32 min/max per clock and SM); chip_smoke.py's bound is
// the larger of that and the 1-bit product.  The fold here is kept to one
// multiply-add and about two and a half min/max per distance, 0.39 ms of
// the launch:
//   key = acc * -(2 << 16) + c[j],  c[j] = (popc(t_j) << 16) + column
// orders train rows of one query by (distance, column), so `min` alone
// yields the lowest index on a tie, and
//   second = min(second, max(best, lo), hi);  best = min(best, lo)
// folds two keys (lo <= hi) at a time; popc(q) is added at the end.  An
// invalid train row has c[j] = (1 << 14 << 16) + column, above every valid
// key, and a padding column INT32_MAX: the three classes are told apart by
// the key's high half when a partial result is stored.
//
// Design: a 256-thread block (two warpgroups) owns 128 query rows, kept in
// shared memory, and one split of the train axis, walked in tiles of 128
// rows through two shared-memory stages fed by cp.async (16-byte chunks
// placed in the MMA's no-swizzle core-matrix layout: 8 rows x 16 bytes
// contiguous, the next 16 bytes of K 128 bytes on, the next 8 rows 256 bytes
// on).  Each warpgroup starts its product, waits for it and folds the
// 64 x 128 accumulator in registers while the other warpgroups of the SM
// run theirs; the distance matrix never reaches shared or device memory.
// The grid is (query strips, train splits), the wrapper choosing the split
// so that about 2000 blocks fill the 132 SMs whatever the shape; a split
// holds fewer than 65536 columns, which is what the 16-bit column field
// takes.  Three launches per call: `knn2_prep_kernel` (popcounts, c[j]),
// `knn2_mma_kernel` (a partial best-2 per row and split), and
// `knn2_merge_kernel`, which merges the splits in ascending order under
// (distance, index) and applies the query mask; no atomics, no floats, so
// two runs give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"
#include "wgmma_m64n128.cuh"

namespace {

constexpr int kStrip = 128;            // query rows per block
constexpr int kTileN = 128;            // train rows per tile (the MMA's N)
constexpr int kThreads = 256;          // two warpgroups of 64 query rows
static_assert(kStrip == kTileN, "load_rows copies either kind of tile");
constexpr int kPlane = kStrip * 32;    // bytes of 128 rows x 256 bits
constexpr int kLbo = kWgmmaLbo, kSbo = kWgmmaSbo;
constexpr int kBig = 1 << 30;          // distance of a masked pair
constexpr int kInt32Max = 0x7fffffff;
constexpr int kKeyScale = -(2 << 16);  // acc -> key
constexpr int kInvalidBias = 1 << 14;  // high half of an invalid column
constexpr int kInvalidFrom = 1 << 13;  // high half >= this: invalid column
constexpr int kNoneFrom = 3 << 13;     // high half >= this: padding column

// Byte offset of 16-byte chunk `c` (0 or 1) of `row` in a 256-bit plane.
__device__ __forceinline__ int core_offset(int row, int c) {
  return (row >> 3) * kSbo + c * kLbo + (row & 7) * 16;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// d (+)= popc(A & B): A 64 x 256 bits, B 128 x 256 bits.
EFF_WGMMA_M64N128(wgmma_b1,
                  "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc")

// Fold two keys into a running (best, second) of distinct keys.
__device__ __forceinline__ void fold2(int& best, int& second, int k0, int k1) {
  const int lo = min(k0, k1), hi = max(k0, k1);
  second = min(min(second, max(best, lo)), hi);
  best = min(best, lo);
}

// Union of two (best, second) pairs.
__device__ __forceinline__ void merge2(int& best, int& second, int ob,
                                       int os) {
  second = min(max(best, ob), min(second, os));
  best = min(best, ob);
}

template <int W>
__device__ __forceinline__ int popc_row(const uint4* row) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const uint4 x = row[k];
    n += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
  }
  return n;
}

// pq[i] = popc(q_i); ct[j] = the key constant of train column j (see the
// header), for j < n2_pad (a multiple of kTileN).
template <int W>
__global__ void knn2_prep_kernel(const uint4* __restrict__ q, int n1,
                                 const uint4* __restrict__ t,
                                 const uint8_t* __restrict__ valid_t, int n2,
                                 int n2_pad, int split_len,
                                 int32_t* __restrict__ pq,
                                 int32_t* __restrict__ ct) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n1) pq[i] = popc_row<W>(q + static_cast<size_t>(i) * (W / 4));
  if (i < n2_pad) {
    int c = kInt32Max;
    if (i < n2) {
      const bool valid = valid_t == nullptr || valid_t[i] != 0;
      const int high =
          valid ? popc_row<W>(t + static_cast<size_t>(i) * (W / 4))
                : kInvalidBias;
      c = (high << 16) + i % split_len;
    }
    ct[i] = c;
  }
}

// Store one row's partial result of one split: distances in their final
// form (1 << 30 for an invalid column, INT32_MAX for none), global index.
__device__ __forceinline__ void store_partial(int best_key, int second_key,
                                              int popq, int col0, size_t o,
                                              size_t stride,
                                              int32_t* __restrict__ part) {
  const int be = best_key >> 16, se = second_key >> 16;
  const bool bvalid = be < kInvalidFrom;
  part[o] = bvalid ? popq + be : kBig;
  part[o + stride] = bvalid ? col0 + (best_key & 0xffff) : 0;
  part[o + 2 * stride] = se >= kNoneFrom ? kInt32Max
                         : se >= kInvalidFrom ? kBig : popq + se;
}

// W: 32-bit words per descriptor, 8 (256 bits) or 16 (512 bits).
// part: (3, splits, n1) int32: best distance, best index, second distance.
template <int W>
__global__ void __launch_bounds__(kThreads, 2)
knn2_mma_kernel(const uint4* __restrict__ q, int n1,
                const uint4* __restrict__ t, int n2, int split_len,
                const int32_t* __restrict__ pq, const int32_t* __restrict__ ct,
                int32_t* __restrict__ part) {
  constexpr int KB = W / 8;            // 256-bit K blocks per descriptor
  constexpr int V = W / 4;             // 16-byte chunks per descriptor
  __shared__ __align__(128) unsigned char s_q[KB * kPlane];
  __shared__ __align__(128) unsigned char s_t[2][KB * kPlane];
  __shared__ __align__(16) int32_t s_ct[2][kTileN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kStrip;
  const int col0 = blockIdx.y * split_len;
  const int col_end = min(n2, col0 + split_len);
  const int tiles = (col_end - col0 + kTileN - 1) / kTileN;

  // rows past the end re-read the last row: in bounds, and never stored
  // (queries) or keyed INT32_MAX (train)
  auto load_rows = [&](unsigned char* dst, const uint4* src, int first,
                       int last_row) {
    for (int e = tid; e < kStrip * V; e += kThreads) {
      const int row = e / V, cc = e % V;
      const int g = min(first + row, last_row);
      cp_async16(dst + (cc >> 1) * kPlane + core_offset(row, cc & 1),
                 src + static_cast<size_t>(g) * V + cc);
    }
  };
  auto load_tile = [&](int tile) {
    const int base = col0 + tile * kTileN;
    load_rows(s_t[tile & 1], t, base, n2 - 1);
    if (tid < kTileN / 4)
      cp_async16(&s_ct[tile & 1][4 * tid], ct + base + 4 * tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  load_rows(s_q, q, row0, n1 - 1);
  load_tile(0);

  const int wg = tid >> 7, lane = tid & 31;
  uint64_t desc_q[KB];
#pragma unroll
  for (int kb = 0; kb < KB; ++kb)
    desc_q[kb] = mma_desc(s_q + kb * kPlane + wg * (64 / 8) * kSbo);

  int acc[64];
  int best0 = kInt32Max, second0 = kInt32Max;    // row lane / 4 of the warp
  int best1 = kInt32Max, second1 = kInt32Max;    // row lane / 4 + 8
  for (int tile = 0; tile < tiles; ++tile) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // the copies were made by ordinary (generic-proxy) writes; the MMA reads
    // shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();     // tile is in; every warpgroup is done with tile - 1
    if (tile + 1 < tiles) load_tile(tile + 1);

    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
      wgmma_b1(acc, desc_q[kb], mma_desc(s_t[tile & 1] + kb * kPlane), kb);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[i]) :: "memory");

    // accumulator fragment: acc[4i + {0, 1}] are columns 8i + 2 (lane % 4)
    // + {0, 1} of row lane / 4, acc[4i + {2, 3}] the same of row lane / 4 + 8
    const int2* cv =
        reinterpret_cast<const int2*>(s_ct[tile & 1]) + (lane & 3);
#pragma unroll
    for (int i = 0; i < kTileN / 8; ++i) {
      const int2 c = cv[4 * i];
      fold2(best0, second0, acc[4 * i] * kKeyScale + c.x,
            acc[4 * i + 1] * kKeyScale + c.y);
      fold2(best1, second1, acc[4 * i + 2] * kKeyScale + c.x,
            acc[4 * i + 3] * kKeyScale + c.y);
    }
  }

  // the four lanes of a quad hold disjoint columns of the same two rows
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const int ob0 = __shfl_xor_sync(0xffffffffu, best0, m);
    const int os0 = __shfl_xor_sync(0xffffffffu, second0, m);
    const int ob1 = __shfl_xor_sync(0xffffffffu, best1, m);
    const int os1 = __shfl_xor_sync(0xffffffffu, second1, m);
    merge2(best0, second0, ob0, os0);
    merge2(best1, second1, ob1, os1);
  }
  if ((lane & 3) == 0) {
    const int r = row0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const size_t stride = static_cast<size_t>(gridDim.y) * n1;
    const size_t o = static_cast<size_t>(blockIdx.y) * n1;
    if (r < n1)
      store_partial(best0, second0, pq[r], col0, o + r, stride, part);
    if (r + 8 < n1)
      store_partial(best1, second1, pq[r + 8], col0, o + r + 8, stride, part);
  }
}

// Merge the splits of each query row in ascending order: a strictly smaller
// distance wins, so ties stay with the lower split and its lowest index;
// `second` is the second smallest of the union.  Then the query mask.
__global__ void knn2_merge_kernel(const int32_t* __restrict__ part,
                                  int splits, int n1,
                                  const uint8_t* __restrict__ valid_q, int n2,
                                  int32_t* __restrict__ out_idx,
                                  int32_t* __restrict__ out_best,
                                  int32_t* __restrict__ out_second) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n1) return;
  const size_t stride = static_cast<size_t>(splits) * n1;
  int best = kInt32Max, second = kInt32Max, idx = 0;
  for (int s = 0; s < splits; ++s) {
    const size_t o = static_cast<size_t>(s) * n1 + i;
    const int d = part[o], j = part[o + stride], d2 = part[o + 2 * stride];
    if (d < best) {
      second = min(best, d2);
      best = d;
      idx = j;
    } else {
      second = min(second, d);
    }
  }
  if (valid_q != nullptr && valid_q[i] == 0) {
    best = kBig;
    second = n2 >= 2 ? kBig : kInt32Max;
  }
  out_idx[i] = best == kBig ? 0 : idx;
  out_best[i] = best;
  out_second[i] = second;
}

template <int W>
int launch(const uint8_t* q, const uint8_t* valid_q, int n1, const uint8_t* t,
           const uint8_t* valid_t, int n2, int split_len, int32_t* scratch,
           int32_t* best_idx, int32_t* best, int32_t* second,
           cudaStream_t stream) {
  const int n2_pad = (n2 + kTileN - 1) / kTileN * kTileN;
  const int splits = (n2 + split_len - 1) / split_len;
  int32_t* ct = scratch;
  int32_t* pq = ct + n2_pad;
  int32_t* part = pq + (n1 + 3) / 4 * 4;
  const uint4* q4 = reinterpret_cast<const uint4*>(q);
  const uint4* t4 = reinterpret_cast<const uint4*>(t);
  const int rows = n1 > n2_pad ? n1 : n2_pad;
  knn2_prep_kernel<W><<<(rows + 255) / 256, 256, 0, stream>>>(
      q4, n1, t4, valid_t, n2, n2_pad, split_len, pq, ct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((n1 + kStrip - 1) / kStrip, splits);
  knn2_mma_kernel<W><<<grid, kThreads, 0, stream>>>(q4, n1, t4, n2, split_len,
                                                    pq, ct, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn2_merge_kernel<<<(n1 + 255) / 256, 256, 0, stream>>>(
      part, splits, n1, valid_q, n2, best_idx, best, second);
  return cudaGetLastError();
}

}  // namespace

extern "C" int eff_knn2_hamming(const uint8_t* q, const uint8_t* valid_q,
                                int n1, const uint8_t* t,
                                const uint8_t* valid_t, int n2, int nbytes,
                                int split_len, int32_t* scratch,
                                int32_t* best_idx, int32_t* best,
                                int32_t* second, void* stream) {
  if (n1 < 1 || n2 < 1 || split_len < kTileN || split_len % kTileN != 0 ||
      split_len > (1 << 16) ||
      (n2 + split_len - 1) / split_len > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbytes == 32)
    return launch<8>(q, valid_q, n1, t, valid_t, n2, split_len, scratch,
                     best_idx, best, second, s);
  if (nbytes == 64)
    return launch<16>(q, valid_q, n1, t, valid_t, n2, split_len, scratch,
                      best_idx, best, second, s);
  return cudaErrorInvalidValue;
}
