// K13: exact top-`quota` keypoint selection from K1's cells, with fixed
// shapes and no host read.
//
// No TPU kernel: the JAX package selects with XLA ops
// (efficient_features_tpu/ops/detect.py:select_topk_cells) and decides a
// tie case with `lax.cond`.  The plain version is the port's
// ops/detect.select_topk_cells (torch ops, bit for bit JAX's slots); on
// the card its ~90 small torch ops a level cost more host time than the
// rest of a detect_and_compute call, so K13 does the same steps in four
// kernels around two `torch.sort`s and one `torch.cumsum`
// (ops/detect_kernels.select_cells):
//   1. `block_keys_kernel`, a thread per 8x8 block: the key
//      (desc(value) << 32) + index of the block's winner, the minimum over
//      its 8 cells of (desc(canonical cellmax) << 32) + cellrow * w + x,
//      or (desc(-inf) << 32) + h * w for a block without survivors; desc()
//      maps float32 bits to an int32 that orders them descending.  The
//      wrapper sorts the keys (stable) and keeps the first
//      kq = min(quota, blocks).
//   2. `segments_kernel`, a thread per kept block: its 8 row segments, key
//      (the block key's high half) + the index of the segment's first
//      column, and byte (its row of the block's 8x8 survivor bits:
//      `cellbits` transposed).  The wrapper sorts the segment keys.
//   3. `counts_kernel`, a thread per segment in sorted order: its byte and
//      survivor count.  The wrapper takes the inclusive cumsum.
//   4. `place_kernel`, a thread per output slot j: the first segment whose
//      cumsum passes j (binary search), the matching set bit of its byte,
//      and the slot (y, x, response, valid); slots past the survivors hold
//      (0, 0, 0, false).
// Every value is an integer or float32 bits carried through unchanged, so
// the slots are bit-identical to the plain version's.
//
// What bounds it on the H100: launches and the two sorts; the kernels
// themselves read each cell once (9 bytes) and are short.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"

namespace {

constexpr int kThreads = 256;

// float32 bits -> int32 whose ascending order is the float's descending
// order (no NaN); -0.0 is canonicalised to +0.0 first
__device__ __forceinline__ int32_t desc32(float v) {
  if (v == 0.f) v = 0.f;
  const int32_t b = __float_as_int(v);
  const int32_t asc = b ^ ((b >> 31) & 0x7FFFFFFF);
  return ~asc;
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// the key's high half: desc << 32, without shifting a negative value
__device__ __forceinline__ int64_t high(int32_t desc) {
  return static_cast<int64_t>(desc) * (static_cast<int64_t>(1) << 32);
}

__device__ __forceinline__ float from_desc32(int32_t d) {
  const int32_t asc = ~d;
  return __int_as_float(asc ^ ((asc >> 31) & 0x7FFFFFFF));
}

__global__ void __launch_bounds__(kThreads)
block_keys_kernel(const float* __restrict__ cellmax,
                  const int32_t* __restrict__ cellrow, int h8, int w, int ld,
                  int w8, int64_t n, int64_t* __restrict__ keys) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= static_cast<int64_t>(h8) * w8) return;
  const int i = static_cast<int>(b / w8), bj = static_cast<int>(b % w8);
  int64_t best = high(desc32(neg_inf())) + n;
  for (int c = 0; c < 8; ++c) {
    const int x = bj * 8 + c;
    if (x >= w) break;
    const size_t o = static_cast<size_t>(i) * ld + x;
    const float v = cellmax[o];
    if (v == neg_inf()) continue;
    const int64_t key = high(desc32(v))
                        + static_cast<int64_t>(cellrow[o]) * w + x;
    best = key < best ? key : best;
  }
  keys[b] = best;
}

__global__ void __launch_bounds__(kThreads)
segments_kernel(const int64_t* __restrict__ sorted_keys,
                const int64_t* __restrict__ blocks, int kq,
                const uint8_t* __restrict__ cellbits, int w, int ld, int w8,
                int64_t* __restrict__ seg_keys,
                uint8_t* __restrict__ seg_bytes) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= kq) return;
  const int64_t b = blocks[t];
  const int i = static_cast<int>(b / w8), bj = static_cast<int>(b % w8);
  const int64_t hi = sorted_keys[t] & ~static_cast<int64_t>(0xFFFFFFFF);
  unsigned col[8];
  for (int c = 0; c < 8; ++c) {
    const int x = bj * 8 + c;
    col[c] = x < w ? cellbits[static_cast<size_t>(i) * ld + x] : 0u;
  }
  for (int k = 0; k < 8; ++k) {
    unsigned row = 0;
    for (int c = 0; c < 8; ++c) row |= ((col[c] >> k) & 1u) << c;
    const int64_t start = (static_cast<int64_t>(i) * 8 + k) * w + bj * 8;
    seg_keys[static_cast<size_t>(t) * 8 + k] = hi + start;
    seg_bytes[static_cast<size_t>(t) * 8 + k] = static_cast<uint8_t>(row);
  }
}

__global__ void __launch_bounds__(kThreads)
counts_kernel(const uint8_t* __restrict__ seg_bytes,
              const int64_t* __restrict__ order, int nseg,
              uint8_t* __restrict__ bytes_sorted,
              int32_t* __restrict__ counts) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= nseg) return;
  const uint8_t byte = seg_bytes[order[s]];
  bytes_sorted[s] = byte;
  counts[s] = __popc(byte);
}

__global__ void __launch_bounds__(kThreads)
place_kernel(const int64_t* __restrict__ seg_keys,
             const uint8_t* __restrict__ bytes_sorted,
             const int32_t* __restrict__ ends, int nseg, int quota, int w,
             int32_t* __restrict__ ys, int32_t* __restrict__ xs,
             float* __restrict__ resp, uint8_t* __restrict__ valid) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= quota) return;
  int lo = 0, hi = nseg;                   // first segment with end > j
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] > j) hi = mid; else lo = mid + 1;
  }
  if (lo >= nseg) {
    ys[j] = 0;
    xs[j] = 0;
    resp[j] = 0.f;
    valid[j] = 0;
    return;
  }
  int rank = j - (lo > 0 ? ends[lo - 1] : 0);
  const unsigned byte = bytes_sorted[lo];
  int col = 0;
  for (int c = 0; c < 8; ++c) {
    if ((byte >> c) & 1u) {
      if (rank == 0) { col = c; break; }
      --rank;
    }
  }
  const int64_t key = seg_keys[lo];
  const int32_t idx = static_cast<int32_t>(key & 0xFFFFFFFF) + col;
  ys[j] = idx / w;
  xs[j] = idx % w;
  resp[j] = from_desc32(static_cast<int32_t>(
      static_cast<uint64_t>(key) >> 32));
  valid[j] = 1;
}

int blocks_for(int64_t n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int eff_cells_block_keys(const float* cellmax,
                                    const int32_t* cellrow, int h, int w,
                                    int ld, int64_t* keys, void* stream) {
  if (h < 1 || w < 1 || ld < w) return cudaErrorInvalidValue;
  const int h8 = (h + 7) / 8, w8 = (w + 7) / 8;
  block_keys_kernel<<<blocks_for(static_cast<int64_t>(h8) * w8), kThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(
      cellmax, cellrow, h8, w, ld, w8, static_cast<int64_t>(h) * w, keys);
  return cudaGetLastError();
}

extern "C" int eff_cells_segments(const int64_t* sorted_keys,
                                  const int64_t* blocks, int kq,
                                  const uint8_t* cellbits, int w, int ld,
                                  int64_t* seg_keys, uint8_t* seg_bytes,
                                  void* stream) {
  if (kq < 1 || w < 1 || ld < w) return cudaErrorInvalidValue;
  segments_kernel<<<blocks_for(kq), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      sorted_keys, blocks, kq, cellbits, w, ld, (w + 7) / 8, seg_keys,
      seg_bytes);
  return cudaGetLastError();
}

extern "C" int eff_cells_counts(const uint8_t* seg_bytes,
                                const int64_t* order, int nseg,
                                uint8_t* bytes_sorted, int32_t* counts,
                                void* stream) {
  if (nseg < 1) return cudaErrorInvalidValue;
  counts_kernel<<<blocks_for(nseg), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(seg_bytes, order, nseg,
                                                       bytes_sorted, counts);
  return cudaGetLastError();
}

extern "C" int eff_cells_place(const int64_t* seg_keys,
                               const uint8_t* bytes_sorted,
                               const int32_t* ends, int nseg, int quota,
                               int w, int32_t* ys, int32_t* xs, float* resp,
                               uint8_t* valid, void* stream) {
  if (nseg < 1 || quota < 1 || w < 1) return cudaErrorInvalidValue;
  place_kernel<<<blocks_for(quota), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      seg_keys, bytes_sorted, ends, nseg, quota, w, ys, xs, resp, valid);
  return cudaGetLastError();
}
