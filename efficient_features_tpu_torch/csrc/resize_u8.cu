// K10: bilinear u8 resize in 11-bit fixed point, (sh, sw) -> (h, w).
//
// Replaces the TPU kernel `_resize_kernel`
// (efficient_features_tpu/ops/image.py:115, launched by `resize_u8_pallas`
// :173).  dst[y, x] = (sum over the 2x2 support of wy * wx * src + 2^21)
// >> 22, with the per-axis source indices and weights (i0, i1, w1; the
// weight of i0 is 2048 - w1) of `semantics.resize_axis_coeffs`.  Those come
// from float64 host math and are passed in as tables, never recomputed
// here; the host packs each entry into one 32-bit word, i0 | (i1 - i0) <<
// 19 | w1 << 20 (`ops/image.resize_table`; i1 - i0 is 0 or 1, so a source
// side may have up to 2^19 pixels).  The arithmetic is `ops/image.
// resize_u8`'s, in int32: the two horizontal products first, then the
// vertical combination, one rounding at the end (the horizontal pass is not
// rounded).  The largest accumulator is 255 * 2048 * 2048 + 2^21 < 2^31.
//
// The TPU kernel is a banded int8 matrix product with the weights split in
// 6-bit limbs and the horizontal pass in 7-bit limbs, because its matrix
// unit is int8; none of that is carried over.  What it does keep is reuse:
// each source tile is loaded once into VMEM for a whole destination tile.
//
// What bounds it on the H100: bytes.  Every source pixel is read and every
// destination pixel written once (about 25 MB read and 17 MB written for
// the 7 levels under a 2160x3840 frame); each pixel costs 6 multiplies.
// The pyramid's 7 launches run one after the other (level s is made from
// level s - 1), so the small levels also pay each launch's ramp and tail.
//
// Design: a 256-thread block per tile of kTileH destination rows x
// kTileW destination columns; a thread forms 4 consecutive bytes of a row
// and stores them as one aligned word, in 2 rows of the tile.
//   - Columns.  Most pyramid widths are no multiple of 4, so the rows of
//     the destination start at any byte.  Each row is cut into aligned
//     words from its own first column -3 .. 0 (`row_first_column`), and
//     tile tx takes that row's words tx * 64 .. tx * 64 + 63; the bytes of
//     a word that lie outside the row (a neighbour row's) are not stored.
//     So a tile's columns shift by up to 3 from row to row, and the grid
//     has ceil((w + 3) / kTileW) column tiles.
//   - Tables.  The tile's x entries (columns c_lo = tx * kTileW - 3 ..
//     c_hi = tx * kTileW + kTileW, clipped to the image) and its rows' y
//     entries are read once per block into shared memory, beside the
//     source rows; a thread unpacks its 4 columns' x taps once for both
//     its rows, which start at the same byte of a word.  So a thread waits
//     on device memory twice: for the tile's first and last table entries
//     (its plan), then for the staged data.
//   - Source rows.  The source rows y0[first row] .. y1[last row] over the
//     columns x0[c_lo] .. x1[c_hi - 1] are copied once into shared memory
//     with one aligned 16-byte load per thread and chunk, each row's chunks
//     as they lie in the image (row r at byte r * stride + off(r), off(r)
//     the row's offset from its first aligned chunk, as K4 stages its
//     window).  About 12 rows x 336 B at scale 1.2: each source row is read
//     from device memory once per tile (1.5 times in all, the rows shared
//     by two tiles twice), not once per destination row.
//   - Any ratio in the same kernel.  A tile whose staged rows would exceed
//     kStageBytes (a large downscale) reads the image directly.
//     `ops/image.resize_plan` mirrors the rule; the kernel decides per tile
//     from the tables, with no host sync.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"
#include "u8_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 8;                       // ops/image.RESIZE_TILE_H
constexpr int kTileW = 256;                     // ops/image.RESIZE_TILE_W
constexpr int kRowWords = kTileW / 4;
constexpr int kRowsPerPass = kThreads / kRowWords;
constexpr int kStageBytes = 12288;              // ops/image.RESIZE_STAGE_BYTES
constexpr int kBits = 11;                       // semantics.RESIZE_BITS
constexpr int kOne = 1 << kBits;
constexpr int kIndexBits = 19;                  // ops/image.RESIZE_INDEX_BITS
constexpr uint32_t kIndexMask = (1u << kIndexBits) - 1u;

struct Tap {
  int i0, i1, w1;
};

__device__ __forceinline__ Tap unpack(uint32_t e) {
  const int i0 = static_cast<int>(e & kIndexMask);
  return {i0, i0 + static_cast<int>((e >> kIndexBits) & 1u),
          static_cast<int>(e >> (kIndexBits + 1))};
}

// What one tile reads: source rows y0 .. y0 + rows - 1 and columns x0 ..
// x0 + span - 1, staged at `stride` bytes a row when they fit.
struct Plan {
  int c_lo, c_hi, y0, x0, rows, span, stride;
  bool staged;
};

__device__ __forceinline__ Plan tile_plan(const uint32_t* __restrict__ ytab,
                                          const uint32_t* __restrict__ xtab,
                                          int h, int w, int r0, int tx) {
  Plan p;
  p.c_lo = max(tx * kTileW - 3, 0);
  p.c_hi = min(tx * kTileW + kTileW, w);
  p.y0 = unpack(__ldg(ytab + r0)).i0;
  p.rows = unpack(__ldg(ytab + min(r0 + kTileH, h) - 1)).i1 - p.y0 + 1;
  p.x0 = unpack(__ldg(xtab + p.c_lo)).i0;
  p.span = unpack(__ldg(xtab + p.c_hi - 1)).i1 - p.x0 + 1;
  p.stride = 16 * ((p.span + 30) / 16);   // a row's chunks, at most
  p.staged = p.rows <= kStageBytes / 16 && p.rows * p.stride <= kStageBytes;
  return p;
}

// One destination byte from its 2x2 support: q00, q01 in the first source
// row, q10, q11 in the second.
__device__ __forceinline__ uint32_t bilinear_byte(int q00, int q01, int q10,
                                                  int q11, int wx, int wy) {
  const int top = q00 * (kOne - wx) + q01 * wx;
  const int bot = q10 * (kOne - wx) + q11 * wx;
  const int acc = top * (kOne - wy) + bot * wy;
  return static_cast<uint32_t>((acc + (1 << (2 * kBits - 1))) >> (2 * kBits));
}

// A thread's columns: its word of row y0 at tile tx.  Rows kRowsPerPass
// apart start at the same byte of a word (kRowsPerPass * w is a multiple of
// 4), so the thread's rows share it.
static_assert(kRowsPerPass % 4 == 0, "a thread's rows must share columns");
constexpr int kRowsPerThread = kTileH / kRowsPerPass;

__device__ __forceinline__ int thread_column(const uint8_t* dst, int w,
                                             int y0, int tx) {
  return row_first_column(dst + static_cast<size_t>(y0) * w) + tx * kTileW
         + 4 * (threadIdx.x % kRowWords);
}

// The tile's rows from its staged source rows.  The thread's x taps are
// unpacked once for its rows, which are unrolled so that their shared
// memory reads are in flight together.  A column outside the row reads the
// staged rows' first byte; its result is not stored.
__device__ __forceinline__ void staged_rows(
    const uint8_t* s_src, const Plan& p, uint32_t a0, int sw,
    const uint32_t* s_x, const uint32_t* s_y, uint8_t* __restrict__ dst,
    int h, int w, int r0, int tx) {
  const int r1 = min(r0 + kTileH, h);
  const int y0 = r0 + threadIdx.x / kRowWords;
  if (y0 >= r1) return;
  const int c = thread_column(dst, w, y0, tx);
  int b0[4], b1[4], wx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool in = c + k >= 0 && c + k < w;
    const Tap t = in ? unpack(s_x[c + k - p.c_lo]) : Tap{p.x0, p.x0, 0};
    b0[k] = t.i0 - p.x0;
    b1[k] = t.i1 - p.x0;
    wx[k] = t.w1;
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int y = y0 + i * kRowsPerPass;
    if (y >= r1) break;
    const Tap ty = unpack(s_y[y - r0]);
    // source row r sits at r * stride + off(r), off(r) its offset from its
    // first aligned chunk
    const uint32_t j0 = ty.i0 - p.y0, j1 = ty.i1 - p.y0;
    const uint8_t* q0 = s_src + j0 * p.stride + ((a0 + j0 * sw) & 15u);
    const uint8_t* q1 = s_src + j1 * p.stride + ((a0 + j1 * sw) & 15u);
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      word |= bilinear_byte(q0[b0[k]], q0[b1[k]], q1[b0[k]], q1[b1[k]],
                            wx[k], ty.w1) << (8 * k);
    store_u8x4(dst + static_cast<size_t>(y) * w, c, 0, w, word);
  }
}

// The tile's rows from the image, for a tile whose source rows do not fit
// the stage (a large downscale).
__device__ __forceinline__ void direct_rows(
    const uint8_t* __restrict__ src, int sw, const Plan& p,
    const uint32_t* s_x, const uint32_t* s_y, uint8_t* __restrict__ dst,
    int h, int w, int r0, int tx) {
  const int r1 = min(r0 + kTileH, h);
  const int y0 = r0 + threadIdx.x / kRowWords;
  if (y0 >= r1) return;
  const int c = thread_column(dst, w, y0, tx);
  for (int y = y0; y < r1; y += kRowsPerPass) {
    const Tap ty = unpack(s_y[y - r0]);
    const uint8_t* q0 = src + static_cast<size_t>(ty.i0) * sw;
    const uint8_t* q1 = src + static_cast<size_t>(ty.i1) * sw;
    uint32_t word = 0;
    for (int k = 0; k < 4; ++k) {
      if (c + k < 0 || c + k >= w) continue;
      const Tap t = unpack(s_x[c + k - p.c_lo]);
      word |= bilinear_byte(__ldg(q0 + t.i0), __ldg(q0 + t.i1),
                            __ldg(q1 + t.i0), __ldg(q1 + t.i1), t.w1,
                            ty.w1) << (8 * k);
    }
    store_u8x4(dst + static_cast<size_t>(y) * w, c, 0, w, word);
  }
}

__global__ void __launch_bounds__(kThreads)
resize_kernel(const uint8_t* __restrict__ src, int sh, int sw,
              const uint32_t* __restrict__ ytab,
              const uint32_t* __restrict__ xtab, uint8_t* __restrict__ dst,
              int h, int w) {
  __shared__ __align__(16) uint8_t s_src[kStageBytes];
  __shared__ uint32_t s_x[kTileW + 3];
  __shared__ uint32_t s_y[kTileH];
  const int r0 = blockIdx.y * kTileH, tx = blockIdx.x;
  const Plan p = tile_plan(ytab, xtab, h, w, r0, tx);
  for (int i = threadIdx.x; i < p.c_hi - p.c_lo; i += kThreads)
    s_x[i] = __ldg(xtab + p.c_lo + i);
  if (threadIdx.x < min(kTileH, h - r0))
    s_y[threadIdx.x] = __ldg(ytab + r0 + threadIdx.x);
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(src)
                       + static_cast<size_t>(p.y0) * sw + p.x0;
  if (p.staged) {
    const int chunks = p.stride / 16;
    const uint8_t* hi = src + static_cast<size_t>(sh) * sw;
    for (int i = threadIdx.x; i < p.rows * chunks; i += kThreads) {
      const int r = i / chunks, q = i - r * chunks;
      const uintptr_t first = a0 + static_cast<size_t>(r) * sw;
      if (16 * q < static_cast<int>(first & 15u) + p.span)
        *reinterpret_cast<uint4*>(s_src + r * p.stride + 16 * q) = load16(
            reinterpret_cast<const uint8_t*>((first & ~uintptr_t{15})
                                             + 16 * q), src, hi);
    }
  }
  __syncthreads();
  if (p.staged) {
    staged_rows(s_src, p, static_cast<uint32_t>(a0), sw, s_x, s_y, dst, h, w,
                r0, tx);
  } else {
    direct_rows(src, sw, p, s_x, s_y, dst, h, w, r0, tx);
  }
}

}  // namespace

extern "C" int eff_resize_u8(const uint8_t* src, int sh, int sw,
                             const uint32_t* ytab, const uint32_t* xtab,
                             uint8_t* dst, int h, int w, void* stream) {
  if (sh < 1 || sw < 1 || h < 1 || w < 1 || sh > (1 << kIndexBits) ||
      sw > (1 << kIndexBits) || h > 65535 * kTileH)
    return cudaErrorInvalidValue;
  const dim3 grid((w + 3 + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  resize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, sh, sw, ytab, xtab, dst, h, w);
  return cudaGetLastError();
}
