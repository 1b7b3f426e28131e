// Byte-row helpers of the kernels that stage u8 rows in shared memory or
// store u8 rows by the word: K4 (warp_patches.cu) and K10 (resize_u8.cu)
// load aligned 16-byte chunks of image rows that start anywhere; K9
// (radius_nms.cu), K10 and K14 (blur7_u8.cu) store rows of a u8 output
// whose width is no multiple of 4.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The 16 bytes at `p` (16-byte aligned); bytes outside [lo, hi) are 0 and
// not read.
__device__ __forceinline__ uint4 load16(const uint8_t* p, const uint8_t* lo,
                                        const uint8_t* hi) {
  if (p >= lo && p + 16 <= hi)
    return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t b[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16; ++i)
    if (p + i >= lo && p + i < hi)
      b[i / 4] |= static_cast<uint32_t>(__ldg(p + i)) << (8 * (i % 4));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// Columns of a u8 output row as aligned 32-bit words: the row's word k
// covers columns first + 4k .. first + 4k + 3, first = -(misalignment of
// the row's start), which lies in -3 .. 0.
__device__ __forceinline__ int row_first_column(const uint8_t* row) {
  return -static_cast<int>(reinterpret_cast<uintptr_t>(row) & 3u);
}

// Store byte j of `word` at row[c + j] for the j with lo <= c + j < hi:
// one 32-bit store when all four qualify (row + c is then aligned, c being
// a word's first column), else byte by byte.
__device__ __forceinline__ void store_u8x4(uint8_t* row, int c, int lo,
                                           int hi, uint32_t word) {
  if (c >= lo && c + 4 <= hi) {
    *reinterpret_cast<uint32_t*>(row + c) = word;
    return;
  }
  for (int j = 0; j < 4; ++j)
    if (c + j >= lo && c + j < hi)
      row[c + j] = static_cast<uint8_t>(word >> (8 * j));
}

}  // namespace
