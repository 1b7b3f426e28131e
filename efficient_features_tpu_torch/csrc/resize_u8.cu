// K10: bilinear u8 resize in 11-bit fixed point, (sh, sw) -> (h, w).
//
// Replaces the TPU kernel `_resize_kernel`
// (efficient_features_tpu/ops/image.py:115, launched by `resize_u8_pallas`
// :173).  dst[y, x] = (sum over the 2x2 support of wy * wx * src + 2^21)
// >> 22, with the per-axis source indices and weights (i0, i1, w1; the
// weight of i0 is 2048 - w1) of `semantics.resize_axis_coeffs`.  Those come
// from float64 host math and are passed in as int32 tables, never recomputed
// here.  The arithmetic is `ops/image.resize_u8`'s, in int32: the two
// horizontal products first, then the vertical combination, one rounding at
// the end (the horizontal pass is not rounded).  The largest accumulator is
// 255 * 2048 * 2048 + 2^21 < 2^31.
//
// The TPU kernel is a banded int8 matrix product with the weights split in
// 6-bit limbs and the horizontal pass in 7-bit limbs, because its matrix
// unit is int8; none of that is carried over.
//
// What bounds it on the H100: bytes.  Every source pixel is read and every
// destination pixel written once (about 25 MB read and 17 MB written for
// the 7 levels under a 2160x3840 frame); each pixel costs 6 multiplies.
// The plain version moves an (sh, w) int32 intermediate and several (h, w)
// int32 temporaries through device memory instead.
//
// Design: one thread per 4 consecutive pixels of the row-major destination,
// stored as one aligned 32-bit word.  The groups run over the flattened
// image, not over a row, so the store is aligned for any width (most
// pyramid widths are no multiple of 4); a group that crosses a row end goes
// on in the next row.  The last group of an image whose size is no multiple
// of 4 stores single bytes.  Source pixels and tables are read through the
// read-only cache: neighbouring threads read neighbouring pixels of the same
// two source rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kBits = 11;             // semantics.RESIZE_BITS
constexpr int kOne = 1 << kBits;

__global__ void __launch_bounds__(kThreads)
resize_kernel(const uint8_t* __restrict__ src, int sw,
              const int32_t* __restrict__ y0, const int32_t* __restrict__ y1,
              const int32_t* __restrict__ wy1,
              const int32_t* __restrict__ x0, const int32_t* __restrict__ x1,
              const int32_t* __restrict__ wx1, uint8_t* __restrict__ dst,
              int w, int n_pixels) {
  const int first = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (first >= n_pixels) return;
  int y = first / w, x = first % w;
  uint32_t word = 0;
  const int count = min(4, n_pixels - first);
  for (int j = 0; j < count; ++j) {
    const uint8_t* r0 = src + static_cast<size_t>(__ldg(y0 + y)) * sw;
    const uint8_t* r1 = src + static_cast<size_t>(__ldg(y1 + y)) * sw;
    const int32_t wy = __ldg(wy1 + y);
    const int32_t a0 = __ldg(x0 + x), a1 = __ldg(x1 + x);
    const int32_t wx = __ldg(wx1 + x);
    const int32_t top = static_cast<int32_t>(__ldg(r0 + a0)) * (kOne - wx)
                        + static_cast<int32_t>(__ldg(r0 + a1)) * wx;
    const int32_t bot = static_cast<int32_t>(__ldg(r1 + a0)) * (kOne - wx)
                        + static_cast<int32_t>(__ldg(r1 + a1)) * wx;
    const int32_t acc = top * (kOne - wy) + bot * wy;
    const uint32_t v = static_cast<uint32_t>(
        (acc + (1 << (2 * kBits - 1))) >> (2 * kBits));
    word |= v << (8 * j);
    if (++x == w) {
      x = 0;
      ++y;
    }
  }
  if (count == 4) {
    reinterpret_cast<uint32_t*>(dst)[first / 4] = word;
  } else {
    for (int j = 0; j < count; ++j)
      dst[first + j] = static_cast<uint8_t>(word >> (8 * j));
  }
}

}  // namespace

extern "C" int eff_resize_u8(const uint8_t* src, int sh, int sw,
                             const int32_t* y0, const int32_t* y1,
                             const int32_t* wy1, const int32_t* x0,
                             const int32_t* x1, const int32_t* wx1,
                             uint8_t* dst, int h, int w, void* stream) {
  if (sh < 1 || sw < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  // the kernel indexes pixels with int32
  if (static_cast<long long>(h) * w > 0x7fffffffLL - 4 * kThreads)
    return cudaErrorInvalidValue;
  const int n_pixels = h * w;
  const int groups = (n_pixels + 3) / 4;
  resize_kernel<<<(groups + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      src, sw, y0, y1, wy1, x0, x1, wx1, dst, w, n_pixels);
  return cudaGetLastError();
}
