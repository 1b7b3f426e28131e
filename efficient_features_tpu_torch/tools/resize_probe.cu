// Cuts of the first design of the pyramid resize K10 (csrc/resize_u8.cu)
// for tools/resize_probe.py, which builds this file into a library of its
// own.  All three run that design (PR 5): one thread per 4 consecutive
// pixels of the flattened destination, each pixel reading its six table
// entries and four source bytes from device memory.
//   0 flat: that design as it was, K10's bytes;
//   1 flat_no_pixel: the same grid and table loads with the pixel fetch
//     replaced by a constant;
//   2 flat_floor: the same grid with no load at all (each group stores a
//     function of its index): the launches' own floor.
// ty: (3, h) and tx: (3, w) int32 rows i0, i1, w1 (semantics.
// resize_axis_coeffs).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBits = 11;
constexpr int kOne = 1 << kBits;

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
resize_flat_kernel(const uint8_t* __restrict__ src, int sw,
                   const int32_t* __restrict__ ty,
                   const int32_t* __restrict__ tx, uint8_t* __restrict__ dst,
                   int h, int w, int n_pixels) {
  const int first = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (first >= n_pixels) return;
  int y = first / w, x = first % w;
  uint32_t word = 0;
  const int count = min(4, n_pixels - first);
  for (int j = 0; j < count; ++j) {
    uint32_t v;
    if (kVariant == 2) {
      v = static_cast<uint32_t>(y + x) & 0xffu;
    } else {
      const int32_t r0 = __ldg(ty + y), r1 = __ldg(ty + h + y);
      const int32_t wy = __ldg(ty + 2 * h + y);
      const int32_t a0 = __ldg(tx + x), a1 = __ldg(tx + w + x);
      const int32_t wx = __ldg(tx + 2 * w + x);
      int32_t p00, p01, p10, p11;
      if (kVariant == 0) {
        const uint8_t* s0 = src + static_cast<size_t>(r0) * sw;
        const uint8_t* s1 = src + static_cast<size_t>(r1) * sw;
        p00 = __ldg(s0 + a0);
        p01 = __ldg(s0 + a1);
        p10 = __ldg(s1 + a0);
        p11 = __ldg(s1 + a1);
      } else {
        p00 = r0 & 0xff;
        p01 = a1 & 0xff;
        p10 = r1 & 0xff;
        p11 = a0 & 0xff;
      }
      const int32_t top = p00 * (kOne - wx) + p01 * wx;
      const int32_t bot = p10 * (kOne - wx) + p11 * wx;
      const int32_t acc = top * (kOne - wy) + bot * wy;
      v = static_cast<uint32_t>((acc + (1 << (2 * kBits - 1)))
                                >> (2 * kBits));
    }
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

extern "C" int resize_probe(int variant, const uint8_t* src, int sh, int sw,
                            const int32_t* ty, const int32_t* tx,
                            uint8_t* dst, int h, int w, void* stream) {
  if (sh < 1 || sw < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const int n_pixels = h * w;
  const int blocks = ((n_pixels + 3) / 4 + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      resize_flat_kernel<0><<<blocks, kThreads, 0, st>>>(src, sw, ty, tx, dst,
                                                         h, w, n_pixels);
      break;
    case 1:
      resize_flat_kernel<1><<<blocks, kThreads, 0, st>>>(src, sw, ty, tx, dst,
                                                         h, w, n_pixels);
      break;
    case 2:
      resize_flat_kernel<2><<<blocks, kThreads, 0, st>>>(src, sw, ty, tx, dst,
                                                         h, w, n_pixels);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
