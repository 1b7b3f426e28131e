// Shapes of the HashSIFT warp K4 (csrc/warp_patches.cu) for
// tools/warp_probe.py, which builds this file into a library of its own.
// Each variant computes K4's patches (but `floor`) through the same
// `hs::sample_word`, so all but `floor` give K4's bytes:
//   0 block_direct: K4's shape, a 256-thread block per keypoint, without
//     its window (every sample reads the image);
//   1 warp_direct: a warp per keypoint, 8 to a block, reading the image;
//   2 warp_staged: a warp per keypoint staging the window of K4's plan in
//     shared memory, eight lanes a row, each row shifted to its first
//     column with funnel shifts (16 rows' loads in flight);
//   3 floor: as 1 with the pixel fetch replaced by a constant (no load).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hs_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kWinSide = 64;
constexpr int kWinStride = 80;
constexpr int kRowBatch = 4;
constexpr float kSupport = 22.63f;
constexpr float kCoordCap = 1048576.0f;
constexpr int kWords = hs::kPatchPixels / 4;

struct Window {
  int y0, x0, h, w;
  bool fits;
};

// csrc/warp_patches.cu's window
__device__ __forceinline__ Window warp_window(float x, float y, float s,
                                              int img_h, int img_w) {
  const int sup = static_cast<int>(fminf(
                      ceilf(__fmul_rn(kSupport, fabsf(s))), kCoordCap)) + 2;
  const bool near = fabsf(x) < kCoordCap && fabsf(y) < kCoordCap;
  const int fy = near ? static_cast<int>(floorf(y)) : 0;
  const int fx = near ? static_cast<int>(floorf(x)) : 0;
  Window win;
  win.y0 = max(fy - sup, 0);
  win.x0 = max(fx - sup, 0);
  win.h = max(min(fy + sup, img_h - 1) - win.y0 + 1, 0);
  win.w = max(min(fx + sup, img_w - 1) - win.x0 + 1, 0);
  win.fits = near && win.h <= kWinSide && win.w <= kWinSide;
  return win;
}

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

// bytes [off, off + 16) of the 32 bytes a, b
__device__ __forceinline__ uint4 shift16(uint4 a, uint4 b, int off) {
  uint32_t t[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  if (off & 8) {
#pragma unroll
    for (int i = 0; i < 6; ++i) t[i] = t[i + 2];
  }
  if (off & 4) {
#pragma unroll
    for (int i = 0; i < 5; ++i) t[i] = t[i + 1];
  }
  const unsigned sh = 8u * (off & 3);
  return make_uint4(__funnelshift_r(t[0], t[1], sh),
                    __funnelshift_r(t[1], t[2], sh),
                    __funnelshift_r(t[2], t[3], sh),
                    __funnelshift_r(t[3], t[4], sh));
}

__device__ __forceinline__ void stage_shifted(const uint8_t* img, int img_h,
                                              int img_w, const Window& win,
                                              int lane, uint8_t* smem) {
  const uint8_t* hi = img + static_cast<size_t>(img_h) * img_w;
  const int g = lane / 8, q = lane % 8;
  for (int r0 = 0; r0 < win.h; r0 += 4 * kRowBatch) {
    uint4 v[kRowBatch];
    int off[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const int r = r0 + 4 * j + g;
      const uint8_t* first =
          img + static_cast<size_t>(win.y0 + r) * img_w + win.x0;
      off[j] = static_cast<int>(reinterpret_cast<uintptr_t>(first) & 15u);
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (r < win.h && q < 5) v[j] = load16(first - off[j] + 16 * q, img, hi);
    }
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      uint4 next;
      next.x = __shfl_down_sync(0xffffffffu, v[j].x, 1);
      next.y = __shfl_down_sync(0xffffffffu, v[j].y, 1);
      next.z = __shfl_down_sync(0xffffffffu, v[j].z, 1);
      next.w = __shfl_down_sync(0xffffffffu, v[j].w, 1);
      const int r = r0 + 4 * j + g;
      if (r < win.h && q < kWinSide / 16)
        *reinterpret_cast<uint4*>(smem + r * kWinStride + 16 * q) =
            shift16(v[j], next, off[j]);
    }
  }
}

struct ShiftedFetch {   // pixel (r, c) at byte (r - y0) * stride + c - x0
  const uint8_t* win;
  int y0, x0;

  __device__ __forceinline__ void operator()(int r0, int r1, int c0, int c1,
                                             float& p00, float& p01,
                                             float& p10, float& p11) const {
    const uint8_t* p = win + (r0 - y0) * kWinStride - x0;
    const uint8_t* q = win + (r1 - y0) * kWinStride - x0;
    p00 = p[c0];
    p01 = p[c1];
    p10 = q[c0];
    p11 = q[c1];
  }
};

struct ConstFetch {
  __device__ __forceinline__ void operator()(int, int, int, int, float& p00,
                                             float& p01, float& p10,
                                             float& p11) const {
    p00 = 10.0f;
    p01 = 20.0f;
    p10 = 30.0f;
    p11 = 40.0f;
  }
};

__global__ void __launch_bounds__(256)
block_direct(const uint8_t* __restrict__ img, int h, int w,
             const float* __restrict__ kx, const float* __restrict__ ky,
             const float* __restrict__ ksize,
             const float* __restrict__ kangle,
             const uint8_t* __restrict__ valid, int n, float scale,
             uint8_t* __restrict__ out) {
  __shared__ hs::Affine s_affine;
  const int k = blockIdx.x, t = threadIdx.x;
  uint32_t* row = reinterpret_cast<uint32_t*>(
      out + static_cast<size_t>(k) * hs::kPatchPixels);
  if (!valid[k]) {
    row[t] = 0u;
    return;
  }
  if (t == 0) {
    const hs::Trig trig = hs::keypoint_trig(ksize[k], kangle[k], scale);
    s_affine = hs::keypoint_affine(kx[k], ky[k], trig.c, trig.sn);
  }
  __syncthreads();
  row[t] = hs::sample_word<false>(hs::GlobalFetch{img, w},
                                  hs::whole_image(h, w), s_affine, 4 * t);
}

template <int kVariant>
__global__ void __launch_bounds__(kWarps * 32)
warp_variant(const uint8_t* __restrict__ img, int h, int w,
             const float* __restrict__ kx, const float* __restrict__ ky,
             const float* __restrict__ ksize,
             const float* __restrict__ kangle,
             const uint8_t* __restrict__ valid, int n, float scale,
             uint8_t* __restrict__ out) {
  __shared__ __align__(16)
      uint8_t s_win[kWarps][kVariant == 2 ? kWinSide * kWinStride : 16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= n) return;
  uint8_t* row = out + static_cast<size_t>(k) * hs::kPatchPixels;
  if (!valid[k]) {
    reinterpret_cast<uint4*>(row)[lane] = make_uint4(0u, 0u, 0u, 0u);
    reinterpret_cast<uint4*>(row)[lane + 32] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const float x = kx[k], y = ky[k];
  const hs::Trig t = hs::keypoint_trig(ksize[k], kangle[k], scale);
  const hs::Affine a = hs::keypoint_affine(x, y, t.c, t.sn);
  uint32_t* words = reinterpret_cast<uint32_t*>(row);
  const Window win = warp_window(x, y, t.s, h, w);
  if (kVariant == 2 && win.fits) {
    stage_shifted(img, h, w, win, lane, s_win[warp]);
    __syncwarp();
    const ShiftedFetch fetch{s_win[warp], win.y0, win.x0};
#pragma unroll 2
    for (int i = lane; i < kWords; i += 32)
      words[i] = hs::sample_word<false>(fetch, hs::whole_image(h, w), a,
                                        4 * i);
  } else if (kVariant == 3) {
#pragma unroll 2
    for (int i = lane; i < kWords; i += 32)
      words[i] = hs::sample_word<false>(ConstFetch{}, hs::whole_image(h, w),
                                        a, 4 * i);
  } else {
#pragma unroll 2
    for (int i = lane; i < kWords; i += 32)
      words[i] = hs::sample_word<false>(hs::GlobalFetch{img, w},
                                        hs::whole_image(h, w), a, 4 * i);
  }
}

}  // namespace

extern "C" int warp_probe(int variant, const uint8_t* img, int h, int w,
                          const float* kx, const float* ky, const float* size,
                          const float* angle, const uint8_t* valid, int n,
                          float scale, uint8_t* out, void* stream) {
  if (h < 1 || w < 1 || n < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kWarps - 1) / kWarps;
  switch (variant) {
    case 0:
      block_direct<<<n, 256, 0, st>>>(img, h, w, kx, ky, size, angle, valid,
                                      n, scale, out);
      break;
    case 1:
      warp_variant<1><<<blocks, kWarps * 32, 0, st>>>(
          img, h, w, kx, ky, size, angle, valid, n, scale, out);
      break;
    case 2:
      warp_variant<2><<<blocks, kWarps * 32, 0, st>>>(
          img, h, w, kx, ky, size, angle, valid, n, scale, out);
      break;
    case 3:
      warp_variant<3><<<blocks, kWarps * 32, 0, st>>>(
          img, h, w, kx, ky, size, angle, valid, n, scale, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
