// Detect math shared by K1 (fast_harris_nms_cells.cu), K7
// (fast_harris_nms.cu) and K8 (fast_harris.cu): FAST-9 (two-mask
// rotate-AND chain), exact-int Sobel and 7x7 structure-tensor sums, the
// Harris response with truncated mantissas and k = 3/64 (every float product
// exact), the 15 px border, an optional ROI mask, and the disc NMS test where
// ties co-survive.  One copy of the selection-feeding math for all three.
//
// Staging: a 256-thread block owns a 32x64 output tile.  It stages the tile
// plus a (R + 4) px halo of u8 pixels in shared memory (R = radius - 1, the
// NMS reach; 0 for K8), computes Sobel gradients once (int16), then the
// masked response of the tile plus its R ring: -inf outside FAST corners,
// the border, the image or the mask, so a masked-out pixel neither survives
// nor suppresses.  Harris runs only where a pixel passes the cheap tests.
// Build with -fmad=false: the truncations keep Harris products exact, and no
// sum may be contracted into an FMA.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreads = (kTileH / 8) * kTileW;
constexpr int kHalo = 4;          // FAST circle 3; Sobel 1 + box window 3
constexpr int kBorder = 15;       // HALF_PATCH_SIZE
constexpr float kHarrisK = 3.0f / 64.0f;

// FAST_CIRCLE (semantics.py) in circular bit order
__constant__ int kFastDy[16] = {3, 3, 2, 1, 0, -1, -2, -3,
                                -3, -3, -2, -1, 0, 1, 2, 3};
__constant__ int kFastDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};

// Disc half-widths, entry i for dy = i - R (semantics.disc_row_extents),
// passed by value so the NMS reads them from the constant bank.
struct DiscTable {
  int wdx[2 * EFF_CELLS_MAX_RADIUS];
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float trunc_mantissa(float x, int drop) {
  return __int_as_float(__float_as_int(x) & ~((1 << drop) - 1));
}

__device__ __forceinline__ bool any_run9(unsigned m) {
  unsigned acc = m;
#pragma unroll
  for (int s = 1; s < 9; ++s) acc &= ((m >> s) | (m << (16 - s))) & 0xFFFFu;
  return acc != 0;
}

__device__ __forceinline__ bool fast9(const uint8_t* p, int stride,
                                      int threshold) {
  const int c = p[0];
  const int hi = c + threshold;
  const int lo = c - threshold;
  unsigned brighter = 0, darker = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int v = p[kFastDy[k] * stride + kFastDx[k]];
    brighter |= static_cast<unsigned>(v > hi) << k;
    darker |= static_cast<unsigned>(v < lo) << k;
  }
  return any_run9(brighter) || any_run9(darker);
}

// Harris response from the 7x7 box of gradients whose top-left is gx[0]
__device__ __forceinline__ float harris(const int16_t* gx, const int16_t* gy,
                                        int stride, float s2) {
  int sxx = 0, sxy = 0, syy = 0;
  for (int dy = 0; dy < 7; ++dy) {
    const int16_t* rx = gx + dy * stride;
    const int16_t* ry = gy + dy * stride;
#pragma unroll
    for (int dx = 0; dx < 7; ++dx) {
      const int a = rx[dx], b = ry[dx];
      sxx += a * a;
      sxy += a * b;
      syy += b * b;
    }
  }
  const float fxx = trunc_mantissa(__fmul_rn(s2, __int2float_rn(sxx)), 12);
  const float fxy = trunc_mantissa(__fmul_rn(s2, __int2float_rn(sxy)), 12);
  const float fyy = trunc_mantissa(__fmul_rn(s2, __int2float_rn(syy)), 12);
  const float tr = trunc_mantissa(__fadd_rn(fxx, fyy), 13);
  const float det = __fsub_rn(__fmul_rn(fxx, fyy), __fmul_rn(fxy, fxy));
  return __fsub_rn(det, __fmul_rn(kHarrisK, __fmul_rn(tr, tr)));
}

// Shared-memory layout of one block for NMS reach R.
struct Stage {
  int eh, ew;    // response region: tile + R ring
  int gh, gw;    // gradient region
  int wh, ww;    // pixel window
  float* resp;
  int16_t* gxs;
  int16_t* gys;
  uint8_t* win;
};

size_t stage_smem_bytes(int R) {
  const size_t eh = kTileH + 2 * R, ew = kTileW + 2 * R;
  return eh * ew * sizeof(float) + 2 * (eh + 6) * (ew + 6) * sizeof(int16_t)
         + (eh + 8) * (ew + 8);
}

__device__ __forceinline__ Stage stage_layout(unsigned char* smem, int R) {
  Stage st;
  st.eh = kTileH + 2 * R;
  st.ew = kTileW + 2 * R;
  st.gh = st.eh + 6;
  st.gw = st.ew + 6;
  st.wh = st.eh + 8;
  st.ww = st.ew + 8;
  st.resp = reinterpret_cast<float*>(smem);
  st.gxs = reinterpret_cast<int16_t*>(st.resp + st.eh * st.ew);
  st.gys = st.gxs + st.gh * st.gw;
  st.win = reinterpret_cast<uint8_t*>(st.gys + st.gh * st.gw);
  return st;
}

// Fill st.resp with the masked response of the block's tile (origin y0, x0)
// plus its R ring; response (r, c) is image (y0 - R + r, x0 - R + c).
// `mask`: (h, w) uint8, nonzero = search here, or NULL for none.
__device__ void stage_masked_response(const uint8_t* __restrict__ img,
                                      const uint8_t* __restrict__ mask, int h,
                                      int w, int threshold, int R, float s2,
                                      int y0, int x0, const Stage& st) {
  // 1. pixels of the tile + halo; zero outside the image
  for (int i = threadIdx.x; i < st.wh * st.ww; i += blockDim.x) {
    const int gy = y0 - R - kHalo + i / st.ww;
    const int gx = x0 - R - kHalo + i % st.ww;
    st.win[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                    ? img[static_cast<size_t>(gy) * w + gx] : 0;
  }
  __syncthreads();

  // 2. Sobel; gradient (i, j) sits at window (i + 1, j + 1)
  for (int i = threadIdx.x; i < st.gh * st.gw; i += blockDim.x) {
    const int ww = st.ww;
    const uint8_t* p = st.win + (i / st.gw + 1) * ww + (i % st.gw + 1);
    const int mm = p[-ww - 1], m0 = p[-ww], mp = p[-ww + 1];
    const int zm = p[-1], zp = p[1];
    const int pm = p[ww - 1], p0 = p[ww], pp = p[ww + 1];
    st.gxs[i] = static_cast<int16_t>((pp + 2 * zp + mp) - (pm + 2 * zm + mm));
    st.gys[i] = static_cast<int16_t>((pm + 2 * p0 + pp) - (mm + 2 * m0 + mp));
  }
  __syncthreads();

  // 3. masked response; response (r, c) is window (r + 4, c + 4), and its
  //    7x7 box starts at gradient (r, c)
  for (int i = threadIdx.x; i < st.eh * st.ew; i += blockDim.x) {
    const int r = i / st.ew, c = i % st.ew;
    const int gy = y0 - R + r, gx = x0 - R + c;
    float v = neg_inf();
    if (gy >= kBorder && gy < h - kBorder && gx >= kBorder &&
        gx < w - kBorder &&
        (mask == nullptr || mask[static_cast<size_t>(gy) * w + gx] != 0) &&
        fast9(st.win + (r + kHalo) * st.ww + (c + kHalo), st.ww, threshold))
      v = harris(st.gxs + r * st.gw + c, st.gys + r * st.gw + c, st.gw, s2);
    st.resp[i] = v;
  }
  __syncthreads();
}

// Disc NMS of the staged response at `center` (value v, not -inf): true when
// no response in the open disc is larger.  Stops at the first larger one.
__device__ __forceinline__ bool survives(const float* center, float v, int ew,
                                         int R, const DiscTable& disc) {
  for (int dy = -R; dy <= R; ++dy) {
    const int wd = disc.wdx[dy + R];
    const float* row = center + dy * ew;
    for (int dx = -wd; dx <= wd; ++dx)
      if (row[dx] > v) return false;
  }
  return true;
}

// Copy the host disc table and set the block's dynamic shared memory.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int R, const int32_t* disc_wdx,
                    DiscTable* disc, size_t* smem) {
  for (int i = 0; i < 2 * R + 1; ++i) disc->wdx[i] = disc_wdx ? disc_wdx[i] : 0;
  *smem = stage_smem_bytes(R);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace
