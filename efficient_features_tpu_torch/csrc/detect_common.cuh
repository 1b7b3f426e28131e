// Detect math shared by K1 (fast_harris_nms_cells.cu), K7
// (fast_harris_nms.cu) and K8 (fast_harris.cu): FAST-9 (a run of 9 in
// either of two 16-bit masks), exact-int Sobel and 7x7 structure-tensor
// sums, the Harris response with truncated mantissas and k = 3/64 (every
// float product exact), the 15 px border and an optional ROI mask, into a
// dense response map; K1 and K7 run their disc NMS on that map in a kernel
// of their own.  One copy of the selection-feeding math for all three.
// Below it, the staged disc NMS body that K7 and K9 share
// (`nms_stage_tile`).
// They replace the TPU kernels of
// efficient_features_tpu/ops/pallas_kernels.py named in each source.
//
// What bounds this math on the H100: corners are a few percent of the
// pixels, so FAST (48 integer operations at every pixel) is the dense part
// and Harris (147 multiply-adds over 98 gradients) is sparse.  A thread per
// pixel that runs Harris where its pixel is a corner leaves most lanes of a
// warp idle through the whole of it.
//
// Staging, what the design does about that: a 256-thread block owns a 32x64
// output tile.  It stages the tile plus a 4 px halo of u8 pixels in shared
// memory, runs FAST, the border and the mask densely over the tile, and
// compacts the corners into a list (warp ballot; the list's order does not
// matter, each corner's response lands in its own pixel).  Then every thread
// takes a corner of the list and computes its Harris response straight from
// the u8 window, Sobel on the fly over the 9x9 neighbourhood: no gradient
// planes, and the warps stay full.  The response of the tile is -inf
// outside FAST corners, the border, the image or the mask, so a masked-out
// pixel neither survives nor suppresses.
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
constexpr unsigned kFullWarp = 0xffffffffu;

// FAST_CIRCLE (semantics.py) in circular bit order
__constant__ int kFastDy[16] = {3, 3, 2, 1, 0, -1, -2, -3,
                                -3, -3, -2, -1, 0, 1, 2, 3};
__constant__ int kFastDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float trunc_mantissa(float x, int drop) {
  return __int_as_float(__float_as_int(x) & ~((1 << drop) - 1));
}

// True when the 16-bit ring `m` holds 9 consecutive set bits.  On the ring
// laid out twice in 32 bits, bit i of x stays set while a run of 2, 4, 8 and
// then 9 bits starts at i; a run that starts in the low half ends below bit
// 24.  Equal to the rotate-AND chain of the JAX kernel on all 65536 masks.
__device__ __forceinline__ bool any_run9(unsigned m) {
  unsigned x = m | (m << 16);
  x &= x >> 1;
  x &= x >> 2;
  x &= x >> 4;
  x &= x >> 1;
  return (x & 0xFFFFu) != 0;
}

__device__ __forceinline__ bool fast9(const uint8_t* p, int stride,
                                      int threshold) {
  const int c = p[0];
  const int hi = c + threshold;
  const int lo = c - threshold;
  // any 9 consecutive taps hold at least two of the four compass taps
  // (0, 4, 8, 12): most pixels of a flat region stop here
  const int n = p[3 * stride], e = p[3], s = p[-3 * stride], w = p[-3];
  if ((n > hi) + (e > hi) + (s > hi) + (w > hi) < 2 &&
      (n < lo) + (e < lo) + (s < lo) + (w < lo) < 2)
    return false;
  unsigned brighter = 0, darker = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int v = p[kFastDy[k] * stride + kFastDx[k]];
    brighter |= static_cast<unsigned>(v > hi) << k;
    darker |= static_cast<unsigned>(v < lo) << k;
  }
  return any_run9(brighter) || any_run9(darker);
}

// Harris response at pixel `p` of a u8 window: Sobel gradients of the 7x7
// box around p from the 9x9 pixels around it, three pixel rows at a time.
// The integer sums are order-free; the float steps keep their order.
__device__ __forceinline__ float harris_at(const uint8_t* p, int stride,
                                           float s2) {
  int px[3][9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    px[0][j] = p[-4 * stride + j - 4];
    px[1][j] = p[-3 * stride + j - 4];
  }
  int sxx = 0, sxy = 0, syy = 0;
#pragma unroll
  for (int r = 0; r < 7; ++r) {          // gradient row r - 3
    // pixel rows r - 4, r - 3, r - 2 sit in px[up], px[mid], px[down]
    const int up = r % 3, mid = (r + 1) % 3, down = (r + 2) % 3;
#pragma unroll
    for (int j = 0; j < 9; ++j) px[down][j] = p[(r - 2) * stride + j - 4];
    int col[9];                          // vertical 1-2-1 sums
#pragma unroll
    for (int j = 0; j < 9; ++j)
      col[j] = px[up][j] + 2 * px[mid][j] + px[down][j];
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      const int a = col[j + 1] - col[j - 1];
      const int b =
          (px[down][j - 1] + 2 * px[down][j] + px[down][j + 1]) -
          (px[up][j - 1] + 2 * px[up][j] + px[up][j + 1]);
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

// Append the lanes with `take` set to a list in shared memory (`item` per
// lane, `count` the list's length).  Every lane of the warp must call it.
__device__ __forceinline__ void warp_append(bool take, uint16_t item,
                                            uint16_t* list, int* count) {
  const unsigned m = __ballot_sync(kFullWarp, take);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  int slot = 0;
  if (lane == 0) slot = atomicAdd(count, __popc(m));
  slot = __shfl_sync(kFullWarp, slot, 0);
  if (take) list[slot + __popc(m & ((1u << lane) - 1))] = item;
}

// Shared-memory layout of one block: the tile's response, its corner list
// and the u8 pixel window (tile + halo).
constexpr int kWinH = kTileH + 2 * kHalo;
constexpr int kWinW = kTileW + 2 * kHalo;

struct Stage {
  float resp[kTileH * kTileW];
  uint16_t list[kTileH * kTileW];   // tile indices of the corners
  int count;
  uint8_t win[kWinH * kWinW];
};

// Fill st.resp with the masked response of the block's tile (origin y0, x0).
// `mask`: (h, w) uint8, nonzero = search here, or NULL for none.
// blockDim.x must be a multiple of 32.
__device__ void stage_masked_response(const uint8_t* __restrict__ img,
                                      const uint8_t* __restrict__ mask, int h,
                                      int w, int threshold, float s2, int y0,
                                      int x0, Stage& st) {
  // 1. pixels of the tile + halo, a warp per window row; zero outside the
  //    image
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if (threadIdx.x == 0) st.count = 0;
  for (int r = warp; r < kWinH; r += warps) {
    const int gy = y0 - kHalo + r;
    const bool row_in = gy >= 0 && gy < h;
    const uint8_t* src = img + static_cast<size_t>(row_in ? gy : 0) * w;
    for (int c = lane; c < kWinW; c += 32) {
      const int gx = x0 - kHalo + c;
      st.win[r * kWinW + c] = (row_in && gx >= 0 && gx < w) ? src[gx] : 0;
    }
  }
  __syncthreads();

  // 2. the cheap tests at every pixel of the tile, a warp per tile row,
  //    corners to the list; response (r, c) is window (r + 4, c + 4)
  for (int r = warp; r < kTileH; r += warps) {
    const int gy = y0 + r;
    const bool row_ok = gy >= kBorder && gy < h - kBorder;
    for (int base = 0; base < kTileW; base += 32) {
      const int c = base + lane;
      const int gx = x0 + c;
      const bool corner =
          row_ok && gx >= kBorder && gx < w - kBorder &&
          (mask == nullptr || mask[static_cast<size_t>(gy) * w + gx] != 0) &&
          fast9(st.win + (r + kHalo) * kWinW + (c + kHalo), kWinW, threshold);
      st.resp[r * kTileW + c] = neg_inf();
      warp_append(corner, static_cast<uint16_t>(r * kTileW + c), st.list,
                  &st.count);
    }
  }
  __syncthreads();

  // 3. Harris at the corners, one corner per thread
  const int n = st.count;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int i = st.list[k];
    const int r = i / kTileW, c = i % kTileW;
    st.resp[i] = harris_at(st.win + (r + kHalo) * kWinW + (c + kHalo), kWinW,
                           s2);
  }
  __syncthreads();
}

// The dense masked response of an image, tile by tile: K8's kernel, and the
// first of K1's two.  out: (h, w) f32, the Harris response at border-valid
// FAST corners inside the mask, -inf elsewhere.  Each thread stores 8 rows
// of one column, so for each row a warp stores 32 consecutive floats.
__global__ void __launch_bounds__(kThreads)
fast_harris_kernel(const uint8_t* __restrict__ img,
                   const uint8_t* __restrict__ mask, int h, int w,
                   int threshold, float s2, float* __restrict__ out) {
  __shared__ Stage st;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  stage_masked_response(img, mask, h, w, threshold, s2, y0, x0, st);

  const int cr = threadIdx.x / kTileW, cc = threadIdx.x % kTileW;
  const int x = x0 + cc;
  if (x >= w) return;
  for (int k = 0; k < 8; ++k) {
    const int ty = cr * 8 + k;
    if (y0 + ty >= h) return;
    out[static_cast<size_t>(y0 + ty) * w + x] = st.resp[ty * kTileW + cc];
  }
}

// Launch `fast_harris_kernel` over the whole image.
cudaError_t launch_fast_harris(const uint8_t* img, const uint8_t* mask, int h,
                               int w, int threshold, float s2, float* out,
                               cudaStream_t stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  fast_harris_kernel<<<grid, kThreads, 0, stream>>>(img, mask, h, w,
                                                    threshold, s2, out);
  return cudaGetLastError();
}

// The staged disc NMS of K7 (fast_harris_nms.cu) and K9 (radius_nms.cu) at
// radius 1..EFF_STAGED_MAX_RADIUS, on a response map that is -inf where
// there is no corner: a corner survives when no response of its open disc
// is larger (ties co-survive).  A block per 32x64 tile reads its tile of
// the map plus the R = radius - 1 ring (R <= 8) into shared memory, keeps
// the corners of each staged row as a bit mask, and compacts the tile's
// corners into a list.  A thread per listed corner then tests it against
// the corners of its disc only: for each disc row (dy = 0, -1, 1, -2, ...,
// since a larger neighbour is most likely near) it cuts the row's mask to
// the disc's columns and compares the response of each set bit, stopping
// at the first larger one.  Its work is a funnel shift per disc row and a
// compare per corner in the disc, not a load per disc pixel, and no lane
// walks a disc while the rest of its warp waits on non-corners.  The map
// itself is never changed: a suppressed corner still suppresses.  The
// disc's half-widths come from a device table (entry i for dy = i - R,
// semantics.disc_row_extents), copied to shared memory.  Each kernel then
// writes the tile from `keep` in its own form.
constexpr int kNmsMaxReach = EFF_STAGED_MAX_RADIUS - 1;
constexpr int kNmsRegH = kTileH + 2 * kNmsMaxReach;   // staged rows, at most
constexpr int kNmsRegW = kTileW + 2 * kNmsMaxReach;   // row stride of val
constexpr int kNmsMaskWords = 4;   // 3 words hold kNmsRegW bits, the 4th is 0

struct NmsStage {
  float val[kNmsRegH * kNmsRegW];              // the tile + ring
  uint32_t bits[kNmsRegH * kNmsMaskWords];     // its corners, per row
  uint16_t list[kTileH * kTileW];              // the tile's corners
  uint8_t keep[kTileH * kTileW];               // 1 = a surviving corner
  int wdx[2 * kNmsMaxReach + 1];
  int count;
};

// Fill st for the tile at (y0, x0): val (-inf outside the image) and keep.
// blockDim.x must be kThreads.
__device__ __forceinline__ void nms_stage_tile(
    const float* __restrict__ resp, int h, int w, int R,
    const int32_t* __restrict__ disc_wdx, int y0, int x0, NmsStage& st) {
  const int eh = kTileH + 2 * R, ew = kTileW + 2 * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) st.count = 0;
  if (threadIdx.x < 2 * R + 1) st.wdx[threadIdx.x] = disc_wdx[threadIdx.x];
  for (int p = threadIdx.x; p < kTileH * kTileW; p += kThreads) st.keep[p] = 0;
  __syncthreads();

  // 1. the tile + ring, a warp per staged row, every row's loads in flight
  //    at once; -inf outside the image
#pragma unroll
  for (int j = 0; j < kNmsRegH / (kThreads / 32); ++j) {
    const int r = warp + j * (kThreads / 32);
    const int gy = y0 - R + r;
    const bool row_in = r < eh && gy >= 0 && gy < h;
#pragma unroll
    for (int word = 0; word < kNmsMaskWords - 1; ++word) {
      const int c = word * 32 + lane;
      const int gx = x0 - R + c;
      float v = neg_inf();
      if (row_in && c < ew && gx >= 0 && gx < w)
        v = resp[static_cast<size_t>(gy) * w + gx];
      if (r < eh && c < ew) st.val[r * kNmsRegW + c] = v;
    }
  }
  __syncthreads();
  // each staged row's corners as a bit mask, the tile's corners to the list
  for (int r = warp; r < eh; r += kThreads / 32) {
    for (int word = 0; word < kNmsMaskWords; ++word) {
      const int c = word * 32 + lane;
      const bool corner = c < ew && st.val[r * kNmsRegW + c] != neg_inf();
      const unsigned m = __ballot_sync(kFullWarp, corner);
      if (lane == 0) st.bits[r * kNmsMaskWords + word] = m;
      const int ty = r - R, tx = c - R;
      warp_append(corner && ty >= 0 && ty < kTileH && tx >= 0 && tx < kTileW,
                  static_cast<uint16_t>(ty * kTileW + tx), st.list,
                  &st.count);
    }
  }
  __syncthreads();

  // 2. each tile corner against the corners of its open disc
  const int n = st.count;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int p = st.list[k];
    const int rr = p / kTileW + R, cc = p % kTileW + R;
    const float v = st.val[rr * kNmsRegW + cc];
    bool alive = true;
    for (int i = 0; i <= 2 * R && alive; ++i) {
      const int dy = (i & 1) ? -((i + 1) >> 1) : (i >> 1);
      const int wd = st.wdx[dy + R];
      const int lo = cc - wd;           // >= 0: wd <= R
      const uint32_t* bits = st.bits + (rr + dy) * kNmsMaskWords + (lo >> 5);
      const uint64_t pair = bits[0] | (static_cast<uint64_t>(bits[1]) << 32);
      uint32_t m = static_cast<uint32_t>(pair >> (lo & 31))
                   & ((2u << (2 * wd)) - 1u);
      const float* row = st.val + (rr + dy) * kNmsRegW + lo;
      for (; m; m &= m - 1) {
        if (row[__ffs(m) - 1] > v) {
          alive = false;
          break;
        }
      }
    }
    if (alive) st.keep[p] = 1;
  }
  __syncthreads();
}

}  // namespace
