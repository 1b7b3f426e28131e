// K3: BAD descriptors straight from the u8 image.
//
// Replaces the TPU kernel `_bad_kernel_pair`
// (efficient_features_tpu/ops/window_kernels.py:534, launched by
// `_bad_descriptors_windows_impl` :731; `_bad_kernel` :358 and
// `_bad_kernel_noroll` :442 are equivalent TPU formulations).  Per
// (keypoint, bit): transform the learned box pair through the keypoint's
// affine, sum the two boxes, compare against the learned threshold and pack
// the bits MSB-first.  Interior keypoints use the plain box sums; keypoints
// within 28*s px of the border use the clamped boxes and the division-free
// compare s1*a2 - s2*a1 <= th*a1*a2 in exact int32 while a1*a2 < 2^22, else
// with 12-significant-bit operands whose f32 products are exact (ops/bad.py,
// window_kernels.py:298-347).  The TPU kernel sums every box in its own body
// from a window of the image it DMAs in; no integral image of the whole
// image exists on its path, and none does here.
//
// What bounds it on the H100: the box sums.  Per keypoint the 256 or 512
// bits read 2 x 4 corners of an integral each; building the integral of a
// keypoint's window is a few adds per window pixel.
//
// Design: one warp per keypoint, the branch uniform per warp.
//   - Window branch.  Every box of a keypoint lies within sup =
//     ceil(22.2133 * s) + 3 px of floor(x), floor(y) (ops/bad.window_plan,
//     which this mirrors: 22.2133 bounds |box centre - 16| + box radius of
//     both tables, the 3 px cover the rounding of the centre and of the
//     radius and the exclusive corner).  The warp reads that window of the
//     image, clipped to the image, and builds its int32 integral in shared
//     memory: a running column sum per lane, then a lane per row.
//     The bits read their corners there, each clamped to the window.  That
//     equals the whole-image integral with its clamps, because the part of
//     every box inside the image lies inside the window, and a clamped
//     border box lies inside the image.  Box sums are exact integers either
//     way, so the bytes cannot change.  A warp's integral holds kIntCap
//     entries: a window of 58 x 58 px, s up to 1.125 away from the border
//     (every detect_and_compute call has s = 31/32).
//   - Integral branch, for a larger window (compute() takes keypoints up to
//     300 px, windows of 430 px): the bits read the whole image's integral
//     in device memory.  A window's integral costs its area per keypoint,
//     the image's is shared by all of them; summing each box from the image
//     instead cost 121.6 ms for 40000 keypoints of 31-300 px (H100, 700 W).
//     The call builds that integral with kernels of its own only when some
//     valid keypoint needs it: `need_integral_kernel` decides on the card,
//     and the two passes (`integral_rows_kernel`, `integral_cols_kernel`)
//     return at once otherwise, as on every detect_and_compute call.
//     Keypoints come in any order and any size, so the branch is taken per
//     keypoint, in the kernel.
//   - Bands.  The image may be a band of a larger frame (`hs::Frame`, as
//     for K4; the sharded pipeline describes a band's keypoints in frame
//     coordinates), as `ops/bad.bad_descriptors` takes it with `origin` and
//     `frame_hw`: the box corners are rounded in frame coordinates, the
//     border test and the border boxes' clamps use the frame, and only the
//     box sums read the band, at the corners less the origin.  The window
//     reaches, in frame rows, from min(fy - sup, frame_h - 1) to max(fy +
//     sup + 2, 1), so that it also holds the edge row onto which a border
//     box wholly outside the frame is clamped; with the whole image as the
//     frame that is the window above.
// Lane l forms byte l (and l + 32 at 512 bits), so a row is written with one
// coalesced store per lane.  s, cos*s and sin*s come from the keypoint's
// size and angle here, by the trig that K4 and K11 run
// (`hs::keypoint_trig`, ops/bad.affine_trig op by op), and m02/m12 from
// those (`hs::keypoint_affine`, as _affine_from_block does), so the box
// corners are consistent with the rotation and the wrapper runs no torch
// op.  Build with -fmad=false: the trunc(v + 0.5) box corners must see each
// product and sum rounded on its own.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"
#include "hs_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullWarp = 0xffffffffu;
// ops/bad.py: BAD_SUPPORT, WINDOW_CAP, WINDOW_MAX_W, COORD_CAP, SUPPORT_CAP
constexpr float kSupport = 22.2133f;
constexpr int kIntCap = 59 * 59;     // int32 entries of a warp's integral
constexpr int kWinMaxW = 64;         // window columns: two lane chunks
constexpr int kRowBatch = 16;        // window rows loaded at once
constexpr int kFlagThreads = 256;
constexpr int kScanWarps = 8;        // image rows per block, pass 1
constexpr int kColSegs = 16;         // row segments per block, pass 2
constexpr float kCoordCap = 16777216.0f;
constexpr float kSupportCap = 1048576.0f;
constexpr size_t kSmemBytes = sizeof(int32_t) * kIntCap * kWarpsPerBlock;

__device__ __forceinline__ int round_num(float v) {  // CV_ROUNDNUM
  return static_cast<int>(truncf(__fadd_rn(v, 0.5f)));
}

__device__ __forceinline__ float trunc12(float v) {
  return __int_as_float(__float_as_int(v) & ~0xFFF);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The keypoint's window: image rows [y0, y0 + h), columns [x0, x0 + w).
struct Window {
  int y0, x0, h, w;
};

__device__ __forceinline__ Window window_plan(float x, float y, float s,
                                              const hs::Frame& f) {
  const int sup = static_cast<int>(fminf(
                      ceilf(__fmul_rn(kSupport, fmaxf(s, 0.0f))),
                      kSupportCap)) + 3;
  const int fy = static_cast<int>(floorf(fminf(fmaxf(y, -kCoordCap),
                                               kCoordCap)));
  const int fx = static_cast<int>(floorf(fminf(fmaxf(x, -kCoordCap),
                                               kCoordCap)));
  Window win;
  win.y0 = clampi(min(fy - sup, f.fh - 1) - f.oy, 0, f.h - 1);
  win.x0 = clampi(min(fx - sup, f.fw - 1) - f.ox, 0, f.w - 1);
  win.h = clampi(max(fy + sup + 2, 1) - f.oy, 1, f.h) - win.y0;
  win.w = clampi(max(fx + sup + 2, 1) - f.ox, 1, f.w) - win.x0;
  return win;
}

__device__ __forceinline__ bool window_fits(const Window& win) {
  return win.w <= kWinMaxW && (win.h + 1) * (win.w + 1) <= kIntCap;
}

// Box sums from a window's integral in shared memory; corners in image
// coordinates, clamped to the window.
struct WindowBoxes {
  const int32_t* ii;
  Window win;

  __device__ __forceinline__ int32_t at(int y, int x) const {
    y = clampi(y - win.y0, 0, win.h);
    x = clampi(x - win.x0, 0, win.w);
    return ii[y * (win.w + 1) + x];
  }
  __device__ __forceinline__ int32_t box(int y1, int x1, int y2,
                                         int x2) const {
    return at(y1, x1) + at(y2, x2) - at(y1, x2) - at(y2, x1);
  }
};

// Box sums from the whole image's (img_h + 1) x (img_w + 1) int32 integral
// in device memory, corners clamped to it; the sums wrap modulo 2^32 like
// the integral itself.
struct IntegralBoxes {
  const int32_t* p;
  int fh, fw;  // img_h + 1, img_w + 1

  __device__ __forceinline__ uint32_t at(int y, int x) const {
    y = clampi(y, 0, fh - 1);
    x = clampi(x, 0, fw - 1);
    return static_cast<uint32_t>(p[static_cast<size_t>(y) * fw + x]);
  }
  __device__ __forceinline__ int32_t box(int y1, int x1, int y2,
                                         int x2) const {
    return static_cast<int32_t>(at(y1, x1) + at(y2, x2) - at(y1, x2)
                                - at(y2, x1));
  }
};

// One keypoint's affine and border flag, and the learned tables.
struct Keypoint {
  float c, sn, s, m02, m12;
  bool in_border;
  hs::Frame frame;
};

struct Tables {
  const float *bx1, *bx2, *by1, *by2, *br, *th;
};

template <typename Boxes>
__device__ __forceinline__ bool bad_bit(const Boxes& ii, const Keypoint& kp,
                                        const Tables& t, int i) {
  const float u1 = __ldg(t.bx1 + i), v1 = __ldg(t.by1 + i);
  const float u2 = __ldg(t.bx2 + i), v2 = __ldg(t.by2 + i);
  const float c = kp.c, sn = kp.sn;
  const int cx1 = round_num(
      __fadd_rn(__fsub_rn(__fmul_rn(c, u1), __fmul_rn(sn, v1)), kp.m02));
  const int cy1 = round_num(
      __fadd_rn(__fadd_rn(__fmul_rn(sn, u1), __fmul_rn(c, v1)), kp.m12));
  const int cx2 = round_num(
      __fadd_rn(__fsub_rn(__fmul_rn(c, u2), __fmul_rn(sn, v2)), kp.m02));
  const int cy2 = round_num(
      __fadd_rn(__fadd_rn(__fmul_rn(sn, u2), __fmul_rn(c, v2)), kp.m12));
  const int r = round_num(__fmul_rn(kp.s, __ldg(t.br + i)));
  const float th = __ldg(t.th + i);
  // box corners in frame coordinates; the sums read the image at the
  // corners less its origin
  const int oy = kp.frame.oy, ox = kp.frame.ox;
  if (!kp.in_border) {
    // sums wrap modulo 2^32 like the integral-image form
    const uint32_t d =
        static_cast<uint32_t>(ii.box(cy1 - r - oy, cx1 - r - ox,
                                     cy1 + r + 1 - oy, cx1 + r + 1 - ox))
        - static_cast<uint32_t>(ii.box(cy2 - r - oy, cx2 - r - ox,
                                       cy2 + r + 1 - oy, cx2 + r + 1 - ox));
    const int side = 1 + 2 * r;
    return __int2float_rn(static_cast<int32_t>(d))
           <= __fmul_rn(th, __int2float_rn(side * side));
  }
  const int img_h = kp.frame.fh, img_w = kp.frame.fw;
  const int ax1 = clampi(cx1 - r, 0, img_w - 1);
  const int ay1 = clampi(cy1 - r, 0, img_h - 1);
  const int ax2 = clampi(cx1 + r + 1, 1, img_w);
  const int ay2 = clampi(cy1 + r + 1, 1, img_h);
  const int bx1 = clampi(cx2 - r, 0, img_w - 1);
  const int by1 = clampi(cy2 - r, 0, img_h - 1);
  const int bx2 = clampi(cx2 + r + 1, 1, img_w);
  const int by2 = clampi(cy2 + r + 1, 1, img_h);
  const int32_t s1 = ii.box(ay1 - oy, ax1 - ox, ay2 - oy, ax2 - ox);
  const int32_t s2 = ii.box(by1 - oy, bx1 - ox, by2 - oy, bx2 - ox);
  const int32_t a1 = (ay2 - ay1) * (ax2 - ax1);
  const int32_t a2 = (by2 - by1) * (bx2 - bx1);
  const float a1f = __int2float_rn(a1);
  const float a2f = __int2float_rn(a2);
  if (__fmul_rn(a1f, a2f) < 4194304.0f) {  // 2^22: int32 products exact
    const uint32_t lhs = static_cast<uint32_t>(s1) * static_cast<uint32_t>(a2)
                         - static_cast<uint32_t>(s2) * static_cast<uint32_t>(a1);
    const uint32_t aa = static_cast<uint32_t>(a1) * static_cast<uint32_t>(a2);
    return __int2float_rn(static_cast<int32_t>(lhs))
           <= __fmul_rn(th, __int2float_rn(static_cast<int32_t>(aa)));
  }
  const float s1t = trunc12(__int2float_rn(s1));
  const float s2t = trunc12(__int2float_rn(s2));
  const float a1t = trunc12(a1f);
  const float a2t = trunc12(a2f);
  return __fsub_rn(__fmul_rn(s1t, a2t), __fmul_rn(s2t, a1t))
         <= __fmul_rn(th, __fmul_rn(a1t, a2t));
}

// The window's (h + 1) x (w + 1) integral, zero top row and left column,
// into ii (row stride w + 1); win.w <= kWinMaxW.  First the column sums
// down the window, a lane per column, kRowBatch rows' loads in flight at
// once (a load per row in turn would wait out the L2's latency row after
// row); then the sums along each row in shared memory, a lane per row.
__device__ __forceinline__ void window_integral(const uint8_t* img, int img_w,
                                                const Window& win, int lane,
                                                int32_t* ii) {
  const int stride = win.w + 1;
  for (int c = lane; c < stride; c += 32) ii[c] = 0;
  for (int r = lane + 1; r <= win.h; r += 32) ii[r * stride] = 0;
  const uint8_t* src = img + static_cast<size_t>(win.y0) * img_w + win.x0;
  const bool in0 = lane < win.w, in1 = lane + 32 < win.w;
  int col0 = 0, col1 = 0;   // column sums of columns lane and lane + 32
  for (int r0 = 0; r0 < win.h; r0 += kRowBatch) {
    int p0[kRowBatch], p1[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const uint8_t* q = src + static_cast<size_t>(r0 + j) * img_w;
      const bool row = r0 + j < win.h;
      p0[j] = row && in0 ? __ldg(q + lane) : 0;
      p1[j] = row && in1 ? __ldg(q + lane + 32) : 0;
    }
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      if (r0 + j >= win.h) break;
      int32_t* dst = ii + (r0 + j + 1) * stride + 1;
      col0 += p0[j];
      col1 += p1[j];
      if (in0) dst[lane] = col0;
      if (in1) dst[lane + 32] = col1;
    }
  }
  __syncwarp();
  for (int r = lane + 1; r <= win.h; r += 32) {
    int32_t* row = ii + r * stride;
    int acc = 0;
#pragma unroll 8
    for (int c = 1; c <= win.w; ++c) {
      acc += row[c];
      row[c] = acc;
    }
  }
  __syncwarp();
}

// A keypoint's row of bytes: lane l forms byte l (and l + 32 at 512 bits)
// from its own 8 bits.
template <typename Boxes>
__device__ __forceinline__ void write_row(const Boxes& ii, const Keypoint& kp,
                                          const Tables& t, int nbytes,
                                          int lane, uint8_t* row) {
  for (int b = lane; b < nbytes; b += 32) {
    unsigned byte = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      byte |= static_cast<unsigned>(bad_bit(ii, kp, t, 8 * b + j)) << (7 - j);
    row[b] = static_cast<uint8_t>(byte);
  }
}

// *flag |= whether a valid keypoint's window is too large for a warp's
// integral, so that the call needs the whole image's (a thread per
// keypoint; *flag is zeroed before).
__global__ void __launch_bounds__(kFlagThreads)
need_integral_kernel(const float* __restrict__ kx,
                     const float* __restrict__ ky,
                     const float* __restrict__ ksize,
                     const uint8_t* __restrict__ valid, int n, float scale,
                     hs::Frame frame, int* __restrict__ flag) {
  const int k = blockIdx.x * kFlagThreads + threadIdx.x;
  const bool need =
      k < n && valid[k]
      && !window_fits(window_plan(kx[k], ky[k],
                                  hs::keypoint_scale(ksize[k], scale),
                                  frame));
  if (__syncthreads_or(need) && threadIdx.x == 0) atomicOr(flag, 1);
}

// The whole image's integral, pass 1 (only if *flag): the sums along each
// row into rows 1..h of `ii`, a warp per row, 4 pixels a lane per step;
// row 0 and column 0 zero.
__global__ void __launch_bounds__(kScanWarps * 32)
integral_rows_kernel(const uint8_t* __restrict__ img, int h, int w,
                     const int* __restrict__ flag, int32_t* __restrict__ ii) {
  if (!*flag) return;
  const int stride = w + 1;
  if (blockIdx.x == 0)
    for (int x = threadIdx.x; x < stride; x += blockDim.x) ii[x] = 0;
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (y >= h) return;
  const uint8_t* src = img + static_cast<size_t>(y) * w;
  int32_t* dst = ii + static_cast<size_t>(y + 1) * stride;
  if (lane == 0) dst[0] = 0;
  int carry = 0;   // a row's sum is below 2^31 at any width ours take
  for (int x0 = 0; x0 < w; x0 += 128) {
    const int x = x0 + 4 * lane;
    int p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = x + j < w ? __ldg(src + x + j) : 0;
    p[1] += p[0];
    p[2] += p[1];
    p[3] += p[2];
    int t = p[3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFullWarp, t, d);
      if (lane >= d) t += u;
    }
    const int before = carry + t - p[3];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x + j < w) dst[x + j + 1] = before + p[j];
    carry += __shfl_sync(kFullWarp, t, 31);
  }
}

// Pass 2 (only if *flag): the sums down each column, in place and modulo
// 2^32.  A block takes 32 columns; each of its kColSegs warps sums a
// segment of rows, then adds the segments above it.
__global__ void __launch_bounds__(32 * kColSegs)
integral_cols_kernel(int h, int w, const int* __restrict__ flag,
                     int32_t* __restrict__ ii) {
  __shared__ uint32_t s_tot[kColSegs][32];
  if (!*flag) return;
  const int tx = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const int x = blockIdx.x * 32 + tx + 1;
  const size_t stride = static_cast<size_t>(w) + 1;
  const int len = (h + kColSegs - 1) / kColSegs;
  const int r0 = 1 + seg * len, r1 = min(h + 1, r0 + len);
  uint32_t sum = 0;
  if (x <= w) {
#pragma unroll 8
    for (int r = r0; r < r1; ++r)
      sum += static_cast<uint32_t>(ii[r * stride + x]);
  }
  s_tot[seg][tx] = sum;
  __syncthreads();
  if (x > w) return;
  uint32_t acc = 0;
  for (int k = 0; k < seg; ++k) acc += s_tot[k][tx];
#pragma unroll 8
  for (int r = r0; r < r1; ++r) {
    acc += static_cast<uint32_t>(ii[r * stride + x]);
    ii[r * stride + x] = static_cast<int32_t>(acc);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bad_kernel(const uint8_t* __restrict__ img, hs::Frame frame,
           const float* __restrict__ kx, const float* __restrict__ ky,
           const float* __restrict__ ksize, const float* __restrict__ kangle,
           const uint8_t* __restrict__ valid, int n, float scale,
           const float* __restrict__ boxes,
           const float* __restrict__ thresholds, int nbits,
           const int32_t* __restrict__ integral, uint8_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x / 32;
  const int k = blockIdx.x * kWarpsPerBlock + warp;
  if (k >= n) return;  // uniform per warp
  const int lane = threadIdx.x % 32;
  const int nbytes = nbits / 8;
  uint8_t* row = out + static_cast<size_t>(k) * nbytes;
  if (!valid[k]) {
    for (int b = lane; b < nbytes; b += 32) row[b] = 0;
    return;
  }
  Keypoint kp;
  const float x = kx[k], y = ky[k];
  const hs::Trig trig = hs::keypoint_trig(ksize[k], kangle[k], scale);
  const hs::Affine a = hs::keypoint_affine(x, y, trig.c, trig.sn);
  kp.c = a.c;
  kp.sn = a.sn;
  kp.s = trig.s;
  kp.m02 = a.m02;
  kp.m12 = a.m12;
  // 28*s == 32 * (size/64) * MARGIN bit for bit (both round the same real)
  const float bw = __fmul_rn(28.0f, kp.s);
  kp.in_border = x < bw || __fadd_rn(x, bw) >= static_cast<float>(frame.fw)
                 || y < bw || __fadd_rn(y, bw) >= static_cast<float>(frame.fh);
  kp.frame = frame;
  const Tables t{boxes, boxes + nbits, boxes + 2 * nbits, boxes + 3 * nbits,
                 boxes + 4 * nbits, thresholds};

  const Window win = window_plan(x, y, kp.s, frame);
  if (window_fits(win)) {
    int32_t* ii = smem + warp * kIntCap;
    window_integral(img, frame.w, win, lane, ii);
    write_row(WindowBoxes{ii, win}, kp, t, nbytes, lane, row);
  } else {
    write_row(IntegralBoxes{integral, frame.h + 1, frame.w + 1}, kp, t,
              nbytes, lane, row);
  }
}

}  // namespace

extern "C" int eff_bad_descriptors(const uint8_t* img, int img_h, int img_w,
                                   int oy, int ox, int frame_h, int frame_w,
                                   const float* kx, const float* ky,
                                   const float* size, const float* angle,
                                   const uint8_t* valid, int n, float scale,
                                   const float* boxes,
                                   const float* thresholds, int nbits,
                                   int32_t* integral, int32_t* flag,
                                   uint8_t* out, void* stream) {
  if (img_h < 1 || img_w < 1 || n < 1 || (nbits != 256 && nbits != 512)
      || frame_h < 1 || frame_w < 1)
    return cudaErrorInvalidValue;
  const hs::Frame frame{oy, ox, frame_h, frame_w, img_h, img_w};
  cudaError_t err = cudaFuncSetAttribute(
      bad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(flag, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return err;
  need_integral_kernel<<<(n + kFlagThreads - 1) / kFlagThreads, kFlagThreads,
                         0, st>>>(kx, ky, size, valid, n, scale, frame,
                                  flag);
  integral_rows_kernel<<<(img_h + kScanWarps - 1) / kScanWarps,
                         kScanWarps * 32, 0, st>>>(img, img_h, img_w, flag,
                                                   integral);
  integral_cols_kernel<<<(img_w + 31) / 32, 32 * kColSegs, 0, st>>>(
      img_h, img_w, flag, integral);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bad_kernel<<<blocks, kWarpsPerBlock * 32, kSmemBytes, st>>>(
      img, frame, kx, ky, size, angle, valid, n, scale, boxes, thresholds,
      nbits, integral, out);
  return cudaGetLastError();
}
