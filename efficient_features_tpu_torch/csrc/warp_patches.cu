// K4: HashSIFT patch warp, 32x32 bilinear samples under the keypoint affine.
//
// Replaces the TPU kernels `_warp_kernel`
// (efficient_features_tpu/ops/window_kernels.py:1034, launched by
// `_warp_patches_windows_impl` :1238) and `_warp_kernel_big` (:1741,
// launched by `_warp_patches_windows_big_impl` :1850), and the XLA gather
// path that takes keypoints above `_S_CAP` (ops/hash_sift.warp_patches).
// The TPU splits keypoints by size because each kernel DMAs a fixed window
// around its keypoints; here one kernel takes keypoints of any size and
// decides per keypoint where it reads the pixels.
//
// Per keypoint (x, y, size, angle) under the scale factor: s, c = cos*s and
// sn = sin*s (`hs::keypoint_trig`, ops/bad.affine_trig op by op), then per
// sample (px, py) u = c*px - sn*py + m02, v = sn*px + c*py + m12 and the
// reference's full-f32 lerp of the 2x2 support, or 0 where it leaves the
// image (`hs::sample_word`, which the fused kernel K11 compiles too).
//
// What bounds it on the H100: per sample about 40 float and integer
// operations and 11 type conversions (int to float and back, floor, trunc),
// which run at a quarter of the float rate, and 4 pixel loads; the 1 KB
// output row is the only DRAM traffic that grows with the keypoints (41 MB
// at 40000).  On a detect_and_compute call the 8 launches are short (2425
// to 8687 slots a level), so each launch's ramp and tail weigh as much as
// the samples (timed beside the shapes below and beside a floor whose
// pixel fetch is a constant).
//
// Design: a 256-thread block per keypoint, 4 samples (one 32-bit word of
// the patch) a thread, as in the first design, whose shape keeps the most
// loads of a large keypoint in flight (a warp per keypoint is slower on
// compute()'s 31-300 px keypoints).
//   - The trig is computed here from the keypoint's size and angle, once,
//     by thread 0 (`hs::keypoint_trig`), so the wrapper launches this
//     kernel and runs no torch op.  An invalid slot's block writes its zero
//     row and leaves.
//   - Window branch.  Every sample's 2x2 support lies within sup =
//     ceil(22.63 |s|) + 2 px of (floor x, floor y): the patch corners are
//     16 sqrt(2) = 22.627 |s| from the keypoint, one more pixel for the
//     support's far side, one for the rounding of u and v while |x|, |y| <
//     2^20 (`ops/hash_sift.warp_window_plan`, which this mirrors).  The
//     block copies that window, clipped to the image, into shared memory
//     with one aligned 16-byte load per thread and chunk (5 chunks a row,
//     at most 64 rows: every load in flight at once), each row's chunks as
//     they lie in the image, so that column c of window row r sits at byte
//     r * kWinStride + off(r) + c, off(r) the row's offset from its first
//     aligned chunk.  The samples then read the window.  The in-image test
//     stays in image coordinates and the arithmetic is `sample_word`'s, so
//     the bytes are those of the direct branch.  A window of at most
//     kWinSide x kWinSide px (s up to 1.28, size 41 at scale 1: every
//     detect_and_compute call) takes it.
//   - Direct branch, for a larger window (compute() takes keypoints up to
//     300 px) or a keypoint far off the image: the samples read the image.
//   - Bands.  The image may be a band of a larger frame (`hs::Frame`: the
//     sharded pipeline describes a band's keypoints in frame coordinates):
//     the in-image test is against the frame, the pixels are read at the
//     band's rows, clamped into the band as the plain version clamps them.
//     A band's launch takes the kernel's band instantiation (`kBand`); the
//     whole image's takes the one without the clamps, which cost a tenth
//     of the kernel's time, and without the band tests of the window.  The
//     window branch is taken only where every valid sample's support lies
//     in the band, so that no read is clamped; with the whole image as its
//     frame that holds always.
// Build with -fmad=false: every product and sum rounds on its own, as in
// the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"
#include "hs_common.cuh"
#include "u8_rows.cuh"

namespace {

constexpr int kThreads = hs::kPatchPixels / 4;  // 4 samples a thread
constexpr int kWinSide = 64;                    // window rows, columns
constexpr int kRowChunks = 5;                   // 16-byte chunks a row
constexpr int kWinStride = 16 * kRowChunks;     // bytes a window row
constexpr float kSupport = 22.63f;       // ops/hash_sift.WARP_SUPPORT
constexpr float kCoordCap = 1048576.0f;  // 2^20: ops/hash_sift.COORD_CAP

// The keypoint's window: image rows [y0, y0 + h), columns [x0, x0 + w),
// clipped to the image (h or w 0: no pixel of the image is near).
struct Window {
  int y0, x0, h, w;
  bool fits;   // staged in shared memory
};

// Whether the frame's part of [c - sup, c + sup] (frame rows or columns,
// frame side n) lies in the image's [o, o + m): then no valid sample's read
// is clamped.
__device__ __forceinline__ bool span_in_image(int c, int sup, int n, int o,
                                              int m) {
  const int lo = max(c - sup, 0), hi = min(c + sup, n - 1);
  return lo > hi || (lo >= o && hi < o + m);
}

// Without kBand the frame is the image (origin 0): the window needs no
// band test.
template <bool kBand>
__device__ __forceinline__ Window warp_window(float x, float y, float s,
                                              const hs::Frame& f) {
  const int sup = static_cast<int>(fminf(
                      ceilf(__fmul_rn(kSupport, fabsf(s))), kCoordCap)) + 2;
  const bool near = fabsf(x) < kCoordCap && fabsf(y) < kCoordCap;
  const int fy = near ? static_cast<int>(floorf(y)) : 0;
  const int fx = near ? static_cast<int>(floorf(x)) : 0;
  const int oy = kBand ? f.oy : 0, ox = kBand ? f.ox : 0;
  Window win;
  win.y0 = max(fy - oy - sup, 0);
  win.x0 = max(fx - ox - sup, 0);
  win.h = max(min(fy - oy + sup, f.h - 1) - win.y0 + 1, 0);
  win.w = max(min(fx - ox + sup, f.w - 1) - win.x0 + 1, 0);
  win.fits = near && win.h <= kWinSide && win.w <= kWinSide;
  if (kBand)
    win.fits = win.fits && span_in_image(fy, sup, f.fh, oy, f.h)
               && span_in_image(fx, sup, f.fw, ox, f.w);
  return win;
}

// A byte as float, exactly, without a conversion instruction: 2^23 + b
// has b as its mantissa.
__device__ __forceinline__ float byte_float(uint32_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.0f);
}

// The staged window: image pixel (r, c) at byte (r - y0) * kWinStride +
// off(r - y0) + (c - x0), off(i) = (a0 + i * w) % 16 with a0 the address
// of pixel (y0, x0) (its low bits).  Row r1 (r0 or r0 + 1) is reached from
// row r0: off(i + d) = (off(i) + d * w) % 16, which for the whole image's
// r1 = r0 + 1 is one add.
struct StagedFetch {
  const uint8_t* win;
  int y0, x0;
  uint32_t a0, w;

  __device__ __forceinline__ void operator()(int r0, int r1, int c0, int c1,
                                             float& p00, float& p01,
                                             float& p10, float& p11) const {
    const int i = r0 - y0, d = r1 - r0;
    const uint32_t off0 = (a0 + static_cast<uint32_t>(i) * w) & 15u;
    const uint32_t off1 = (off0 + static_cast<uint32_t>(d) * w) & 15u;
    const uint8_t* p = win + i * kWinStride + off0 - x0;
    const uint8_t* q = win + (i + d) * kWinStride + off1 - x0;
    p00 = byte_float(p[c0]);
    p01 = byte_float(p[c1]);
    p10 = byte_float(q[c0]);
    p11 = byte_float(q[c1]);
  }
};

template <bool kBand>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const uint8_t* __restrict__ img, int h, int w,
            const float* __restrict__ kx, const float* __restrict__ ky,
            const float* __restrict__ ksize,
            const float* __restrict__ kangle,
            const uint8_t* __restrict__ valid, int n, float scale,
            hs::Frame frame, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t s_win[kWinSide * kWinStride];
  __shared__ hs::Affine s_affine;
  const int k = blockIdx.x, t = threadIdx.x;
  uint32_t* row = reinterpret_cast<uint32_t*>(
      out + static_cast<size_t>(k) * hs::kPatchPixels);
  if (!valid[k]) {   // uniform per block
    row[t] = 0u;
    return;
  }
  const float x = kx[k], y = ky[k], size = ksize[k];
  const Window win =
      warp_window<kBand>(x, y, hs::keypoint_scale(size, scale), frame);
  if (t == 0) {
    const hs::Trig trig = hs::keypoint_trig(size, kangle[k], scale);
    s_affine = hs::keypoint_affine(x, y, trig.c, trig.sn);
  }
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(img)
                       + static_cast<size_t>(win.y0) * w + win.x0;
  if (win.fits) {
    const uint8_t* hi = img + static_cast<size_t>(h) * w;
    for (int i = t; i < win.h * kRowChunks; i += kThreads) {
      const int r = i / kRowChunks, q = i - r * kRowChunks;
      const uintptr_t first = a0 + static_cast<size_t>(r) * w;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(
          (first & ~uintptr_t{15}) + 16 * q);
      *reinterpret_cast<uint4*>(s_win + r * kWinStride + 16 * q) =
          load16(src, img, hi);
    }
  }
  __syncthreads();
  const hs::Affine a = s_affine;
  if (win.fits) {
    row[t] = hs::sample_word<kBand>(
        StagedFetch{s_win, win.y0, win.x0, static_cast<uint32_t>(a0),
                    static_cast<uint32_t>(w)},
        frame, a, 4 * t);
  } else {
    row[t] = hs::sample_word<kBand>(hs::GlobalFetch{img, w}, frame, a,
                                    4 * t);
  }
}

// hs::keypoint_trig of each keypoint: the test entry of the device trig.
__global__ void trig_kernel(const float* __restrict__ ksize,
                            const float* __restrict__ kangle, int n,
                            float scale, float* __restrict__ s,
                            float* __restrict__ c, float* __restrict__ sn) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= n) return;
  const hs::Trig t = hs::keypoint_trig(ksize[i], kangle[i], scale);
  s[i] = t.s;
  c[i] = t.c;
  sn[i] = t.sn;
}

}  // namespace

extern "C" int eff_warp_patches(const uint8_t* img, int h, int w, int oy,
                                int ox, int frame_h, int frame_w,
                                const float* kx, const float* ky,
                                const float* size, const float* angle,
                                const uint8_t* valid, int n, float scale,
                                uint8_t* out, void* stream) {
  if (h < 1 || w < 1 || n < 1 || frame_h < 1 || frame_w < 1)
    return cudaErrorInvalidValue;
  const hs::Frame frame{oy, ox, frame_h, frame_w, h, w};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (oy != 0 || ox != 0 || frame_h != h || frame_w != w)
    warp_kernel<true><<<n, kThreads, 0, st>>>(img, h, w, kx, ky, size, angle,
                                              valid, n, scale, frame, out);
  else
    warp_kernel<false><<<n, kThreads, 0, st>>>(img, h, w, kx, ky, size,
                                               angle, valid, n, scale, frame,
                                               out);
  return cudaGetLastError();
}

extern "C" int eff_keypoint_trig(const float* size, const float* angle, int n,
                                 float scale, float* s, float* c, float* sn,
                                 void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  trig_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(size, angle, n, scale, s,
                                                     c, sn);
  return cudaGetLastError();
}
