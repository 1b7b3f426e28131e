// K2: intensity-centroid moments and the IC angle.
//
// Replaces the TPU kernel `_ic_kernel`
// (efficient_features_tpu/ops/window_kernels.py:861, launched by
// `_ic_angles_windows_impl` :934) and the XLA angle step after it.  For
// each keypoint it sums m01 = sum v*dy and m10 = sum v*dx over the
// radius-15 U_MAX disc, as exact int32 (|m| < 2^21), reads clamping to the
// image like the plain version (ops/orientation.ic_moments), and writes
// either the moments or the angle in degrees of
// ops/orientation.angles_from_moments, op by op: atan2f of the moments as
// float, + f32(2 pi) where negative, * f32(180 / pi), 0 for an invalid
// slot.  atan2f is the CUDA math library's, as torch.atan2 on a CUDA
// tensor.
//
// What bounds it on the H100: the loads, 31 rows of 31 bytes a keypoint
// (the arithmetic is a multiply-add per pixel and moment).  The first
// design walked the rows with one byte load per lane and row, each load
// waiting for the one before, and ran for invalid slots too.
//
// Design: one warp per keypoint, 8 keypoints per block.  An invalid slot
// writes its 0 and reads nothing.  A keypoint whose disc rows lie in the
// image (every detector keypoint: they lie >= 15 px inside) is read as
// aligned 8-byte words, eight lanes a row (five of them loading), so four
// rows per load instruction and all 31 rows' loads in flight before the
// first sum; each lane adds the bytes of its words that lie in the disc,
// and the two sums finish with __shfl_xor_sync.  The sums are exact
// integers, so their order does not matter.  A keypoint nearer the border
// takes the clamped reads of the first design, a lane per column.  The
// TPU kernel's window DMA plan, keypoint sorting and bf16 one-hot matmuls
// are not needed.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRadius = 15;     // HALF_PATCH_SIZE
constexpr int kRowGroups = 8;   // 4 rows each: 32 >= 2 * kRadius + 1
constexpr int kWordsPerRow = 5; // aligned 8-byte words over 31 bytes
// U_MAX (semantics.py) for |dy| = 0..15, 4 bits each
constexpr uint64_t kUMax = 0x3689ABCDDEEEFFFFull;
constexpr float kTwoPi = 6.28318530717958647692f;    // ops/orientation
constexpr float kRad2Deg = 57.2957795130823208768f;  // _TWO_PI, _RAD2DEG

__device__ __forceinline__ int umax(int dy) {
  return static_cast<int>((kUMax >> (4 * (dy < 0 ? -dy : dy))) & 15u);
}

// ops/orientation.angles_from_moments of one valid keypoint.
__device__ __forceinline__ float ic_angle(int m01, int m10) {
  const float a = atan2f(__int2float_rn(m01), __int2float_rn(m10));
  return __fmul_rn(kRad2Deg, a < 0.0f ? __fadd_rn(a, kTwoPi) : a);
}

// Moments of an interior keypoint (every disc row in the image and its
// aligned words inside the image's bytes [lo, hi)).
__device__ __forceinline__ void interior_moments(const uint8_t* img, int w,
                                                 int y, int x, int lane,
                                                 int& m01, int& m10) {
  const int g = lane / 8, q = lane % 8;
  uint2 word[kRowGroups];
  int lead[kRowGroups];
#pragma unroll
  for (int i = 0; i < kRowGroups; ++i) {
    const int dy = 4 * i + g - kRadius;
    const uint8_t* first =
        img + static_cast<size_t>(y + dy) * w + (x - kRadius);
    lead[i] = static_cast<int>(reinterpret_cast<uintptr_t>(first) & 7u);
    word[i] = make_uint2(0u, 0u);
    if (dy <= kRadius && q < kWordsPerRow)
      word[i] = __ldg(reinterpret_cast<const uint2*>(first - lead[i]) + q);
  }
#pragma unroll
  for (int i = 0; i < kRowGroups; ++i) {
    const int dy = 4 * i + g - kRadius;
    const int u = dy <= kRadius ? umax(dy) : -1;   // row 16: no pixel
    // column of byte 0 of this lane's word, relative to x
    const int dx0 = 8 * q - lead[i] - kRadius;
    int sum = 0, wsum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int v = (j < 4 ? word[i].x >> (8 * j) : word[i].y >> (8 * j - 32))
                    & 0xff;
      const int dx = dx0 + j;
      const bool in = dx >= -u && dx <= u;
      sum += in ? v : 0;
      wsum += in ? v * dx : 0;
    }
    m01 += sum * dy;
    m10 += wsum;
  }
}

// Moments with every read clamped to the image, a lane per column.
__device__ __forceinline__ void clamped_moments(const uint8_t* img, int h,
                                                int w, int y, int x, int lane,
                                                int& m01, int& m10) {
  const int dx = lane - kRadius;
  const int gx = min(max(x + dx, 0), w - 1);
  for (int dy = -kRadius; dy <= kRadius; ++dy) {
    const int u = umax(dy);
    if (dx >= -u && dx <= u) {
      const int gy = min(max(y + dy, 0), h - 1);
      const int v = __ldg(img + static_cast<size_t>(gy) * w + gx);
      m01 += v * dy;
      m10 += v * dx;
    }
  }
}

// valid NULL: every slot valid.  moments (n, 2) and angles (n,), each
// written where not NULL.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ic_kernel(const uint8_t* __restrict__ img, int h, int w,
          const int32_t* __restrict__ ys, const int32_t* __restrict__ xs,
          const uint8_t* __restrict__ valid, int n,
          int32_t* __restrict__ moments, float* __restrict__ angles) {
  const int k = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (k >= n) return;  // uniform per warp
  const int lane = threadIdx.x % 32;
  if (valid != nullptr && !valid[k]) {
    if (lane == 0) {
      if (angles != nullptr) angles[k] = 0.0f;
      if (moments != nullptr) moments[2 * k] = moments[2 * k + 1] = 0;
    }
    return;
  }
  const int y = ys[k], x = xs[k];
  int m01 = 0, m10 = 0;
  bool interior = y >= kRadius && y + kRadius < h && x >= kRadius
                  && x + kRadius < w;
  if (interior) {   // the aligned words lie inside the image's bytes too
    const uint8_t* lo = img + static_cast<size_t>(y - kRadius) * w
                        + (x - kRadius);
    const uint8_t* hi = img + static_cast<size_t>(y + kRadius) * w
                        + (x - kRadius);
    const uint8_t* first = reinterpret_cast<const uint8_t*>(
        reinterpret_cast<uintptr_t>(lo) & ~uintptr_t{7});
    const uint8_t* last = reinterpret_cast<const uint8_t*>(
        reinterpret_cast<uintptr_t>(hi) & ~uintptr_t{7}) + 8 * kWordsPerRow;
    interior = first >= img && last <= img + static_cast<size_t>(h) * w;
  }
  if (interior)
    interior_moments(img, w, y, x, lane, m01, m10);
  else
    clamped_moments(img, h, w, y, x, lane, m01, m10);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m01 += __shfl_xor_sync(0xffffffffu, m01, off);
    m10 += __shfl_xor_sync(0xffffffffu, m10, off);
  }
  if (lane == 0) {
    if (moments != nullptr) {
      moments[2 * k] = m01;
      moments[2 * k + 1] = m10;
    }
    if (angles != nullptr) angles[k] = ic_angle(m01, m10);
  }
}

// The angle step alone: the test entry of `ic_angle`.
__global__ void angle_kernel(const int32_t* __restrict__ moments, int n,
                             float* __restrict__ angles) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i < n) angles[i] = ic_angle(moments[2 * i], moments[2 * i + 1]);
}

}  // namespace

extern "C" int eff_ic_moments(const uint8_t* img, int h, int w,
                              const int32_t* ys, const int32_t* xs,
                              const uint8_t* valid, int n, int32_t* moments,
                              float* angles, void* stream) {
  if (h < 1 || w < 1 || n < 1) return cudaErrorInvalidValue;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ic_kernel<<<blocks, kWarpsPerBlock * 32, 0,
              static_cast<cudaStream_t>(stream)>>>(img, h, w, ys, xs, valid,
                                                   n, moments, angles);
  return cudaGetLastError();
}

extern "C" int eff_ic_angles_from_moments(const int32_t* moments, int n,
                                          float* angles, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  angle_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(moments, n, angles);
  return cudaGetLastError();
}

extern "C" const char* eff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
