// K4: HashSIFT patch warp, 32x32 bilinear samples under the keypoint affine.
//
// Replaces the TPU kernels `_warp_kernel`
// (efficient_features_tpu/ops/window_kernels.py:1034, launched by
// `_warp_patches_windows_impl` :1238) and `_warp_kernel_big` (:1741,
// launched by `_warp_patches_windows_big_impl` :1850), and the XLA gather
// path that takes keypoints above `_S_CAP` (ops/hash_sift.warp_patches).
// The TPU splits keypoints by size because each kernel DMAs a fixed window
// around its keypoints; this kernel reads pixels straight from the image, so
// one kernel takes keypoints of any size.
//
// Per sample (px, py) of keypoint k: u = c*px - sn*py + m02,
// v = sn*px + c*py + m12 (c = cos*s, sn = sin*s), then the reference's
// full-f32 lerp of the 2x2 support, or 0 where it leaves the image.  The
// per-sample code is `hs::sample_word` in hs_common.cuh, which the fused
// kernel K11 (hs_desc.cu) compiles too.
//
// What bounds it on the H100: 4 scattered u8 reads per sample, 4096 per
// keypoint, and the 1 KB output row.  The reads of one keypoint fall in a
// (45*s)^2 px neighbourhood, so they hit L1/L2 (a 4K level is 8 MB and
// stays in the 50 MB L2); the output write is the only DRAM traffic that
// scales with the keypoints, 41 MB at 40000.
//
// Design: one 256-thread block per keypoint, 4 consecutive samples of one
// patch row per thread, stored as one 32-bit word, so a row is written by
// 256 coalesced stores.  Invalid slots write a zero row.  Build with
// -fmad=false: every product and sum rounds on its own, as in the plain
// version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"
#include "hs_common.cuh"

namespace {

constexpr int kThreads = hs::kPatchPixels / 4;  // 4 samples per thread

__global__ void __launch_bounds__(kThreads)
warp_kernel(const uint8_t* __restrict__ img, int h, int w,
            const float* __restrict__ kx, const float* __restrict__ ky,
            const float* __restrict__ cos_s, const float* __restrict__ sin_s,
            const uint8_t* __restrict__ valid, uint8_t* __restrict__ out) {
  const int k = blockIdx.x;
  uint32_t* row = reinterpret_cast<uint32_t*>(
      out + static_cast<size_t>(k) * hs::kPatchPixels);
  if (!valid[k]) {
    row[threadIdx.x] = 0;
    return;
  }
  const hs::Affine a = hs::keypoint_affine(kx[k], ky[k], cos_s[k], sin_s[k]);
  row[threadIdx.x] = hs::sample_word(img, h, w, a, threadIdx.x * 4);
}

}  // namespace

extern "C" int eff_warp_patches(const uint8_t* img, int h, int w,
                                const float* kx, const float* ky,
                                const float* cos_s, const float* sin_s,
                                const uint8_t* valid, int n, uint8_t* out,
                                void* stream) {
  if (h < 1 || w < 1 || n < 1) return cudaErrorInvalidValue;
  warp_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, h, w, kx, ky, cos_s, sin_s, valid, out);
  return cudaGetLastError();
}
