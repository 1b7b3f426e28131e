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
// v = sn*px + c*py + m12 (c = cos*s, sn = sin*s).  The sample is valid when
// its 2x2 support lies in the image; it is then the reference's full-f32
// lerp of the four pixels, rounded as min(trunc(t + 0.5), 255); else 0.
// m02/m12 are rebuilt here from c and sn (window_kernels.py:183-189): an
// m02 computed apart from c can be one ulp off and break the exact u = 0
// sample of a keypoint on the image corner.
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

namespace {

constexpr int kThreads = 256;  // 1024 samples / 4 per thread

__global__ void __launch_bounds__(kThreads)
warp_kernel(const uint8_t* __restrict__ img, int h, int w,
            const float* __restrict__ kx, const float* __restrict__ ky,
            const float* __restrict__ cos_s, const float* __restrict__ sin_s,
            const uint8_t* __restrict__ valid, uint8_t* __restrict__ out) {
  const int k = blockIdx.x;
  uint32_t* row = reinterpret_cast<uint32_t*>(out + static_cast<size_t>(k)
                                              * 1024);
  if (!valid[k]) {
    row[threadIdx.x] = 0;
    return;
  }
  const float x = kx[k], y = ky[k], c = cos_s[k], sn = sin_s[k];
  const float m02 = __fadd_rn(__fmul_rn(__fadd_rn(-c, sn), 16.0f), x);
  const float m12 = __fadd_rn(__fmul_rn(__fsub_rn(-sn, c), 16.0f), y);
  const int p0 = threadIdx.x * 4;
  const float py = static_cast<float>(p0 / 32);
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float px = static_cast<float>(p0 % 32 + j);
    const float u = __fadd_rn(__fsub_rn(__fmul_rn(c, px), __fmul_rn(sn, py)),
                              m02);
    const float v = __fadd_rn(__fadd_rn(__fmul_rn(sn, px), __fmul_rn(c, py)),
                              m12);
    const float uf = floorf(u), vf = floorf(v);
    // the range test on the float floors keeps a far-off sample from
    // overflowing the int conversion
    if (uf >= 0.0f && uf < static_cast<float>(w - 1) && vf >= 0.0f
        && vf < static_cast<float>(h - 1)) {
      const int ui = static_cast<int>(uf), vi = static_cast<int>(vf);
      const float du = __fsub_rn(u, uf), dv = __fsub_rn(v, vf);
      const uint8_t* p = img + static_cast<size_t>(vi) * w + ui;
      const float p00 = __ldg(p), p01 = __ldg(p + 1);
      const float p10 = __ldg(p + w), p11 = __ldg(p + w + 1);
      const float h0 = __fsub_rn(1.0f, du);
      const float z_top = __fadd_rn(__fmul_rn(h0, p00), __fmul_rn(du, p01));
      const float z_bot = __fadd_rn(__fmul_rn(h0, p10), __fmul_rn(du, p11));
      const float t2 = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, dv), z_top),
                                 __fmul_rn(dv, z_bot));
      const float val = fminf(truncf(__fadd_rn(t2, 0.5f)), 255.0f);
      word |= static_cast<uint32_t>(val) << (8 * j);
    }
  }
  row[threadIdx.x] = word;
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
