// K8: fused FAST-9 + Harris, dense output without NMS.
//
// Replaces the TPU kernel `_fast_harris_kernel`
// (efficient_features_tpu/ops/pallas_kernels.py:96, launched by
// `fast_harris` :197).  Output is exactly (h, w) f32: the Harris response at
// border-valid FAST corners, -inf elsewhere.  The caller masks it and runs
// the disc NMS (K9): the route of a masked nonmax_radius < 10.
//
// What bounds it on the H100: device memory, 1 B read and 4 B written per
// pixel, and FAST's 48 integer operations per pixel; Harris runs only at
// the corners, one corner per thread.
//
// Design: `fast_harris_kernel` of detect_common.cuh without a mask, one
// 256-thread block per 32x64 tile.  The cells kernel (K1) launches the same
// kernel with its mask as its first pass.
#include "detect_common.cuh"

extern "C" int eff_fast_harris(const uint8_t* img, int h, int w, int threshold,
                               float harris_s2, float* out, void* stream) {
  if (h < 1 || w < 1) return cudaErrorInvalidValue;
  return launch_fast_harris(img, nullptr, h, w, threshold, harris_s2, out,
                            static_cast<cudaStream_t>(stream));
}
