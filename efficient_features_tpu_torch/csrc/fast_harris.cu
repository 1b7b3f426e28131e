// K8: fused FAST-9 + Harris, dense output without NMS.
//
// Replaces the TPU kernel `_fast_harris_kernel`
// (efficient_features_tpu/ops/pallas_kernels.py:96, launched by
// `fast_harris` :197).  Output is exactly (h, w) f32: the Harris response at
// border-valid FAST corners, -inf elsewhere.  The caller masks it and runs
// the disc NMS (K9): the route of a masked nonmax_radius < 10 and of
// nonmax_radius above the staged kernels' shared-memory plan.
//
// What bounds it on the H100: device memory, 1 B read and 4 B written per
// pixel; the Harris box sums (98 int16 shared-memory reads) run only at
// FAST corners inside the border.
//
// Design: K1's staging (detect_common.cuh) with no NMS ring (R = 0), one
// 256-thread block per 32x64 tile; each thread stores 8 rows of one column,
// so for each row a warp stores 32 consecutive floats.
#include "detect_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
fast_harris_kernel(const uint8_t* __restrict__ img, int h, int w,
                   int threshold, float s2, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Stage st = stage_layout(smem, 0);
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  stage_masked_response(img, nullptr, h, w, threshold, 0, s2, y0, x0, st);

  const int cr = threadIdx.x / kTileW, cc = threadIdx.x % kTileW;
  const int x = x0 + cc;
  if (x >= w) return;
  for (int k = 0; k < 8; ++k) {
    const int ty = cr * 8 + k;
    if (y0 + ty >= h) return;
    out[static_cast<size_t>(y0 + ty) * w + x] = st.resp[ty * st.ew + cc];
  }
}

}  // namespace

extern "C" int eff_fast_harris(const uint8_t* img, int h, int w,
                               int threshold, float harris_s2, float* out,
                               void* stream) {
  if (h < 1 || w < 1) return cudaErrorInvalidValue;
  DiscTable disc;
  size_t smem;
  const cudaError_t err =
      prepare(fast_harris_kernel, 0, nullptr, &disc, &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  fast_harris_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      img, h, w, threshold, harris_s2, out);
  return cudaGetLastError();
}
