// K7: fused FAST-9 + Harris + disc NMS with a dense output.
//
// Replaces the TPU kernel `_fast_harris_nms_kernel`
// (efficient_features_tpu/ops/pallas_kernels.py:419, launched by
// `fast_harris_nms` :501), the detect kernel of nonmax_radius < 10 without a
// mask.  Output is exactly (h, w) f32: the Harris response where a
// border-valid FAST corner survives the disc NMS (ties co-survive), -inf
// elsewhere.
//
// What bounds it on the H100: device memory, 1 B read and 4 B written per
// pixel; at radius <= 9 the disc holds at most 253 pixels and a survivor
// check stops at the first larger one, so the shared-memory reads stay short.
//
// Design: the staging of detect_common.cuh, one 256-thread block per 32x64
// tile with the response of the tile plus its R = radius - 1 ring in shared
// memory (Harris at the compacted corners only), beside the disc's
// half-widths, copied from a device table (as an 18-entry kernel argument
// passed by value the same table made the kernel 18-20% slower on the
// H100).  Then the disc test per pixel.  Each thread owns 8 rows of one
// column, so for each row a warp stores 32 consecutive floats.  The ring
// costs (32 + 2R)(64 + 2R) / 2048 of the tile's work, 1.9x at radius 9
// (EFF_STAGED_MAX_RADIUS): the plan of a small radius, which is all this
// route serves.
#include "detect_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
fast_harris_nms_kernel(const uint8_t* __restrict__ img, int h, int w,
                       int threshold, int R,
                       const int32_t* __restrict__ disc_wdx, float s2,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_wdx[2 * EFF_STAGED_MAX_RADIUS - 1];
  if (threadIdx.x < 2 * R + 1) s_wdx[threadIdx.x] = disc_wdx[threadIdx.x];
  const Stage st = stage_layout(smem, R);
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  stage_masked_response(img, nullptr, h, w, threshold, R, s2, y0, x0, st);

  const int cr = threadIdx.x / kTileW, cc = threadIdx.x % kTileW;
  const int x = x0 + cc;
  if (x >= w) return;
  for (int k = 0; k < 8; ++k) {
    const int ty = cr * 8 + k;
    if (y0 + ty >= h) return;
    const float* center = st.resp + (ty + R) * st.ew + (cc + R);
    const float v = *center;
    const bool keep = v != neg_inf() && survives(center, v, st.ew, R, s_wdx);
    out[static_cast<size_t>(y0 + ty) * w + x] = keep ? v : neg_inf();
  }
}

}  // namespace

extern "C" int eff_fast_harris_nms(const uint8_t* img, int h, int w,
                                   int threshold, int radius,
                                   const int32_t* disc_wdx, float harris_s2,
                                   float* out, void* stream) {
  if (radius < 1 || radius > EFF_STAGED_MAX_RADIUS || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  const int R = radius - 1;
  size_t smem;
  const cudaError_t err = prepare(fast_harris_nms_kernel, R, &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  fast_harris_nms_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      img, h, w, threshold, R, disc_wdx, harris_s2, out);
  return cudaGetLastError();
}
