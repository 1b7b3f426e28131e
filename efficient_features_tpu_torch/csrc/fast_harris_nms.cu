// K7: FAST-9 + Harris + disc NMS with a dense output.
//
// Replaces the TPU kernel `_fast_harris_nms_kernel`
// (efficient_features_tpu/ops/pallas_kernels.py:419, launched by
// `fast_harris_nms` :501), the detect kernel of nonmax_radius < 10 without a
// mask.  Output is exactly (h, w) f32: the Harris response where a
// border-valid FAST corner survives the disc NMS (ties co-survive), -inf
// elsewhere.
//
// What bounds it on the H100: device memory, 1 B read and 4 B written per
// pixel, and FAST's 48 integer operations per pixel.  Harris and the disc
// test belong to the corners, a few percent of the pixels: only a corner
// can survive, and only a corner can suppress.
//
// Design: two kernels per call, as K1, with a dense output.
//   1. `fast_harris_kernel` (detect_common.cuh, K8's kernel, no mask): FAST
//      and the border once per pixel, Harris once per corner, into a dense
//      f32 response map (scratch of the wrapper; written once, read back
//      through L2).
//   2. `nms_dense_kernel`: the staged disc NMS that K9 shares
//      (`nms_stage_tile`, detect_common.cuh): a 256-thread block per 32x64
//      tile stages its tile of the map plus the R = radius - 1 ring
//      (R <= 8), keeps each staged row's corners as a bit mask and tests
//      each corner of the tile against the corners of its disc only.  Then
//      each thread writes 8 rows of one column of the dense tile.
#include "detect_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
nms_dense_kernel(const float* __restrict__ resp, int h, int w, int R,
                 const int32_t* __restrict__ disc_wdx,
                 float* __restrict__ out) {
  __shared__ NmsStage st;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  nms_stage_tile(resp, h, w, R, disc_wdx, y0, x0, st);

  // 3. the dense tile: 8 rows of one column per thread, so for each row a
  //    warp stores 32 consecutive floats
  const int cr = threadIdx.x / kTileW, cc = threadIdx.x % kTileW;
  const int x = x0 + cc;
  if (x >= w) return;
  for (int k = 0; k < 8; ++k) {
    const int ty = cr * 8 + k;
    if (y0 + ty >= h) return;
    const int p = ty * kTileW + cc;
    out[static_cast<size_t>(y0 + ty) * w + x] =
        st.keep[p] ? st.val[(ty + R) * kNmsRegW + cc + R] : neg_inf();
  }
}

}  // namespace

extern "C" int eff_fast_harris_nms(const uint8_t* img, int h, int w,
                                   int threshold, int radius,
                                   const int32_t* disc_wdx, float harris_s2,
                                   float* resp, float* out, void* stream) {
  if (radius < 1 || radius > EFF_STAGED_MAX_RADIUS || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch_fast_harris(img, nullptr, h, w, threshold, harris_s2, resp, s);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  nms_dense_kernel<<<grid, kThreads, 0, s>>>(resp, h, w, radius - 1,
                                             disc_wdx, out);
  return cudaGetLastError();
}
