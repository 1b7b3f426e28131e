// K1: fused FAST-9 + Harris + disc NMS with cell-reduced output.
//
// Replaces the TPU kernel `_fast_harris_nms_reduced_kernel`
// (efficient_features_tpu/ops/pallas_kernels.py:648, launched by
// `fast_harris_nms_cells` :765).  Semantics, per pixel: FAST-9 segment test
// (two-mask rotate-AND chain), exact-int Sobel and 7x7 structure-tensor
// sums, Harris response with truncated mantissas and k = 3/64 (every float
// product exact), the 15 px border, an optional ROI mask, and disc NMS
// where ties co-survive.
// Each 8-row x 1-col cell is then reduced to (max survivor response, lowest
// global row of a maximal survivor, survivor count); dead cells hold
// (-inf, INT32_MAX, 0).  Output is exactly (ceil(h/8), w).
//
// What bounds it on the H100: the disc NMS.  A survivor check reads up to
// (2R+1)^2 ~ 700 shared-memory responses at radius 15, and the Harris box
// sums read 98 int16 gradients per corner.  Global traffic is small: one
// u8 read per pixel (plus halo) and 12 bytes per 8 pixels written.
//
// Design (detect_common.cuh): one 256-thread block per 32x64 output tile
// stages the masked response of the tile plus its R = radius - 1 ring in
// shared memory, so no response ever goes to device memory.  The optional
// ROI mask (NULL for none) is read per response pixel and gates the whole
// ring, as the TPU kernel ANDs it into `inb` over its extended region
// (pallas_kernels.py:735-740): a masked-out corner neither survives nor
// suppresses.  Each survivor check stops at the first larger neighbour; most
// pixels are not corners, so it is short.  Each thread then owns one cell
// (4 cell rows x 64 columns = 256 cells).
#include "detect_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
cells_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ mask,
             int h, int w, int threshold, int R, DiscTable disc, float s2,
             float* __restrict__ cellmax, int32_t* __restrict__ cellrow,
             int32_t* __restrict__ cellcnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Stage st = stage_layout(smem, R);
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  stage_masked_response(img, mask, h, w, threshold, R, s2, y0, x0, st);

  // one cell per thread: disc NMS of its 8 pixels, then the reduction
  const int cr = threadIdx.x / kTileW, cc = threadIdx.x % kTileW;
  const int cell_y = blockIdx.y * (kTileH / 8) + cr;
  const int x = x0 + cc;
  if (cell_y >= (h + 7) / 8 || x >= w) return;
  float best = neg_inf();
  int best_row = 2147483647;
  int count = 0;
  for (int k = 0; k < 8; ++k) {
    const int ty = cr * 8 + k;
    const float* center = st.resp + (ty + R) * st.ew + (cc + R);
    const float v = *center;
    if (v == neg_inf() || !survives(center, v, st.ew, R, disc)) continue;
    ++count;
    if (v > best) {  // rows ascend: the first maximal survivor is the lowest
      best = v;
      best_row = y0 + ty;
    }
  }
  const size_t o = static_cast<size_t>(cell_y) * w + x;
  cellmax[o] = best;
  cellrow[o] = best_row;
  cellcnt[o] = count;
}

}  // namespace

extern "C" int eff_fast_harris_nms_cells(const uint8_t* img,
                                         const uint8_t* mask, int h, int w,
                                         int threshold, int radius,
                                         const int32_t* disc_wdx,
                                         float harris_s2, float* cellmax,
                                         int32_t* cellrow, int32_t* cellcnt,
                                         void* stream) {
  if (radius < 1 || radius > EFF_CELLS_MAX_RADIUS || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  const int R = radius - 1;
  DiscTable disc;
  size_t smem;
  const cudaError_t err = prepare(cells_kernel, R, disc_wdx, &disc, &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  cells_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      img, mask, h, w, threshold, R, disc, harris_s2, cellmax, cellrow,
      cellcnt);
  return cudaGetLastError();
}
