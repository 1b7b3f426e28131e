// K9: disc NMS of a -inf-masked response map, any radius.
//
// Replaces the TPU kernel `_nms_kernel`
// (efficient_features_tpu/ops/pallas_kernels.py:241, launched by
// `radius_nms` :297).  Output is exactly (h, w) bool:
// center != -inf && center >= max over the open disc (ties co-survive;
// pallas_kernels.py:293).  Unlike the TPU kernel (radius <= 128) the radius
// has no upper limit.  The input is a finite map with -inf where there is
// no corner, as K8 writes it and as the ROI mask leaves it
// (pipeline.py, radius < 10 with a mask): only a corner can survive, and
// only a corner can suppress.
//
// What bounds it on the H100: device memory for the 4 B read and 1 B
// written per pixel, and, at large radii, the disc scans of the corners.
//
// Design: one C entry, one launch, two kernels by radius.
//   - Radius 1..EFF_STAGED_MAX_RADIUS (9), the route's radii:
//     `radius_nms_kernel` runs K7's staged NMS (`nms_stage_tile`,
//     detect_common.cuh): a block per 32x64 tile stages the tile plus its
//     R = radius - 1 ring, keeps each staged row's corners as a bit mask
//     and tests each corner of the tile against the corners of its disc
//     only.  Then it writes the tile as words of 4 columns: each output row
//     is cut into aligned words from its own first column -3 .. 0
//     (`row_first_column`, u8_rows.cuh; the rows of a width that is no
//     multiple of 4 start at any byte), 17 words of a tile row, the bytes
//     outside the tile not stored.
//   - Radius >= 10, which no route reaches since every radius >= 10 takes
//     K1: `radius_nms_scan_kernel`, one thread per pixel.  A -inf pixel
//     (most of them) stores false at once.  A corner scans the disc
//     straight from global memory (the map stays in L1/L2), rows in the
//     order dy = 0, -1, 1, -2, 2, ... since a larger neighbour is most
//     likely near, and stops at the first larger value.
// The disc's half-widths come from a device table built from
// semantics.disc_row_extents (entry i for dy = i - R).
#include "detect_common.cuh"
#include "u8_rows.cuh"

namespace {

constexpr int kRowWordsOut = kTileW / 4 + 1;   // words touching a tile row

__global__ void __launch_bounds__(kThreads)
radius_nms_kernel(const float* __restrict__ resp, int h, int w, int R,
                  const int32_t* __restrict__ disc_wdx,
                  uint8_t* __restrict__ out) {
  __shared__ NmsStage st;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  nms_stage_tile(resp, h, w, R, disc_wdx, y0, x0, st);

  // 3. the bool tile, a word of 4 columns per thread and step
  const int hi = min(x0 + kTileW, w);
  for (int i = threadIdx.x; i < kTileH * kRowWordsOut; i += kThreads) {
    const int ty = i / kRowWordsOut, k = i - ty * kRowWordsOut;
    if (y0 + ty >= h) return;
    uint8_t* row = out + static_cast<size_t>(y0 + ty) * w;
    const int c = row_first_column(row) + x0 + 4 * k;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j >= x0 && c + j < hi)
        word |= static_cast<uint32_t>(st.keep[ty * kTileW + c + j - x0])
                << (8 * j);
    store_u8x4(row, c, x0, hi, word);
  }
}

constexpr int kScanX = 64;
constexpr int kScanY = 4;

__global__ void __launch_bounds__(kScanX * kScanY)
radius_nms_scan_kernel(const float* __restrict__ resp, int h, int w, int R,
                       const int32_t* __restrict__ wdx,
                       uint8_t* __restrict__ out) {
  const int x = blockIdx.x * kScanX + threadIdx.x;
  const int y = blockIdx.y * kScanY + threadIdx.y;
  if (x >= w || y >= h) return;
  const float v = resp[static_cast<size_t>(y) * w + x];
  bool keep = v != neg_inf();
  for (int k = 0; k <= 2 * R && keep; ++k) {
    const int dy = (k & 1) ? -((k + 1) >> 1) : (k >> 1);
    const int yy = y + dy;
    if (yy < 0 || yy >= h) continue;
    const int wd = wdx[dy + R];
    const int xa = max(x - wd, 0), xb = min(x + wd, w - 1);
    const float* row = resp + static_cast<size_t>(yy) * w;
    for (int xx = xa; xx <= xb; ++xx) {
      if (row[xx] > v) {
        keep = false;
        break;
      }
    }
  }
  out[static_cast<size_t>(y) * w + x] = keep ? 1 : 0;
}

}  // namespace

extern "C" int eff_radius_nms(const float* resp, int h, int w, int radius,
                              const int32_t* disc_wdx, uint8_t* out,
                              void* stream) {
  if (radius < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (radius <= EFF_STAGED_MAX_RADIUS) {
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
    radius_nms_kernel<<<grid, kThreads, 0, s>>>(resp, h, w, radius - 1,
                                                disc_wdx, out);
  } else {
    const dim3 grid((w + kScanX - 1) / kScanX, (h + kScanY - 1) / kScanY);
    radius_nms_scan_kernel<<<grid, dim3(kScanX, kScanY), 0, s>>>(
        resp, h, w, radius - 1, disc_wdx, out);
  }
  return cudaGetLastError();
}
