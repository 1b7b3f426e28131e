// K9: disc NMS of a -inf-masked response map, any radius.
//
// Replaces the TPU kernel `_nms_kernel`
// (efficient_features_tpu/ops/pallas_kernels.py:241, launched by
// `radius_nms` :297).  Output is exactly (h, w) bool:
// center != -inf && center >= max over the open disc (ties co-survive;
// pallas_kernels.py:293).  Unlike the TPU kernel (radius <= 128) the radius
// has no upper limit.
//
// What bounds it on the H100: device memory for the 4 B read and 1 B
// written per pixel, and, at large radii, the disc scans of the corners.
//
// Design: one thread per pixel.  A -inf pixel (most of them) stores false
// at once.  A corner scans the disc straight from global memory (the map
// stays in L1/L2), rows in the order dy = 0, -1, 1, -2, 2, ... since a
// larger neighbour is most likely near, and stops at the first larger value.
// The disc's half-widths come from a device table built from
// semantics.disc_row_extents (entry i for dy = i - R).
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"

namespace {

constexpr int kBlockX = 64;
constexpr int kBlockY = 4;

__global__ void __launch_bounds__(kBlockX * kBlockY)
radius_nms_kernel(const float* __restrict__ resp, int h, int w, int R,
                  const int32_t* __restrict__ wdx, uint8_t* __restrict__ out) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const float v = resp[static_cast<size_t>(y) * w + x];
  bool keep = v != __int_as_float(0xff800000);
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
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  radius_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      resp, h, w, radius - 1, disc_wdx, out);
  return cudaGetLastError();
}
