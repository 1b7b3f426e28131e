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
//   2. `nms_dense_kernel`: a 256-thread block per 32x64 tile reads its tile
//      of the map plus the R = radius - 1 ring (R <= 8) into shared memory,
//      keeps the corners of each staged row as a bit mask, and compacts the
//      tile's corners into a list.  A thread per listed corner then tests
//      it against the corners of its disc only: for each disc row (dy = 0,
//      -1, 1, -2, ..., since a larger neighbour is most likely near) it cuts
//      the row's mask to the disc's columns and compares the response of
//      each set bit, stopping at the first larger one.  Its work is a
//      funnel shift per disc row and a compare per corner in the disc, not
//      a load per disc pixel, and no lane walks a disc while the rest of its
//      warp waits on non-corners.  Then each thread writes 8 rows of one
//      column of the dense tile.  The map itself is never changed: a
//      suppressed corner still suppresses.
// The disc's half-widths come from a device table (entry i for dy = i - R,
// semantics.disc_row_extents), copied to shared memory.
#include "detect_common.cuh"

namespace {

constexpr int kMaxReach = EFF_STAGED_MAX_RADIUS - 1;
constexpr int kRegH = kTileH + 2 * kMaxReach;    // staged rows, at most
constexpr int kRegW = kTileW + 2 * kMaxReach;    // row stride of s_val
constexpr int kMaskWords = 4;    // 3 words hold kRegW bits, the 4th is zero

__global__ void __launch_bounds__(kThreads)
nms_dense_kernel(const float* __restrict__ resp, int h, int w, int R,
                 const int32_t* __restrict__ disc_wdx,
                 float* __restrict__ out) {
  __shared__ float s_val[kRegH * kRegW];            // the tile + ring
  __shared__ uint32_t s_bits[kRegH * kMaskWords];   // its corners, per row
  __shared__ uint16_t s_list[kTileH * kTileW];      // the tile's corners
  __shared__ uint8_t s_keep[kTileH * kTileW];
  __shared__ int s_wdx[2 * kMaxReach + 1];
  __shared__ int s_count;
  const int eh = kTileH + 2 * R, ew = kTileW + 2 * R;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_count = 0;
  if (threadIdx.x < 2 * R + 1) s_wdx[threadIdx.x] = disc_wdx[threadIdx.x];
  for (int p = threadIdx.x; p < kTileH * kTileW; p += kThreads) s_keep[p] = 0;
  __syncthreads();

  // 1. the tile + ring, a warp per staged row, every row's loads in flight
  //    at once; -inf outside the image
#pragma unroll
  for (int j = 0; j < kRegH / (kThreads / 32); ++j) {
    const int r = warp + j * (kThreads / 32);
    const int gy = y0 - R + r;
    const bool row_in = r < eh && gy >= 0 && gy < h;
#pragma unroll
    for (int word = 0; word < kMaskWords - 1; ++word) {
      const int c = word * 32 + lane;
      const int gx = x0 - R + c;
      float v = neg_inf();
      if (row_in && c < ew && gx >= 0 && gx < w)
        v = resp[static_cast<size_t>(gy) * w + gx];
      if (r < eh && c < ew) s_val[r * kRegW + c] = v;
    }
  }
  __syncthreads();
  // each staged row's corners as a bit mask, the tile's corners to the list
  for (int r = warp; r < eh; r += kThreads / 32) {
    for (int word = 0; word < kMaskWords; ++word) {
      const int c = word * 32 + lane;
      const bool corner = c < ew && s_val[r * kRegW + c] != neg_inf();
      const unsigned m = __ballot_sync(kFullWarp, corner);
      if (lane == 0) s_bits[r * kMaskWords + word] = m;
      const int ty = r - R, tx = c - R;
      warp_append(corner && ty >= 0 && ty < kTileH && tx >= 0 && tx < kTileW,
                  static_cast<uint16_t>(ty * kTileW + tx), s_list, &s_count);
    }
  }
  __syncthreads();

  // 2. each tile corner against the corners of its open disc
  const int n = s_count;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int p = s_list[k];
    const int rr = p / kTileW + R, cc = p % kTileW + R;
    const float v = s_val[rr * kRegW + cc];
    bool alive = true;
    for (int i = 0; i <= 2 * R && alive; ++i) {
      const int dy = (i & 1) ? -((i + 1) >> 1) : (i >> 1);
      const int wd = s_wdx[dy + R];
      const int lo = cc - wd;           // >= 0: wd <= R
      const uint32_t* bits = s_bits + (rr + dy) * kMaskWords + (lo >> 5);
      const uint64_t pair = bits[0] | (static_cast<uint64_t>(bits[1]) << 32);
      uint32_t m = static_cast<uint32_t>(pair >> (lo & 31))
                   & ((2u << (2 * wd)) - 1u);
      const float* row = s_val + (rr + dy) * kRegW + lo;
      for (; m; m &= m - 1) {
        if (row[__ffs(m) - 1] > v) {
          alive = false;
          break;
        }
      }
    }
    if (alive) s_keep[p] = 1;
  }
  __syncthreads();

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
        s_keep[p] ? s_val[(ty + R) * kRegW + cc + R] : neg_inf();
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
