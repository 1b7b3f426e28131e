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
// global row of a maximal survivor, survivor count, survivor bitmap: bit k
// for row 8i + k); dead cells hold (-inf, INT32_MAX, 0, 0).  Output is
// exactly (ceil(h/8), w), for every nonmax radius >= 1.  The bitmap lets
// selection place every tied survivor without a dense map
// (ops/detect.select_topk_cells).
//
// What bounds it on the H100: FAST at every pixel (48 integer operations)
// and, per corner, Harris and the disc compares.  Corners are sparse, only
// corners can survive and only corners can suppress, so the work beyond
// FAST belongs to the corners, not to the pixels.  A block that stages the
// response of its tile plus the R = radius - 1 ring does FAST and Harris
// (32 + 2R)(64 + 2R) / 2048 times over (2.7x at radius 15, 9.7x at 48),
// needs shared memory that grows with R^2, and leaves a corner's lane to
// walk its disc alone while the rest of its warp waits.
//
// Design: two kernels per call, no ring.
//   1. `fast_harris_kernel` (detect_common.cuh, K8's kernel, here with the
//      mask): FAST, border and mask once per pixel, Harris once per corner
//      from a compacted list, into a dense f32 response map in device memory
//      (scratch of the wrapper; written once, read back through L2).  The
//      mask gates the response itself, so a masked-out corner neither
//      survives nor suppresses, over any reach
//      (pallas_kernels.py:735-740).
//   2. `nms_cells_kernel`: a 256-thread block per 32x64 tile reads its tile
//      of the map into shared memory and compacts the corners.
//      a. Corner against corner inside the tile, one thread per corner over
//         the tile's list: a strictly larger response at dx^2 + dy^2 <
//         radius^2 suppresses (ties co-survive).  Nearly every suppressed
//         corner falls here, at shared-memory latency.
//      b. What is left scans its whole disc in the map.  The disc comes as a
//         table of segments (a row dy, columns dx0..dx1, at most 32 wide) in
//         the order dy = 0, -1, 1, -2, ... since a larger neighbour is most
//         likely near.  A work item is one corner and four segments, their
//         loads in flight together (the scan is a chain of L2 latencies
//         otherwise); the block's warps share the items, all corners' first
//         four segments first, and skip a corner that is already
//         suppressed.  Which warp finds the larger response first changes
//         nothing: a corner is suppressed if any of its items says so.
//      A suppressed corner's slot in the tile turns to -inf only after (a)
//      and the map itself is never changed: a suppressed corner still
//      suppresses.  Each thread then reduces one cell (4 cell rows x 64
//      columns = 256 cells).
// Shared memory is 18 KB whatever the radius.  Both lists hold a whole
// tile, so no corner is ever dropped.
#include "detect_common.cuh"

namespace {

constexpr int kTilePixels = kTileH * kTileW;
constexpr int kSegsPerItem = 4;   // segments a warp reads between two votes

__global__ void __launch_bounds__(kThreads)
nms_cells_kernel(const float* __restrict__ resp, int h, int w, int radius,
                 const int4* __restrict__ segs, int seg_groups,
                 float* __restrict__ cellmax, int32_t* __restrict__ cellrow,
                 int32_t* __restrict__ cellcnt,
                 uint8_t* __restrict__ cellbits) {
  __shared__ float s_val[kTilePixels];      // the tile of the map
  __shared__ uint16_t s_list[kTilePixels];  // tile indices of the corners
  __shared__ uint16_t s_left[kTilePixels];  // of those left after (a)
  __shared__ uint8_t s_alive[kTilePixels];  // per entry of s_list
  __shared__ int s_count, s_nleft;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_count = s_nleft = 0;
  __syncthreads();

  // 1. the tile of the map, corners to the list
  for (int base = 0; base < kTilePixels; base += kThreads) {
    const int p = base + threadIdx.x;
    const int gy = y0 + p / kTileW, gx = x0 + p % kTileW;
    const float v = (gy < h && gx < w)
                        ? resp[static_cast<size_t>(gy) * w + gx] : neg_inf();
    s_val[p] = v;
    warp_append(v != neg_inf(), static_cast<uint16_t>(p), s_list, &s_count);
  }
  __syncthreads();

  // 2a. corner against corner inside the tile
  const int n = s_count;
  const int r2 = radius * radius;
  for (int base = 0; base < n; base += kThreads) {
    const int k = base + threadIdx.x;
    bool alive = k < n;
    const int p = alive ? s_list[k] : 0;
    const float v = s_val[p];
    for (int b = 0; b < n && alive; ++b) {
      const int q = s_list[b];
      const int dy = q / kTileW - p / kTileW, dx = q % kTileW - p % kTileW;
      alive = !(dx * dx + dy * dy < r2 && s_val[q] > v);
    }
    if (k < n) s_alive[k] = alive;
    warp_append(alive, static_cast<uint16_t>(p), s_left, &s_nleft);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads)
    if (!s_alive[k]) s_val[s_list[k]] = neg_inf();
  __syncthreads();

  // 2b. the whole disc of what is left, in the map
  const int nleft = s_nleft;
  volatile float* live_val = s_val;
  for (int item = threadIdx.x >> 5; item < nleft * seg_groups;
       item += kThreads / 32) {
    const int g = item / nleft;
    const int p = s_left[item - g * nleft];
    // other warps turn live_val[p] to -inf meanwhile: one lane reads it for
    // the warp, so that the skip and the vote below are warp-uniform
    const float v = __shfl_sync(kFullWarp, lane == 0 ? live_val[p] : 0.f, 0);
    if (v == neg_inf()) continue;          // another item suppressed it
    const int y = y0 + p / kTileW, x = x0 + p % kTileW;
    float got[kSegsPerItem];
#pragma unroll
    for (int u = 0; u < kSegsPerItem; ++u) {
      const int4 sg = segs[g * kSegsPerItem + u];    // dy, dx0, dx1
      const int yy = y + sg.x, xx = x + sg.y + lane;
      got[u] = (yy >= 0 && yy < h && xx >= 0 && xx <= min(x + sg.z, w - 1))
                   ? resp[static_cast<size_t>(yy) * w + xx] : neg_inf();
    }
    bool larger = false;
#pragma unroll
    for (int u = 0; u < kSegsPerItem; ++u) larger |= got[u] > v;
    if (__any_sync(kFullWarp, larger) && lane == 0) live_val[p] = neg_inf();
  }
  __syncthreads();

  // 3. one cell per thread: 8 rows of one column
  const int cr = threadIdx.x / kTileW, cc = threadIdx.x % kTileW;
  const int cell_y = blockIdx.y * (kTileH / 8) + cr;
  const int x = x0 + cc;
  if (cell_y >= (h + 7) / 8 || x >= w) return;
  float best = neg_inf();
  int best_row = 2147483647;
  int count = 0;
  unsigned bits = 0;
  for (int k = 0; k < 8; ++k) {
    const int ty = cr * 8 + k;
    const float v = s_val[ty * kTileW + cc];
    if (v == neg_inf()) continue;
    ++count;
    bits |= 1u << k;
    if (v > best) {  // rows ascend: the first maximal survivor is the lowest
      best = v;
      best_row = y0 + ty;
    }
  }
  const size_t o = static_cast<size_t>(cell_y) * w + x;
  cellmax[o] = best;
  cellrow[o] = best_row;
  cellcnt[o] = count;
  cellbits[o] = static_cast<uint8_t>(bits);
}

}  // namespace

extern "C" int eff_fast_harris_nms_cells(const uint8_t* img,
                                         const uint8_t* mask, int h, int w,
                                         int threshold, int radius,
                                         const int32_t* disc_segs,
                                         int seg_groups, float harris_s2,
                                         float* resp, float* cellmax,
                                         int32_t* cellrow, int32_t* cellcnt,
                                         uint8_t* cellbits, void* stream) {
  if (radius < 1 || radius > 32767 || seg_groups < 1 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch_fast_harris(img, mask, h, w, threshold, harris_s2, resp, s);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  nms_cells_kernel<<<grid, kThreads, 0, s>>>(
      resp, h, w, radius, reinterpret_cast<const int4*>(disc_segs), seg_groups,
      cellmax, cellrow, cellcnt, cellbits);
  return cudaGetLastError();
}
