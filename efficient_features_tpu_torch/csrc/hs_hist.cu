// K5: HashSIFT histogram, (N, 1024) u8 patches -> (N, 128) u8 SIFT rows.
//
// Replaces the TPU kernel `_hs_hist_kernel`
// (efficient_features_tpu/ops/window_kernels.py:1656, launched by
// `hs_hist_from_patches` :1703).  Per patch, as `patch_sift_responses`
// (ops/hash_sift.py:198-255): exact integer gradients over the 30x30
// interior, magnitude sqrtf, orientation atan2f, an orientation bin and its
// fraction; each pixel votes mag*(1 - f) into bin oi and mag*f into bin
// oi + 1 (8 folds to 0), weighted by the constant (900, 16) core spatial
// weights; then L2 normalise, clip at 0.2, L2 normalise, trunc(512*d + 0.5)
// clipped to [0, 255].  Output is orientation-major, e[o*16 + rc].
//
// The TPU kernel's polynomial atan2, Newton reciprocals and gradient matmul
// stand in for what Mosaic lacks; here atan2f, IEEE division and direct
// pixel differences are used.
//
// Determinism: no atomics.  Thread t = o*16 + rc owns output bin (o, rc) and
// sums its votes in pixel-index order; the norms are a fixed shuffle tree
// per warp and then the four warp partials in order.  The same input gives
// the same bytes on every run.
//
// What bounds it on the H100: arithmetic.  Each bin's sum runs over the
// <= 15x15 pixels whose spatial weight for it can be nonzero
// (ops/hash_sift.core_bin_rows), 128 bins per keypoint; the patch (1 KB),
// the per-pixel votes (9 KB) and the weights (57.6 KB, L1/L2-resident) are
// read from shared memory and cache.  DRAM traffic is 1152 B per keypoint.
//
// Design: one 128-thread block per keypoint.  The patch is loaded with one
// 8-byte read per thread; each thread then turns ~7 pixels into (oi, v_lo,
// v_hi) in shared memory, and after a barrier sums its bin.  Build with
// -fmad=false: the votes and sums round as the plain version's steps do.
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"

namespace {

constexpr int kThreads = 128;  // one per output bin
constexpr int kInterior = 30;
constexpr int kPixels = kInterior * kInterior;

// [lo, hi) of interior rows (1..30) that can vote into core bin row r;
// the same for columns (ops/hash_sift.core_bin_rows)
__device__ __forceinline__ int bin_lo(int r) { return max(8 * r - 3, 1); }
__device__ __forceinline__ int bin_hi(int r) { return min(8 * r + 12, 31); }

// sum over the block's 128 threads: xor tree per warp (every lane ends with
// the same value, since IEEE addition commutes), then warps 0..3 in order
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  const float s = __fadd_rn(__fadd_rn(__fadd_rn(red[0], red[1]), red[2]),
                            red[3]);
  __syncthreads();  // red is reused by the next call
  return s;
}

__global__ void __launch_bounds__(kThreads)
hs_hist_kernel(const uint8_t* __restrict__ patches,
               const float* __restrict__ wcore, float ori_scale,
               uint8_t* __restrict__ out) {
  __shared__ __align__(8) uint8_t p[1024];
  __shared__ uint8_t s_oi[kPixels];
  __shared__ float s_lo[kPixels], s_hi[kPixels];
  __shared__ float red[kThreads / 32];
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  reinterpret_cast<uint2*>(p)[t] = __ldg(
      reinterpret_cast<const uint2*>(patches + static_cast<size_t>(k) * 1024)
      + t);
  __syncthreads();

  for (int l = t; l < kPixels; l += kThreads) {
    const int yy = l / kInterior + 1, xx = l % kInterior + 1;
    const float dx = static_cast<float>(static_cast<int>(p[yy * 32 + xx + 1])
                                        - p[yy * 32 + xx - 1]);
    const float dy = static_cast<float>(static_cast<int>(p[(yy - 1) * 32 + xx])
                                        - p[(yy + 1) * 32 + xx]);
    const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)));
    const float ob = __fmul_rn(ori_scale, atan2f(dy, dx));
    const float obf = floorf(ob);
    int oi = static_cast<int>(obf);
    const float of = __fsub_rn(ob, obf);
    if (oi < 0) oi += 8;
    if (oi >= 8) oi -= 8;
    const float v_hi = __fmul_rn(of, mag);
    s_oi[l] = static_cast<uint8_t>(oi);
    s_lo[l] = __fsub_rn(mag, v_hi);
    s_hi[l] = v_hi;
  }
  __syncthreads();

  const int o = t / 16, rc = t % 16;
  const int r = rc / 4, c = rc % 4;
  const int o_prev = (o + 7) % 8;  // pixels in bin o_prev vote v_hi here
  float acc = 0.0f;
  for (int yy = bin_lo(r); yy < bin_hi(r); ++yy) {
    for (int xx = bin_lo(c); xx < bin_hi(c); ++xx) {
      const int l = (yy - 1) * kInterior + (xx - 1);
      const int oi = s_oi[l];
      const float v = oi == o ? s_lo[l] : (oi == o_prev ? s_hi[l] : 0.0f);
      acc = __fadd_rn(acc, __fmul_rn(__ldg(wcore + l * 16 + rc), v));
    }
  }

  const float nrm = fmaxf(__fsqrt_rn(block_sum(__fmul_rn(acc, acc), red)),
                          FLT_EPSILON);
  float d = fminf(__fdiv_rn(acc, nrm), 0.2f);
  const float nrm2 = fmaxf(__fsqrt_rn(block_sum(__fmul_rn(d, d), red)),
                           FLT_EPSILON);
  d = __fdiv_rn(d, nrm2);
  const float q = fminf(fmaxf(truncf(__fadd_rn(__fmul_rn(512.0f, d), 0.5f)),
                              0.0f), 255.0f);
  out[static_cast<size_t>(k) * 128 + t] = static_cast<uint8_t>(q);
}

}  // namespace

extern "C" int eff_hs_hist(const uint8_t* patches, int n, const float* wcore,
                           float ori_scale, uint8_t* out, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  hs_hist_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      patches, wcore, ori_scale, out);
  return cudaGetLastError();
}
