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
// The per-patch body is `hs::hist_from_patch` in hs_common.cuh, which the
// fused kernel K11 (hs_desc.cu) compiles too.  It uses no atomics: the same
// input gives the same bytes on every run.
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
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"
#include "hs_common.cuh"

namespace {

__global__ void __launch_bounds__(hs::kHistThreads)
hs_hist_kernel(const uint8_t* __restrict__ patches,
               const float* __restrict__ wcore, float ori_scale,
               uint8_t* __restrict__ out) {
  __shared__ __align__(8) uint8_t p[hs::kPatchPixels];
  __shared__ hs::HistScratch scratch;
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  reinterpret_cast<uint2*>(p)[t] = __ldg(
      reinterpret_cast<const uint2*>(patches + static_cast<size_t>(k)
                                     * hs::kPatchPixels) + t);
  __syncthreads();
  hs::hist_from_patch(p, wcore, ori_scale, scratch,
                      out + static_cast<size_t>(k) * 128);
}

}  // namespace

extern "C" int eff_hs_hist(const uint8_t* patches, int n, const float* wcore,
                           float ori_scale, uint8_t* out, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  hs_hist_kernel<<<n, hs::kHistThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(patches, wcore,
                                                        ori_scale, out);
  return cudaGetLastError();
}
