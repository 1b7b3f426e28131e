// K11: fused HashSIFT, keypoints on a u8 image -> (N, 128) u8 SIFT rows.
//
// Replaces the TPU kernel `_hs_fused_kernel`
// (efficient_features_tpu/ops/window_kernels.py:1358, launched by
// `_hs_desc_windows_impl` :1565, public name `hs_desc_windows` :1900).  Per
// keypoint (x, y, size, angle): the 32x32 bilinear patch under the keypoint
// affine quantised to u8, then the SIFT histogram of that patch, normalised
// and quantised, in the orientation-major layout e[o*16 + rc]; invalid slots
// give zero rows.  That is K5 (hs_hist.cu) applied to K4's patch
// (warp_patches.cu) without the patch leaving the chip, and this kernel
// calls the very device functions of the two (hs_common.cuh), so its rows
// equal K5(K4(.)) byte for byte.
//
// The TPU body's one-hot gather matmuls, packed gradient matmul, polynomial
// atan2, Newton reciprocals and sublane-flatten matmul stand in for what
// Mosaic lacks and are not carried over; nor is its bound on the keypoint
// size (`_S_BASE`): pixels are read straight from the image, so one kernel
// takes keypoints of any size, as K4 does.
//
// What bounds it on the H100: arithmetic, as K5 (each bin sums up to 15x15
// weighted votes; 128 bins per keypoint).  Against K4 + K5 it saves the
// 1 KB patch row written to and read back from device memory per keypoint
// and one launch; DRAM traffic is the 128 B output row, the image's pixels
// under the patch come from L1/L2.
//
// Design: one block per keypoint, as the original CUDA library
// (cuda_hash_sift.cu:380-412).  128 threads, K5's count: the histogram is
// the larger phase by an order of magnitude and has exactly one thread per
// output bin and a four-warp norm tree, so keeping its shape keeps its sums
// in K5's order; the sampling phase, 256 threads in K4, here gives each
// thread two 4-sample words (word t and word t + 128, so the shared-memory
// stores of a warp fall on 32 different banks).  The patch goes to shared
// memory, a barrier ends the sampling phase before any gradient is read,
// and the block runs `hs::hist_from_patch`.  Shared memory: 1 KB patch +
// 8.1 KB votes.  The valid flag is the same for the whole block, so an
// invalid slot returns before the first barrier on every thread.  Build
// with -fmad=false, as K4 and K5.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"
#include "hs_common.cuh"

namespace {

__global__ void __launch_bounds__(hs::kHistThreads)
hs_desc_kernel(const uint8_t* __restrict__ img, int h, int w,
               const float* __restrict__ kx, const float* __restrict__ ky,
               const float* __restrict__ cos_s,
               const float* __restrict__ sin_s,
               const uint8_t* __restrict__ valid,
               const float* __restrict__ wcore, float ori_scale,
               uint8_t* __restrict__ out) {
  __shared__ __align__(4) uint8_t p[hs::kPatchPixels];
  __shared__ hs::HistScratch scratch;
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  uint8_t* out_row = out + static_cast<size_t>(k) * 128;
  if (!valid[k]) {
    out_row[t] = 0;
    return;
  }
  const hs::Affine a = hs::keypoint_affine(kx[k], ky[k], cos_s[k], sin_s[k]);
  uint32_t* words = reinterpret_cast<uint32_t*>(p);
  for (int i = t; i < hs::kPatchPixels / 4; i += hs::kHistThreads)
    words[i] = hs::sample_word(img, h, w, a, i * 4);
  __syncthreads();
  hs::hist_from_patch(p, wcore, ori_scale, scratch, out_row);
}

}  // namespace

extern "C" int eff_hs_desc(const uint8_t* img, int h, int w, const float* kx,
                           const float* ky, const float* cos_s,
                           const float* sin_s, const uint8_t* valid, int n,
                           const float* wcore, float ori_scale, uint8_t* out,
                           void* stream) {
  if (h < 1 || w < 1 || n < 1) return cudaErrorInvalidValue;
  hs_desc_kernel<<<n, hs::kHistThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      img, h, w, kx, ky, cos_s, sin_s, valid, wcore, ori_scale, out);
  return cudaGetLastError();
}
