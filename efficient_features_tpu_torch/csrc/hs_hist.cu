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
// The body is `hs::hist_block` in hs_common.cuh, which the fused kernel K11
// (hs_desc.cu) compiles too; its notes give the design.  It uses no
// atomics: the same input gives the same bytes on every run.
//
// What bounds it on the H100: the instructions per vote, 900 atan2f and
// 5202 weighted votes a patch (hs_common.cuh).  DRAM traffic is 1152 B per
// patch and the 10.8 KB plan once.  An all-zero patch (every invalid slot of
// the pipeline's levels) costs only its bytes: its row is zero without the
// histogram.
//
// Design: a 256-thread block per 8 patches (the last block may hold
// fewer).  Each half of the block loads every other patch into shared
// memory, 8 bytes a thread, and its warps vote which patches hold a nonzero
// word; `hist_block` does the rest.  Build with -fmad=false: the votes and
// sums round as the plain version's steps do.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"
#include "hs_common.cuh"

namespace {

__global__ void __launch_bounds__(hs::kHistThreads)
hs_hist_kernel(const uint8_t* __restrict__ patches, int n,
               const int* __restrict__ plan, const float* __restrict__ wpack,
               float ori_scale, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  hs::HistScratch& s = *reinterpret_cast<hs::HistScratch*>(smem);
  const int t = threadIdx.x;
  const int base = blockIdx.x * hs::kBlockPatches;
  const int np = min(hs::kBlockPatches, n - base);
  const int u = t % hs::kBinThreads;   // 8-byte word u of patch p
  bool nonzero = false;
#pragma unroll
  for (int j = 0; j < hs::kBlockPatches; j += 2) {
    const int p = j + t / hs::kBinThreads;
    uint2 v = make_uint2(0u, 0u);
    if (p < np)
      v = __ldg(reinterpret_cast<const uint2*>(
                    patches + static_cast<size_t>(base + p) * hs::kPatchPixels)
                + u);
    reinterpret_cast<uint2*>(s.patch[p])[u] = v;
    const bool any = __any_sync(0xffffffffu, (v.x | v.y) != 0u);
    if (t % 32 == 0) s.nz[p][u / 32] = any;
    nonzero |= any;
  }
  hs::hist_block(s, np, nonzero, plan, wpack, ori_scale,
                 out + static_cast<size_t>(base) * 128);
}

cudaError_t allow_scratch() {
  static bool done[64] = {};
  return hs::allow_hist_scratch(reinterpret_cast<const void*>(hs_hist_kernel),
                                done);
}

}  // namespace

extern "C" int eff_hs_hist(const uint8_t* patches, int n, const int32_t* plan,
                           const float* wpack, float ori_scale, uint8_t* out,
                           void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const cudaError_t rc = allow_scratch();
  if (rc != cudaSuccess) return rc;
  hs_hist_kernel<<<(n + hs::kBlockPatches - 1) / hs::kBlockPatches,
                   hs::kHistThreads, sizeof(hs::HistScratch),
                   static_cast<cudaStream_t>(stream)>>>(
      patches, n, plan, wpack, ori_scale, out);
  return cudaGetLastError();
}

extern "C" int eff_hs_hist_blocks_per_sm(int* blocks) {
  const cudaError_t rc = allow_scratch();
  if (rc != cudaSuccess) return rc;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, hs_hist_kernel, hs::kHistThreads, sizeof(hs::HistScratch));
}
