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
// takes keypoints of any size, as K4 does (K4 reads a small keypoint's
// window staged in shared memory; the bytes are the same either way).
//
// What bounds it on the H100: the histogram's instructions per vote, as in
// K5 (hs_common.cuh), plus 1024 bilinear samples per keypoint.  Against K4
// + K5 it saves the 1 KB patch row written to and read back from device
// memory per keypoint and one launch; DRAM traffic is the 17 B of keypoint
// and the 128 B output row, the image's pixels under the patch come from
// L1/L2.  An invalid slot costs only those bytes.
//
// Design: K5's block, 256 threads per 8 keypoints, so the histogram runs
// the same `hs::hist_block` on the same shared-memory layout and its sums
// keep K5's order.  The sampling phase, 256 threads a patch in K4, here
// gives each half of the block every other keypoint and each thread two
// 4-sample words of it (word u and word u + 128, so the shared-memory
// stores of a warp fall on 32 different banks); an invalid slot's words
// are 0 without sampling, so `hist_block` takes it for an empty patch and
// writes its zero row.  Whether a slot is valid is the same for each half
// of the block, so no thread leaves early and every barrier is reached by
// all.  Each slot's affine is computed once, by the first threads of the
// block, from its size and angle (`hs::keypoint_trig`, as K4), so the
// wrapper runs no torch op.  The image may be a band of a larger frame, as
// for K4 (`hs::Frame`; a band's launch takes the instantiation whose reads
// are clamped into the band).  Build with -fmad=false, as K4 and K5.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"
#include "hs_common.cuh"

namespace {

template <bool kBand>
__global__ void __launch_bounds__(hs::kHistThreads)
hs_desc_kernel(const uint8_t* __restrict__ img, int h, int w,
               const float* __restrict__ kx, const float* __restrict__ ky,
               const float* __restrict__ ksize,
               const float* __restrict__ kangle,
               const uint8_t* __restrict__ valid, int n, float scale,
               hs::Frame frame, const int* __restrict__ plan,
               const float* __restrict__ wpack,
               float ori_scale, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ hs::Affine s_affine[hs::kBlockPatches];
  hs::HistScratch& s = *reinterpret_cast<hs::HistScratch*>(smem);
  const int t = threadIdx.x;
  const int base = blockIdx.x * hs::kBlockPatches;
  const int np = min(hs::kBlockPatches, n - base);
  if (t < np && valid[base + t]) {
    const int k = base + t;
    const hs::Trig trig = hs::keypoint_trig(ksize[k], kangle[k], scale);
    s_affine[t] = hs::keypoint_affine(kx[k], ky[k], trig.c, trig.sn);
  }
  __syncthreads();
  const int u = t % hs::kBinThreads;   // 4-byte words u, u + 128 of patch p
  constexpr int kSteps = hs::kBlockPatches / 2;
  uint32_t w0[kSteps], w1[kSteps];
  // every sample of the thread first, so that their loads are in flight
  // together; then the stores and the votes
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int p = 2 * j + t / hs::kBinThreads;
    const int k = base + p;
    w0[j] = w1[j] = 0u;
    if (p < np && valid[k]) {
      const hs::GlobalFetch fetch{img, w};
      w0[j] = hs::sample_word<kBand>(fetch, frame, s_affine[p], u * 4);
      w1[j] = hs::sample_word<kBand>(fetch, frame, s_affine[p],
                                     (u + hs::kBinThreads) * 4);
    }
  }
  bool nonzero = false;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int p = 2 * j + t / hs::kBinThreads;
    uint32_t* words = reinterpret_cast<uint32_t*>(s.patch[p]);
    words[u] = w0[j];
    words[u + hs::kBinThreads] = w1[j];
    const bool any = __any_sync(0xffffffffu, (w0[j] | w1[j]) != 0u);
    if (t % 32 == 0) s.nz[p][u / 32] = any;
    nonzero |= any;
  }
  hs::hist_block(s, np, nonzero, plan, wpack, ori_scale,
                 out + static_cast<size_t>(base) * 128);
}

template <bool kBand>
cudaError_t allow_scratch() {
  static bool done[64] = {};
  return hs::allow_hist_scratch(
      reinterpret_cast<const void*>(hs_desc_kernel<kBand>), done);
}

}  // namespace

extern "C" int eff_hs_desc(const uint8_t* img, int h, int w, int oy, int ox,
                           int frame_h, int frame_w, const float* kx,
                           const float* ky, const float* size,
                           const float* angle, const uint8_t* valid, int n,
                           float scale, const int32_t* plan, const float* wpack,
                           float ori_scale, uint8_t* out, void* stream) {
  if (h < 1 || w < 1 || n < 1 || frame_h < 1 || frame_w < 1)
    return cudaErrorInvalidValue;
  const hs::Frame frame{oy, ox, frame_h, frame_w, h, w};
  const bool band = oy != 0 || ox != 0 || frame_h != h || frame_w != w;
  const cudaError_t rc = band ? allow_scratch<true>() : allow_scratch<false>();
  if (rc != cudaSuccess) return rc;
  const int blocks = (n + hs::kBlockPatches - 1) / hs::kBlockPatches;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (band)
    hs_desc_kernel<true><<<blocks, hs::kHistThreads, sizeof(hs::HistScratch),
                           st>>>(img, h, w, kx, ky, size, angle, valid, n,
                                 scale, frame, plan, wpack, ori_scale, out);
  else
    hs_desc_kernel<false><<<blocks, hs::kHistThreads,
                            sizeof(hs::HistScratch), st>>>(
        img, h, w, kx, ky, size, angle, valid, n, scale, frame, plan, wpack,
        ori_scale, out);
  return cudaGetLastError();
}

extern "C" int eff_hs_desc_blocks_per_sm(int* blocks) {
  const cudaError_t rc = allow_scratch<false>();
  if (rc != cudaSuccess) return rc;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, hs_desc_kernel<false>, hs::kHistThreads,
      sizeof(hs::HistScratch));
}
