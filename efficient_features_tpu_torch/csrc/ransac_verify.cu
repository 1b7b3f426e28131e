// K12, the verification: every RANSAC hypothesis scored against every
// match (ransac_score_kernel), and one homography's inlier mask and count
// (ransac_mask_kernel), with no (M, N) tensor anywhere.
//
// No TPU kernel: the JAX package scores with XLA ops
// (efficient_features_tpu/ops/ransac.py:93 `_reproj_err2`, and the mask
// and sum at :120-124 and :129-130): an (M, N, 3) product and (M, N)
// errors.  The port's first form did the same in torch ops, at 512 x 40000
// about ten passes over 160-245 MB tensors, some 1.2-1.4 ms on an H100.
//
// Semantics, per pair (x, y) -> (u, v) and homography h (row-major 3x3),
// op by op as the plain version (ops/ransac._inliers):
//   p_x = (h0 x + h1 y) + h2, p_y = (h3 x + h4 y) + h5,
//   p_z = (h6 x + h7 y) + h8,
//   den = p_z, or 1e-12 where |p_z| < 1e-12,
//   dx = p_x / den - u, dy = p_y / den - v, e2 = dx dx + dy dy,
//   inlier = e2 <= t2 and not |p_z| < 1e-6 and the pair is valid.
// Every step is one IEEE operation, rounded alone (`-fmad=false`,
// correctly rounded division), so the masks and counts equal the plain
// version's bit for bit.
//
// What bounds it on the H100: operations.  M x (valid pairs) evaluations
// of 23 float32 operations each (two divisions among them) on 17 B a pair
// and 36 B a hypothesis: at 512 x 40000 about 0.007 ms at 67 TFLOP/s,
// while its bytes take 0.0002 ms.  Design: a block takes 256 pairs and up
// to 128 hypotheses (grid y walks larger M); it packs its valid pairs to
// the front in shared memory (invalid slots cost no evaluation, and warps
// left without a pair skip the loop), holds its hypotheses in shared
// memory at a 48 B stride (three 16 B loads each, broadcast), and each
// warp counts a hypothesis's inliers with one ballot; the block adds its
// warps' counts and makes one atomicAdd per hypothesis.  Integer sums, so
// the result does not depend on the order of the atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"

namespace {

constexpr int kThreads = 256;             // pairs a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;               // hypotheses a block
constexpr int kStride = 12;               // floats a hypothesis in smem
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEpsDen = 1e-12f;         // floor of |p_z| as a divisor
constexpr float kEpsInf = 1e-6f;          // |p_z| below it: at infinity

__device__ __forceinline__ bool inlier(const float* h, float x, float y,
                                       float u, float v, float t2) {
  const float px = h[0] * x + h[1] * y + h[2];
  const float py = h[3] * x + h[4] * y + h[5];
  const float pz = h[6] * x + h[7] * y + h[8];
  const float az = fabsf(pz);
  const float den = az < kEpsDen ? kEpsDen : pz;
  const float dx = __fdiv_rn(px, den) - u;
  const float dy = __fdiv_rn(py, den) - v;
  const float e2 = dx * dx + dy * dy;
  return e2 <= t2 && !(az < kEpsInf);
}

__global__ void __launch_bounds__(kThreads)
ransac_score_kernel(const float* __restrict__ H, int m,
                    const float2* __restrict__ src,
                    const float2* __restrict__ dst,
                    const uint8_t* __restrict__ valid, int n, float t2,
                    int* __restrict__ scores) {
  __shared__ __align__(16) float s_h[kChunk * kStride];
  __shared__ float4 s_pair[kThreads];
  __shared__ int s_cnt[kWarps][kChunk];
  __shared__ int s_base[kWarps + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = blockIdx.y * kChunk;
  const int hn = min(kChunk, m - h0);
  for (int e = threadIdx.x; e < hn * 9; e += kThreads)
    s_h[(e / 9) * kStride + e % 9] = H[static_cast<size_t>(h0) * 9 + e];
  // the block's valid pairs, packed to the front in slot order
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n && valid[i];
  const unsigned bal = __ballot_sync(kFull, live);
  if (lane == 0) s_base[warp + 1] = __popc(bal);
  __syncthreads();
  if (threadIdx.x == 0) {
    s_base[0] = 0;
    for (int w = 1; w <= kWarps; ++w) s_base[w] += s_base[w - 1];
  }
  __syncthreads();
  if (live) {
    const float2 a = src[i], b = dst[i];
    s_pair[s_base[warp] + __popc(bal & ((1u << lane) - 1))] =
        make_float4(a.x, a.y, b.x, b.y);
  }
  __syncthreads();
  const int packed = s_base[kWarps];
  const int busy = (packed + 31) / 32;      // warps with a pair
  if (warp < busy) {
    const bool have = threadIdx.x < packed;
    const float4 pr = have ? s_pair[threadIdx.x]
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int k = 0; k < hn; ++k) {
      const bool in = have && inlier(s_h + k * kStride, pr.x, pr.y, pr.z,
                                     pr.w, t2);
      const unsigned b = __ballot_sync(kFull, in);
      if (lane == 0) s_cnt[warp][k] = __popc(b);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < hn; k += kThreads) {
    int c = 0;
    for (int w = 0; w < busy; ++w) c += s_cnt[w][k];
    if (c) atomicAdd(scores + h0 + k, c);
  }
}

__global__ void __launch_bounds__(kThreads)
ransac_mask_kernel(const float* __restrict__ H,
                   const float2* __restrict__ src,
                   const float2* __restrict__ dst,
                   const uint8_t* __restrict__ valid, int n, float t2,
                   uint8_t* __restrict__ mask, int* __restrict__ count) {
  __shared__ float s_h[9];
  if (threadIdx.x < 9) s_h[threadIdx.x] = H[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool in = false;
  if (i < n && valid[i]) {
    const float2 a = src[i], b = dst[i];
    in = inlier(s_h, a.x, a.y, b.x, b.y, t2);
  }
  if (i < n) mask[i] = in ? 1 : 0;
  const unsigned b = __ballot_sync(kFull, in);
  if ((threadIdx.x & 31) == 0 && b) atomicAdd(count, __popc(b));
}

}  // namespace

extern "C" int eff_ransac_score(const float* H, int m, const float* src,
                                const float* dst, const uint8_t* valid, int n,
                                float t2, int32_t* scores, void* stream) {
  if (m < 1 || n < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(scores, 0, sizeof(int32_t) * m, s);
  if (rc != cudaSuccess || n == 0) return rc;
  const dim3 grid((n + kThreads - 1) / kThreads, (m + kChunk - 1) / kChunk);
  ransac_score_kernel<<<grid, kThreads, 0, s>>>(
      H, m, reinterpret_cast<const float2*>(src),
      reinterpret_cast<const float2*>(dst), valid, n, t2, scores);
  return cudaGetLastError();
}

extern "C" int eff_ransac_mask(const float* H, const float* src,
                               const float* dst, const uint8_t* valid, int n,
                               float t2, uint8_t* mask, int32_t* count,
                               void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
  if (rc != cudaSuccess || n == 0) return rc;
  ransac_mask_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      H, reinterpret_cast<const float2*>(src),
      reinterpret_cast<const float2*>(dst), valid, n, t2, mask, count);
  return cudaGetLastError();
}
