// Device code shared by the HashSIFT kernels: K4 (warp_patches.cu), K5
// (hs_hist.cu) and K11 (hs_desc.cu).
//
// K11 is K5 applied to K4's patch without the patch leaving the chip, and
// its rows must equal K5(K4(.)) byte for byte.  So the per-sample warp and
// the per-patch histogram live here once and all three sources compile the
// same code (with -fmad=false: every product and sum rounds on its own, as
// in the plain versions).
#pragma once

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hs {

constexpr int kPatch = 32;             // patch side
constexpr int kPatchPixels = kPatch * kPatch;
constexpr int kHistThreads = 128;      // one thread per output bin
constexpr int kInterior = 30;
constexpr int kPixels = kInterior * kInterior;

// -- the warp: one bilinear sample under the keypoint affine ----------------

// Rows of the keypoint affine: u = c*px - sn*py + m02, v = sn*px + c*py + m12
// (c = cos*s, sn = sin*s).
struct Affine {
  float c, sn, m02, m12;
};

// m02/m12 are rebuilt from c and sn (window_kernels.py:183-189): an m02
// computed apart from c can be one ulp off and break the exact u = 0 sample
// of a keypoint on the image corner.
__device__ __forceinline__ Affine keypoint_affine(float x, float y, float c,
                                                  float sn) {
  Affine a;
  a.c = c;
  a.sn = sn;
  a.m02 = __fadd_rn(__fmul_rn(__fadd_rn(-c, sn), 16.0f), x);
  a.m12 = __fadd_rn(__fmul_rn(__fsub_rn(-sn, c), 16.0f), y);
  return a;
}

// Patch pixels p0 .. p0 + 3 (p0 a multiple of 4, so one patch row) as one
// little-endian 32-bit word.  A sample is valid when its 2x2 support lies in
// the image; it is then the reference's full-f32 lerp of the four pixels,
// rounded as min(trunc(t + 0.5), 255); else 0.
__device__ __forceinline__ uint32_t sample_word(const uint8_t* __restrict__ img,
                                                int h, int w, const Affine& a,
                                                int p0) {
  const float py = static_cast<float>(p0 / kPatch);
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float px = static_cast<float>(p0 % kPatch + j);
    const float u = __fadd_rn(
        __fsub_rn(__fmul_rn(a.c, px), __fmul_rn(a.sn, py)), a.m02);
    const float v = __fadd_rn(
        __fadd_rn(__fmul_rn(a.sn, px), __fmul_rn(a.c, py)), a.m12);
    const float uf = floorf(u), vf = floorf(v);
    // the range test on the float floors keeps a far-off sample from
    // overflowing the int conversion
    if (uf >= 0.0f && uf < static_cast<float>(w - 1) && vf >= 0.0f
        && vf < static_cast<float>(h - 1)) {
      const int ui = static_cast<int>(uf), vi = static_cast<int>(vf);
      const float du = __fsub_rn(u, uf), dv = __fsub_rn(v, vf);
      const uint8_t* p = img + static_cast<size_t>(vi) * w + ui;
      const float p00 = __ldg(p), p01 = __ldg(p + 1);
      const float p10 = __ldg(p + w), p11 = __ldg(p + w + 1);
      const float h0 = __fsub_rn(1.0f, du);
      const float z_top = __fadd_rn(__fmul_rn(h0, p00), __fmul_rn(du, p01));
      const float z_bot = __fadd_rn(__fmul_rn(h0, p10), __fmul_rn(du, p11));
      const float t2 = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, dv), z_top),
                                 __fmul_rn(dv, z_bot));
      const float val = fminf(truncf(__fadd_rn(t2, 0.5f)), 255.0f);
      word |= static_cast<uint32_t>(val) << (8 * j);
    }
  }
  return word;
}

// -- the histogram of one patch, by a block of kHistThreads threads ---------

// Per-block scratch of `hist_from_patch`, in shared memory: each interior
// pixel's orientation bin and its two votes, and the warp partials of the
// norms.
struct HistScratch {
  float lo[kPixels], hi[kPixels];
  float red[kHistThreads / 32];
  uint8_t oi[kPixels];
};

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

// The quantised SIFT row of the 32x32 u8 patch `p` (shared memory, complete
// and visible to the block: the caller has passed a barrier after filling
// it), written to out_row[0..127] in the orientation-major layout.  Every
// thread of the kHistThreads-thread block must call it (it holds barriers).
// As `patch_sift_responses` (ops/hash_sift.py): exact integer gradients over
// the 30x30 interior, magnitude sqrtf, orientation atan2f, an orientation
// bin and its fraction; each pixel votes mag*(1 - f) into bin oi and mag*f
// into bin oi + 1 (8 folds to 0), weighted by the (900, 16) core spatial
// weights; then L2 normalise, clip at 0.2, L2 normalise, trunc(512*d + 0.5)
// clipped to [0, 255].
//
// Determinism: no atomics.  Thread t = o*16 + rc owns output bin (o, rc) and
// sums its votes in pixel-index order; the norms are a fixed shuffle tree
// per warp and then the four warp partials in order.
__device__ __forceinline__ void hist_from_patch(
    const uint8_t* p, const float* __restrict__ wcore, float ori_scale,
    HistScratch& s, uint8_t* __restrict__ out_row) {
  const int t = threadIdx.x;
  for (int l = t; l < kPixels; l += kHistThreads) {
    const int yy = l / kInterior + 1, xx = l % kInterior + 1;
    const float dx = static_cast<float>(
        static_cast<int>(p[yy * kPatch + xx + 1]) - p[yy * kPatch + xx - 1]);
    const float dy = static_cast<float>(
        static_cast<int>(p[(yy - 1) * kPatch + xx]) - p[(yy + 1) * kPatch + xx]);
    const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)));
    const float ob = __fmul_rn(ori_scale, atan2f(dy, dx));
    const float obf = floorf(ob);
    int oi = static_cast<int>(obf);
    const float of = __fsub_rn(ob, obf);
    if (oi < 0) oi += 8;
    if (oi >= 8) oi -= 8;
    const float v_hi = __fmul_rn(of, mag);
    s.oi[l] = static_cast<uint8_t>(oi);
    s.lo[l] = __fsub_rn(mag, v_hi);
    s.hi[l] = v_hi;
  }
  __syncthreads();

  const int o = t / 16, rc = t % 16;
  const int r = rc / 4, c = rc % 4;
  const int o_prev = (o + 7) % 8;  // pixels in bin o_prev vote v_hi here
  float acc = 0.0f;
  for (int yy = bin_lo(r); yy < bin_hi(r); ++yy) {
    for (int xx = bin_lo(c); xx < bin_hi(c); ++xx) {
      const int l = (yy - 1) * kInterior + (xx - 1);
      const int oi = s.oi[l];
      const float v = oi == o ? s.lo[l] : (oi == o_prev ? s.hi[l] : 0.0f);
      acc = __fadd_rn(acc, __fmul_rn(__ldg(wcore + l * 16 + rc), v));
    }
  }

  const float nrm = fmaxf(__fsqrt_rn(block_sum(__fmul_rn(acc, acc), s.red)),
                          FLT_EPSILON);
  float d = fminf(__fdiv_rn(acc, nrm), 0.2f);
  const float nrm2 = fmaxf(__fsqrt_rn(block_sum(__fmul_rn(d, d), s.red)),
                           FLT_EPSILON);
  d = __fdiv_rn(d, nrm2);
  const float q = fminf(fmaxf(truncf(__fadd_rn(__fmul_rn(512.0f, d), 0.5f)),
                              0.0f), 255.0f);
  out_row[t] = static_cast<uint8_t>(q);
}

}  // namespace hs
