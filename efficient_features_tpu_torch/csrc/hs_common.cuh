// Device code shared by the HashSIFT kernels: K4 (warp_patches.cu), K5
// (hs_hist.cu) and K11 (hs_desc.cu), and the keypoint trig that K3
// (bad_descriptors.cu) takes too.
//
// K11 is K5 applied to K4's patch without the patch leaving the chip, and
// its rows must equal K5(K4(.)) byte for byte.  So the per-sample warp and
// the histogram of a block of patches live here once and all three sources
// compile the same code (with -fmad=false: every product and sum rounds on
// its own, as in the plain versions).
#pragma once

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hs {

constexpr int kPatch = 32;             // patch side
constexpr int kPatchPixels = kPatch * kPatch;
constexpr int kInterior = 30;
constexpr int kPixels = kInterior * kInterior;

// -- the keypoint affine ----------------------------------------------------

// ops/bad.DEG2RAD, as float
constexpr float kDeg2Rad = 0.017453292519943295f;

// The scale s, and c = cos*s, sn = sin*s, of the patch->image affine of a
// keypoint of `size` and `angle` (degrees; < 0 means no rotation) under the
// descriptor's scale factor (as float): `ops/bad.affine_trig` and the
// products by s, op by op.  cosf and sinf are the CUDA math library's, as
// torch.cos and torch.sin on a CUDA tensor; no fast-math intrinsic.
struct Trig {
  float s, c, sn;
};

__device__ __forceinline__ float keypoint_scale(float size, float scale) {
  return __fdiv_rn(__fmul_rn(scale, size), 32.0f);
}

__device__ __forceinline__ Trig keypoint_trig(float size, float angle,
                                              float scale) {
  Trig t;
  t.s = keypoint_scale(size, scale);
  const bool has = angle >= 0.0f;
  const float theta = __fmul_rn(angle, kDeg2Rad);
  const float cs = has ? cosf(theta) : 1.0f;
  const float sn = has ? sinf(theta) : 0.0f;
  t.c = __fmul_rn(cs, t.s);
  t.sn = __fmul_rn(sn, t.s);
  return t;
}

// Rows of the keypoint affine: u = c*px - sn*py + m02, v = sn*px + c*py + m12
// (c = cos*s, sn = sin*s).
struct Affine {
  float c, sn, m02, m12;
};

// m02/m12 are rebuilt from c and sn (ops/bad.affine_rows): an m02 computed
// apart from c can be one ulp off and break the exact u = 0 sample of a
// keypoint on the image corner.
__device__ __forceinline__ Affine keypoint_affine(float x, float y, float c,
                                                  float sn) {
  Affine a;
  a.c = c;
  a.sn = sn;
  a.m02 = __fadd_rn(__fmul_rn(__fadd_rn(-c, sn), 16.0f), x);
  a.m12 = __fadd_rn(__fmul_rn(__fsub_rn(-sn, c), 16.0f), y);
  return a;
}

// -- the warp: one bilinear sample under the keypoint affine ----------------

// Where the image lies in the frame that the keypoints' coordinates refer
// to: it holds the frame's rows oy .. oy + h - 1 and columns ox .. ox + w - 1
// (a band of a larger image on the sharded path; origin (0, 0) and the
// frame the image itself otherwise).  A sample is valid when its 2x2
// support lies in the frame; its pixels are then read at image row
// r0 = clamp(vi - oy, 0, h - 2), r1 = r0 + 1 and column c0 = clamp(ui - ox,
// 0, w - 2), c1 = c0 + 1, the plain version's 2-D index
// (ops/hash_sift.warp_patches), whose -1 on a 1-row or 1-column image is
// row or column 0.
struct Frame {
  int oy, ox;   // the image's first row and column in the frame
  int fh, fw;   // frame rows, columns
  int h, w;     // image rows, columns
};

__device__ __forceinline__ Frame whole_image(int h, int w) {
  return Frame{0, 0, h, w, h, w};
}

// Where a sample's 2x2 support (image rows r0, r1, columns c0, c1) is read:
// here the image in device memory; K4 (warp_patches.cu) has a fetch from the
// keypoint's window of the image staged in shared memory.  The four pixels
// are read at offsets from pixel (r0, c0) (r1 - r0 and c1 - c0 are 0 or
// 1), so that the whole image's fetch is its four loads at 0, 1, w, w + 1
// (K11 took 5% more time with a pointer per row).
struct GlobalFetch {
  const uint8_t* img;
  int w;

  __device__ __forceinline__ void operator()(int r0, int r1, int c0, int c1,
                                             float& p00, float& p01,
                                             float& p10, float& p11) const {
    const uint8_t* p = img + static_cast<size_t>(r0) * w + c0;
    const int down = (r1 - r0) * w, right = c1 - c0;
    p00 = __ldg(p);
    p01 = __ldg(p + right);
    p10 = __ldg(p + down);
    p11 = __ldg(p + down + right);
  }
};

// Patch pixels p0 .. p0 + 3 (p0 a multiple of 4, so one patch row) as one
// little-endian 32-bit word.  A sample is valid when its 2x2 support lies in
// the frame; it is then the reference's full-f32 lerp of the four pixels,
// rounded as min(trunc(t + 0.5), 255); else 0.  Only the fetch of the four
// pixels depends on where they are read from.  kBand: the image is a band
// of a larger frame.  Without it the frame is the image, a valid sample's
// support lies in the image, and the reads need no clamp (the same pixels;
// the clamps cost K4 a tenth of its time).
template <bool kBand, typename Fetch>
__device__ __forceinline__ uint32_t sample_word(const Fetch& fetch,
                                                const Frame& f,
                                                const Affine& a, int p0) {
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
    if (uf >= 0.0f && uf < static_cast<float>(f.fw - 1) && vf >= 0.0f
        && vf < static_cast<float>(f.fh - 1)) {
      const int ui = static_cast<int>(uf), vi = static_cast<int>(vf);
      const float du = __fsub_rn(u, uf), dv = __fsub_rn(v, vf);
      float p00, p01, p10, p11;
      if (kBand) {
        const int r0 = min(max(vi - f.oy, 0), f.h - 2);
        const int c0 = min(max(ui - f.ox, 0), f.w - 2);
        fetch(max(r0, 0), r0 + 1, max(c0, 0), c0 + 1, p00, p01, p10, p11);
      } else {
        fetch(vi, vi + 1, ui, ui + 1, p00, p01, p10, p11);
      }
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

// -- the histogram of a block of kBlockPatches patches ----------------------
//
// Replaces the body of the TPU kernels `_hs_hist_kernel`
// (efficient_features_tpu/ops/window_kernels.py:1656) and `_hs_fused_kernel`
// (:1358), whose histogram is nine one-hot (900, 16) matmuls per patch on
// the MXU.  As `patch_sift_responses` (ops/hash_sift.py): exact integer
// gradients over the 30x30 interior, magnitude sqrtf, orientation atan2f,
// an orientation bin oi and its fraction; each pixel votes mag*(1 - f) into
// bin oi and mag*f into bin oi + 1 (8 folds to 0), weighted by the (900, 16)
// core spatial weights; then L2 normalise, clip at 0.2, L2 normalise,
// trunc(512*d + 0.5) clipped to [0, 255], in the orientation-major layout
// e[o*16 + rc].
//
// What bounds it on the H100: instructions and their latency, not bytes.  A
// patch needs 900 atan2f / sqrtf and 2601 (pixel, spatial bin) pairs, each
// with two weighted votes: 5202 products and sums.  The first design gave
// each of a patch's 128 output bins a thread that walked its bin's whole
// window and added +0 for every pixel of another orientation: 20808 trips a
// patch, 3 of 4 adding nothing, and a warp of 15-, 11- and 10-wide windows
// ran to the widest.  Here each vote is added once and the warps are
// balanced:
//   - A block holds kBlockPatches = 8 patches and kHistThreads = 256
//     threads.  All of them compute the votes, two pixels (of patches p and
//     p + 4) a trip so that two atan2f chains overlap.  The first
//     kBinThreads = 128, one per (patch, spatial bin rc), then walk: the
//     thread owns all 8 orientations of its rc, walks rc's window once in
//     ascending pixel order and adds each pixel's two votes to bins oi and
//     (oi + 1) % 8 of its column of a shared-memory accumulator (dynamic
//     index, no bank conflict: column = walker).  The walk loads the next
//     pixel's bin and votes before it stores the current sums, so that a
//     step waits for one shared-memory round trip, not three, and keeps the
//     weight loads of the next kWeightsAhead steps in flight, so that no
//     step waits for the cache.
//   - Which rc a walker takes comes from the plan (ops/hash_sift.hist_plan,
//     a (16, 6) int32 table from Python): the bins sorted by window size,
//     four to a warp, so warp 0 walks the four 15x15 windows of 8 patches,
//     warp 1 the 11x15 and 15x11 ones, and so on.  Lane = 8 * (bin of the
//     warp) + patch.  The four walking warps run 225 + 165 + 150 + 121 steps
//     for the 8 x 2601 pairs: 98% of their lanes busy.
//   - The weights come in the plan's order, one float per pair (10.4 KB,
//     L1-resident), so the walk reads them at consecutive addresses.
//   - Empty work is skipped exactly.  A patch whose 1024 bytes are all 0 has
//     zero gradients and a zero row, so it gets neither votes nor a walk; a
//     block of only such patches writes its zero rows and leaves after the
//     first barrier.  The test is the patch words' warp vote (`nz`), the
//     same for every thread of the block: no thread leaves before a barrier
//     that another still reaches.
//   - atan2f, sqrtf and the divisions take their slow paths (a call, the
//     warp divided) on a zero operand.  Such operands get the functions'
//     exact values without the call: an axis-aligned gradient the angles
//     that IEEE atan2 gives there (+0, pi, +-pi/2, as float), a zero
//     gradient magnitude 0, a zero bin 0 after either normalisation.
//   - Shared memory (dynamic, `HistScratch`): the votes of 8 patches, 9 B a
//     pixel, and the patches (8 KB, later the accumulator): 71.4 KB a
//     block, so 3 blocks (24 patches, 24 warps) in flight per SM.
//
// Determinism and the sums: no atomics.  Bin (o, rc) is summed in ascending
// pixel order, as in the first design: the skipped terms were w * 0 = +0,
// and adding +0 to a sum that is >= 0 leaves it unchanged, so each bin is
// the same float sequence.  The two L2 norms keep the first design's tree:
// per orientation pair (2w, 2w + 1) the squares of each rc summed, then over
// rc the tree of a 32-lane xor shuffle (offsets 8, 4, 2, 1 on rc), then the
// four pair sums in order.  So the rows are those of the first design, byte
// for byte.

constexpr int kBlockPatches = 8;
constexpr int kBinThreads = 16 * kBlockPatches;   // a (patch, rc) each
constexpr int kHistThreads = 2 * kBinThreads;
constexpr int kHalfPixels = kBlockPatches / 2 * kPixels;
constexpr int kPlanCols = 6;   // rc, weight offset, y0, y1, x0, x1
constexpr int kVoteStride = kPixels + 1;  // odd: a warp's 8 patches hit
                                          // 8 banks apart
constexpr int kOiStride = kPixels + 4;
constexpr int kPartStride = 17;           // 16 rc + 1: no bank conflict
constexpr int kWeightsAhead = 8;          // weight loads a walk keeps going
constexpr float kPi = 3.14159274101257324f;       // pi, as float
constexpr float kHalfPi = 1.57079637050628662f;   // pi / 2, as float

struct HistScratch {
  union {
    uint8_t patch[kBlockPatches][kPatchPixels];  // until the votes are in
    struct {
      float acc[8][kBinThreads];                // [o][walker]
      float part[kBlockPatches][4][kPartStride];  // [p][o pair][rc]
      float pair[kBlockPatches][4];             // [p][o pair]
      uint8_t row[kBlockPatches][128];
    } h;
  };
  float lo[kBlockPatches][kVoteStride], hi[kBlockPatches][kVoteStride];
  uint8_t oi[kBlockPatches][kOiStride];
  // per patch, whether the words that each of 4 warps stored are nonzero
  uint8_t nz[kBlockPatches][4];
};

// The dynamic shared memory of the kernels that run `hist_block`.  Above
// the 48 KB a launch gets by default, so each kernel raises its limit once
// per device before its first launch, and asks for the largest shared
// memory carveout, in which 3 blocks fit an SM.  `done` is the kernel's
// own record of the devices it has raised (each kernel, and each
// instantiation of a kernel template, keeps one).
__host__ inline cudaError_t allow_hist_scratch(const void* kernel,
                                               bool (&done)[64]) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess || (dev < 64 && done[dev])) return rc;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(sizeof(HistScratch)));
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (rc == cudaSuccess && dev < 64) done[dev] = true;
  return rc;
}

// The caller has filled s.patch[p] for p < np and s.nz for every p of the
// block (an all-zero patch's nz is 0, as is that of p >= np).
__device__ __forceinline__ bool patch_live(const HistScratch& s, int p) {
  return *reinterpret_cast<const uint32_t*>(s.nz[p]) != 0u;
}

// x / n for x >= 0 and n >= FLT_EPSILON, rounded as __fdiv_rn; x = 0 gives
// +0 without the division's slow path.
__device__ __forceinline__ float div_nonneg(float x, float n) {
  const float r = __fdiv_rn(x == 0.0f ? 1.0f : x, n);
  return x == 0.0f ? 0.0f : r;
}

// Votes of pixel i of the block (patch i / kPixels), stored when the patch
// is live.  Computed either way, so that two calls in a row overlap.
__device__ __forceinline__ void pixel_votes(HistScratch& s, int i,
                                            float ori_scale) {
  const int p = i / kPixels;
  const int l = i - p * kPixels;
  const uint8_t* q = s.patch[p];
  const int yy = l / kInterior + 1, xx = l % kInterior + 1;
  const float dx = static_cast<float>(
      static_cast<int>(q[yy * kPatch + xx + 1]) - q[yy * kPatch + xx - 1]);
  const float dy = static_cast<float>(
      static_cast<int>(q[(yy - 1) * kPatch + xx]) - q[(yy + 1) * kPatch + xx]);
  // sqrtf and atan2f of the plain version; a zero operand takes their
  // values (dx and dy are +0 when zero: converted from an int) without the
  // slow paths
  const float m2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const float mag = m2 == 0.0f ? 0.0f : __fsqrt_rn(m2 == 0.0f ? 1.0f : m2);
  const bool axis = dx == 0.0f || dy == 0.0f;
  const float at = atan2f(axis ? 1.0f : dy, axis ? 1.0f : dx);
  const float on_axis = dy == 0.0f ? (dx < 0.0f ? kPi : 0.0f)
                                   : (dy > 0.0f ? kHalfPi : -kHalfPi);
  const float ob = __fmul_rn(ori_scale, axis ? on_axis : at);
  const float obf = floorf(ob);
  int oi = static_cast<int>(obf);
  const float of = __fsub_rn(ob, obf);
  if (oi < 0) oi += 8;
  if (oi >= 8) oi -= 8;
  const float v_hi = __fmul_rn(of, mag);
  if (patch_live(s, p)) {
    s.oi[p][l] = static_cast<uint8_t>(oi);
    s.lo[p][l] = __fsub_rn(mag, v_hi);
    s.hi[p][l] = v_hi;
  }
}

// The norm of v over the 128 bins of each patch, in the first design's
// tree; v is a walker's 8 orientations of (patch p, bin rc).  Every thread
// of the block calls it (it holds barriers); only the walkers' v count.
__device__ __forceinline__ float block_norm(const float (&v)[8], int p,
                                            int rc, HistScratch& s) {
  if (threadIdx.x < kBinThreads) {
#pragma unroll
    for (int w = 0; w < 4; ++w)
      s.h.part[p][w][rc] = __fadd_rn(__fmul_rn(v[2 * w], v[2 * w]),
                                     __fmul_rn(v[2 * w + 1], v[2 * w + 1]));
  }
  __syncthreads();
  if (threadIdx.x < 4 * kBlockPatches) {
    const float* a = s.h.part[threadIdx.x / 4][threadIdx.x % 4];
    float b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = __fadd_rn(a[j], a[j + 8]);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = __fadd_rn(b[j], b[j + 4]);
    s.h.pair[threadIdx.x / 4][threadIdx.x % 4] =
        __fadd_rn(__fadd_rn(b[0], b[2]), __fadd_rn(b[1], b[3]));
  }
  __syncthreads();
  const float* e = s.h.pair[p];
  return fmaxf(__fsqrt_rn(__fadd_rn(__fadd_rn(__fadd_rn(e[0], e[1]), e[2]),
                                    e[3])),
               FLT_EPSILON);
}

// Rows out_rows[0 .. np) (np <= kBlockPatches, 128 B each, 8-byte aligned)
// of the block's patches.  Every thread of the kHistThreads-thread block
// calls it, after filling s.patch and s.nz (no barrier needed before);
// `nonzero` says whether any patch word this thread stored is nonzero.
// plan: hist_plan's (16, kPlanCols) int32 table; wpack: its weights.
__device__ __forceinline__ void hist_block(HistScratch& s, int np,
                                           bool nonzero,
                                           const int* __restrict__ plan,
                                           const float* __restrict__ wpack,
                                           float ori_scale,
                                           uint8_t* __restrict__ out_rows) {
  const int t = threadIdx.x;
  uint2* out8 = reinterpret_cast<uint2*>(out_rows);
  const bool mine = t * 8 < np * 128;   // this thread's 8 bytes of output
  if (!__syncthreads_or(nonzero)) {
    if (mine) out8[t] = make_uint2(0u, 0u);
    return;                             // the same for the whole block
  }

  for (int i = t; i < kHalfPixels; i += kHistThreads) {
    pixel_votes(s, i, ori_scale);
    pixel_votes(s, i + kHalfPixels, ori_scale);
  }
  __syncthreads();   // votes complete; s.patch is free for s.h

  // walk: walker (patch p, plan row g) adds each pixel's two votes once
  const bool walker = t < kBinThreads;
  const int lane = t % 32;
  const int p = lane % kBlockPatches;
  const int* row =
      plan + ((t / 32) % 4 * 4 + lane / kBlockPatches) * kPlanCols;
  const int rc = __ldg(row);
  float* acc = &s.h.acc[0][t % kBinThreads];
  if (walker) {
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[o * kBinThreads] = 0.0f;
  }
  if (walker && patch_live(s, p)) {
    const float* w = wpack + __ldg(row + 1);
    const int y0 = __ldg(row + 2), x0 = __ldg(row + 4);
    const int width = __ldg(row + 5) - x0;
    const int n = (__ldg(row + 3) - y0) * width;
    const uint8_t* oi = s.oi[p];
    const float* lo = s.lo[p];
    const float* hi = s.hi[p];
    int l = (y0 - 1) * kInterior + (x0 - 1), xx = 0;
    int o0 = oi[l];
    float v_lo = lo[l], v_hi = hi[l];
    float wq[kWeightsAhead];   // the weights of the next steps, in flight
#pragma unroll
    for (int k = 0; k < kWeightsAhead; ++k) wq[k] = __ldg(w + min(k, n - 1));
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float wt = wq[0];
#pragma unroll
      for (int k = 0; k + 1 < kWeightsAhead; ++k) wq[k] = wq[k + 1];
      wq[kWeightsAhead - 1] = __ldg(w + min(i + kWeightsAhead, n - 1));
      // the next pixel (the last step reads one past the window, clamped)
      const bool wrap = ++xx == width;
      xx = wrap ? 0 : xx;
      l += wrap ? kInterior - width + 1 : 1;
      const int ln = min(l, kPixels - 1);
      const int o0n = oi[ln];
      const float lon = lo[ln], hin = hi[ln];
      const int o1 = (o0 + 1) & 7;
      const float a0 = acc[o0 * kBinThreads], a1 = acc[o1 * kBinThreads];
      acc[o0 * kBinThreads] = __fadd_rn(a0, __fmul_rn(wt, v_lo));
      acc[o1 * kBinThreads] = __fadd_rn(a1, __fmul_rn(wt, v_hi));
      o0 = o0n;
      v_lo = lon;
      v_hi = hin;
    }
  }
  float d[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) d[o] = walker ? acc[o * kBinThreads] : 0.0f;

  const float nrm = block_norm(d, p, rc, s);
#pragma unroll
  for (int o = 0; o < 8; ++o) d[o] = fminf(div_nonneg(d[o], nrm), 0.2f);
  const float nrm2 = block_norm(d, p, rc, s);
  if (walker) {
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float q = fminf(fmaxf(truncf(__fadd_rn(
                                      __fmul_rn(512.0f, div_nonneg(d[o], nrm2)),
                                      0.5f)),
                                  0.0f),
                            255.0f);
      s.h.row[p][o * 16 + rc] = static_cast<uint8_t>(q);
    }
  }
  __syncthreads();
  if (mine) out8[t] = reinterpret_cast<const uint2*>(s.h.row)[t];
}

}  // namespace hs
