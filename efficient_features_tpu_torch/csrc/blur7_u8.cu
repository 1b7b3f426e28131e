// K14: the descriptors' 7x7 Gaussian blur of a u8 pyramid level.
//
// Replaces no TPU kernel: the JAX package blurs with XLA ops
// (`gaussian_blur7_u8` in efficient_features_tpu/ops/image.py), and the
// port's plain version, `ops/image.gaussian_blur7_u8`, is about 34 int32
// torch ops a level.  This kernel computes that function bit for bit: the
// seven 16-bit fixed-point taps of `semantics.gaussian_kernel7_fixed`
// (passed in by the host, summing to 2^16), REFLECT_101 borders on both
// axes (`semantics.reflect101_index`), the horizontal pass first, each
// pass (sum of taps x pixels + 2^15) >> 16, a value in [0, 255].  All of
// it is int32 integer math.
//
// What bounds it on the H100: bytes, in principle.  Each level is read and
// written once (about 51 MB for the 8 levels under a 2160x3840 frame, 15
// us at 3.35 TB/s).  The arithmetic, 8 multiplies and 14 adds a pixel (the
// taps are symmetric, so a pass pairs the pixels that share one), runs on
// the integer pipes; that instruction rate, with the byte unpacking and
// the staging around it, and each small level's one-block latency set the
// time.
//
// Design: a 256-thread block per tile of kTileH rows x kTileW columns.
//   - Stage.  The tile's (kTileH + 6) rows of columns x0 - 4 .. x0 +
//     kTileW + 3 go into shared memory once, as 32-bit words, each formed
//     from the two aligned words around it (a funnel shift).  A word whose
//     columns reach past the level's left or right edge takes its bytes
//     through REFLECT_101 from the 4 columns that its reflection spans,
//     loaded the same way and permuted; rows are mapped through REFLECT_101
//     for every word.  A thread starts all its loads before it uses any,
//     so a block waits on device memory once; only a word whose aligned
//     words would leave the level's bytes (a view that starts unaligned,
//     the level's last bytes) is read byte by byte.
//   - Row pass.  A warp takes a staged row, a lane 4 output columns from 3
//     staged words, and writes the 4 values as an int4 of a (kTileH + 6) x
//     kTileW tile in shared memory.
//   - Column pass.  A warp takes kTileH / 8 consecutive output rows, a lane
//     the same 4 columns of each, from its column of the row-pass tile.
//     Rows of the level start at any byte (its width need not be a
//     multiple of 4), so each lane stores the aligned word of its row that
//     ends in its own last byte, the rest taken from the lane to its left
//     (a shuffle), and the tile's first and last partial words byte by byte.
// Measured against other designs on the H100 (a block of 512 threads, 16-
// or 48-row tiles, one resident wave of blocks that loads the next tile
// while it blurs this one, a warp walking a 32-row strip with a register
// window and no shared memory): each took as long or longer.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"
#include "u8_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 32;                      // ops/image.BLUR_TILE_H
constexpr int kTileW = 128;                     // ops/image.BLUR_TILE_W
constexpr int kHalo = 3;
constexpr int kRows = kTileH + 2 * kHalo;       // staged rows
constexpr int kInWords = kTileW / 4 + 2;        // staged words a row
constexpr int kOutWords = kTileW / 4;           // a lane's word each
constexpr int kRowsPerWarp = kTileH / kWarps;
constexpr int kLoadGroups = kThreads / kInWords;   // threads a staged row
constexpr int kLoadIters = (kRows + kLoadGroups - 1) / kLoadGroups;
constexpr int kBits = 16;                       // semantics.BLUR_BITS
constexpr int kHalf = 1 << (kBits - 1);
static_assert(kOutWords == 32, "a warp's lanes cover one tile row");

struct Taps {
  int k[7];
};

// The REFLECT_101 index of i in a side of n >= 4, i clamped first to
// -3 .. n + 2 (a column or row past those feeds no stored output).
__device__ __forceinline__ int reflect101(int i, int n) {
  i = abs(min(max(i, -kHalo), n - 1 + kHalo));
  return i >= n ? 2 * (n - 1) - i : i;
}

__device__ __forceinline__ int byte_of(uint32_t word, int b) {
  return static_cast<int>(__byte_perm(word, 0u, 0x4440u | b));
}

// Columns gx .. gx + 3 of a level row as one word, column gx in its low
// byte, through REFLECT_101, byte by byte.
__device__ __forceinline__ uint32_t reflected_word(const uint8_t* row, int gx,
                                                   int w) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    v |= static_cast<uint32_t>(__ldg(row + reflect101(gx + b, w))) << (8 * b);
  return v;
}

// One pass's four outputs: p[o .. o + 6] under the taps, rounded.  The
// taps are symmetric (checked by `eff_blur7_u8`), so the sum pairs the
// pixels that share a tap: the same integers, in fewer multiplies.
__device__ __forceinline__ int blur1(int p0, int p1, int p2, int p3, int p4,
                                     int p5, int p6, const Taps& taps) {
  const int acc = kHalf + taps.k[0] * (p0 + p6) + taps.k[1] * (p1 + p5)
                  + taps.k[2] * (p2 + p4) + taps.k[3] * p3;
  return acc >> kBits;
}

__global__ void __launch_bounds__(kThreads)
blur7_u8_kernel(const uint8_t* __restrict__ src, int h, int w, Taps taps,
                uint8_t* __restrict__ dst) {
  // s_in[r][j]: row y0 - 3 + r, columns x0 - 4 + 4j .. + 3
  __shared__ uint32_t s_in[kRows * kInWords];
  // s_h[r][q]: the row pass of row y0 - 3 + r, columns x0 + 4q .. + 3
  __shared__ int4 s_h[kRows * kOutWords];
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // stage: thread (g, j) takes word j of rows g, g + kLoadGroups, ...; its
  // loads all start before any is used.  Offsets are counted in bytes
  // from the aligned word at or before src (the level has fewer than 2^31
  // pixels); the level's bytes are [mis, end).
  const int g = threadIdx.x / kInWords, j = threadIdx.x - g * kInWords;
  if (g < kLoadGroups) {
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3u);
    const uint32_t* base = reinterpret_cast<const uint32_t*>(src - mis);
    const int end = mis + h * w;
    const int gx = x0 - 4 + 4 * j;
    // the word's 4 columns through REFLECT_101 lie in the 4 columns from
    // sc (gx itself inside the level); byte b of the word is byte sel_b of
    // those 4
    int sc = gx;
    uint32_t sel = 0x3210u;
    if (gx < 0 || gx + 4 > w) {
      int c[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) c[b] = reflect101(gx + b, w);
      sc = min(min(c[0], c[1]), min(c[2], c[3]));
      sel = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        sel |= static_cast<uint32_t>(c[b] - sc) << (4 * b);
    }
    int row[kLoadIters], shift[kLoadIters];
    uint32_t lo_w[kLoadIters], hi_w[kLoadIters];
    bool inside[kLoadIters];
#pragma unroll
    for (int u = 0; u < kLoadIters; ++u) {
      const int r = min(g + u * kLoadGroups, kRows - 1);
      row[u] = reflect101(y0 - kHalo + r, h) * w;
      const int e = mis + row[u] + sc;
      const int first = e & ~3;
      shift[u] = (e & 3) * 8;
      inside[u] = first >= mis && first + (shift[u] ? 8 : 4) <= end;
      lo_w[u] = inside[u] ? __ldg(base + (first >> 2)) : 0u;
      hi_w[u] = inside[u] && shift[u] ? __ldg(base + (first >> 2) + 1) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kLoadIters; ++u) {
      const int r = g + u * kLoadGroups;
      if (r >= kRows) break;
      s_in[r * kInWords + j] = inside[u]
          ? __byte_perm(__funnelshift_r(lo_w[u], hi_w[u], shift[u]), 0u, sel)
          : reflected_word(src + row[u], gx, w);
    }
  }
  __syncthreads();

  // row pass: output column x0 + 4 lane + o reads staged bytes 4 lane + o
  // + 1 .. + 7, bytes 1 .. 10 of the lane's three words
  for (int r = warp; r < kRows; r += kWarps) {
    const uint32_t* in = s_in + r * kInWords + lane;
    const uint32_t a = in[0], b = in[1], c = in[2];
    int p[10];
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = byte_of(a, k + 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) p[3 + k] = byte_of(b, k);
#pragma unroll
    for (int k = 0; k < 3; ++k) p[7 + k] = byte_of(c, k);
    int q[4];
#pragma unroll
    for (int o = 0; o < 4; ++o)
      q[o] = blur1(p[o], p[o + 1], p[o + 2], p[o + 3], p[o + 4], p[o + 5],
                   p[o + 6], taps);
    s_h[r * kOutWords + lane] = make_int4(q[0], q[1], q[2], q[3]);
  }
  __syncthreads();

  // column pass: output row y0 + r reads row-pass rows r .. r + 6
  const int r0 = warp * kRowsPerWarp;
  if (y0 + r0 >= h) return;                     // the whole warp
  int4 col[kRowsPerWarp + 6];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp + 6; ++i)
    col[i] = s_h[(r0 + i) * kOutWords + lane];
  const int c_hi = min(x0 + kTileW, w);
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int y = y0 + r0 + k;
    if (y >= h) break;                          // the whole warp
    const int4* v = col + k;
    const uint32_t word =
        static_cast<uint32_t>(blur1(v[0].x, v[1].x, v[2].x, v[3].x, v[4].x,
                                    v[5].x, v[6].x, taps))
        | static_cast<uint32_t>(blur1(v[0].y, v[1].y, v[2].y, v[3].y, v[4].y,
                                      v[5].y, v[6].y, taps)) << 8
        | static_cast<uint32_t>(blur1(v[0].z, v[1].z, v[2].z, v[3].z, v[4].z,
                                      v[5].z, v[6].z, taps)) << 16
        | static_cast<uint32_t>(blur1(v[0].w, v[1].w, v[2].w, v[3].w, v[4].w,
                                      v[5].w, v[6].w, taps)) << 24;
    // the row's aligned word that ends in this lane's last byte: its first
    // m bytes are the left lane's last m (m, the misalignment of column
    // x0); the left of lane 0 lies outside the tile and is not stored
    uint8_t* out = dst + y * w;
    const uint32_t m = static_cast<uint32_t>(
        (reinterpret_cast<uintptr_t>(out) + x0) & 3u);
    const uint32_t left = __shfl_up_sync(0xffffffffu, word, 1);
    const uint32_t sel = 0x7654u - 0x1111u * m;
    const int c = x0 + 4 * lane - static_cast<int>(m);
    store_u8x4(out, c, x0, c_hi, __byte_perm(left, word, sel));
    if (lane == 31 && m != 0)                   // the tile's last m bytes
      store_u8x4(out, c + 4, x0, c_hi, __byte_perm(word, 0u, sel));
  }
}

}  // namespace

extern "C" int eff_blur7_u8(const uint8_t* src, int h, int w,
                            const int32_t* taps, uint8_t* dst,
                            void* stream) {
  if (h < 4 || w < 4 || (h + kTileH - 1) / kTileH > 65535 ||
      static_cast<int64_t>(h) * w > (int64_t{1} << 31) - 8)
    return cudaErrorInvalidValue;
  Taps k;
  int64_t sum = 0;
  for (int i = 0; i < 7; ++i) {
    if (taps[i] < 0 || taps[i] != taps[6 - i]) return cudaErrorInvalidValue;
    k.k[i] = taps[i];
    sum += taps[i];
  }
  if (sum != (int64_t{1} << kBits)) return cudaErrorInvalidValue;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  blur7_u8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, h, w, k, dst);
  return cudaGetLastError();
}
