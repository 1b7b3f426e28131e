// K13: exact top-`quota` keypoint selection from K1's cells, with fixed
// shapes and no host read.
//
// No TPU kernel: the JAX package selects with XLA ops
// (efficient_features_tpu/ops/detect.py:select_topk_cells) and decides a
// tie case with `lax.cond`.  The plain version is the port's
// ops/detect.select_topk_cells (torch ops, bit for bit JAX's slots).  K13
// computes the same slots in three kernels with no library call or torch op
// between them (ops/detect_kernels.select_cells):
//   1. `cells_live_kernel`, a CTA per tile of kTile 8x8 blocks, a thread
//      per block: its 8 row bytes of survivors (its 8 `cellbits` column
//      bytes, transposed), and the key (desc(value) << 32) | index of its
//      winner, the minimum over its 8 cells of (desc(canonical cellmax)
//      << 32) | cellrow * w + x; desc() maps float32 bits to a uint32
//      that orders them descending.  Only a block with a survivor ("live")
//      writes its key, to its tile's region of `live`, and the tile's count
//      to `counts`: dead blocks never enter the selection, and the keys are
//      unique, so the order in which a tile writes them does not matter.
//   2. `cells_bucket_kernel`, one CTA of kThreads threads, which reads the
//      counts on the device:
//      a. The kept blocks.  kq = min(quota, blocks).  If L live keys >
//         kq, an MSD radix select over the bits that vary among them (8
//         a pass, the histogram in shared memory) finds the kq-th key, and
//         the keys up to it are kept: the plain version's first kq of its
//         stable sort of every block, since a dead block's key comes after
//         every live one.  Else every live block is kept.  The keys sit in
//         shared memory while there are at most kCap of them.  A kept key
//         becomes (desc(value) << 32) | (block row << s) | block column,
//         whose order is (value desc, block number), and its run, key >> s,
//         is (value, block row).
//      b. The kept blocks go to up to kBuckets buckets: about log2(kept)
//         bits of their run (at most kBucketBits) from the highest in which
//         the runs differ down, an order that the runs' order refines.
//         With each block go its row bytes; the exclusive scans of the
//         buckets' block and survivor counts are written out.  A bucket
//         holds whole runs, and no sort is needed: the order within a
//         bucket is found by counting.
//   3. `cells_place_kernel`, a thread per kept block (and per output slot):
//      the plain version orders the kept blocks' row segments by (value,
//      first flat index), which for a run of blocks of one value and one
//      block row is row 0 of each block of the run, then row 1, and so on
//      (a run of one block, no tie, gives its rows in order).  So a block's
//      row r starts at: the survivors of the buckets before its own, of the
//      runs before its own in its bucket, of rows 0..r-1 of its run, and of
//      row r of the blocks before it in its run, each counted over its
//      bucket.  Its survivors go to those slots below the quota; slots past
//      all survivors get (0, 0, 0, false).
// Every value is an integer or float32 bits carried through unchanged, so
// the slots are bit-identical to the plain version's.
//
// What bounds it on the H100: the one CTA of step 2 (its passes over the
// live and kept keys are serial steps of one SM) and three launches a
// level; the bytes (9 a cell read, 13 a slot written) take microseconds,
// and step 3's counting is spread over the card.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eff_kernels.h"

namespace {

constexpr int kTile = 1024;          // 8x8 blocks (threads) per CTA of
                                     // cells_live_kernel
constexpr int kThreads = 1024;       // the one CTA of cells_bucket_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kCap = 24000;          // keys it holds in shared memory
constexpr int kBucketBits = 12;
constexpr int kBuckets = 1 << kBucketBits;
constexpr int kPlaceThreads = 128;
// a run of at most this many blocks sums its row counts in 16-bit lanes
constexpr int kLaneRun = 8191;
// the keys, then two histograms of kBuckets
constexpr size_t kSmemBytes = sizeof(uint64_t) * kCap
                              + 2 * sizeof(unsigned) * kBuckets;
constexpr uint64_t kNone = ~0ull;    // no live key has every bit set
constexpr uint64_t kHigh = 0xFFFFFFFF00000000ull;
static_assert(kWarps == 32, "block_scan scans one value per warp in a warp");
static_assert(kBuckets == 4 * kThreads, "a thread scans 4 buckets");

// float32 -> uint32 whose ascending order is the float's descending order
// (no NaN); -0.0 is canonicalised to +0.0 first
__device__ __forceinline__ uint32_t desc_bits(float v) {
  if (v == 0.f) v = 0.f;
  const int32_t b = __float_as_int(v);
  const int32_t asc = b ^ ((b >> 31) & 0x7FFFFFFF);
  return ~(static_cast<uint32_t>(asc) ^ 0x80000000u);
}

__device__ __forceinline__ float from_desc(uint32_t d) {
  const int32_t asc = static_cast<int32_t>(~d ^ 0x80000000u);
  return __int_as_float(asc ^ ((asc >> 31) & 0x7FFFFFFF));
}

// This thread's index in a shared array whose fill count is *n: the
// active lanes of a warp take consecutive indices with one atomic.
__device__ __forceinline__ int append(int* n) {
  const unsigned active = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(active) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(n, __popc(active));
  base = __shfl_sync(active, base, leader);
  return base + __popc(active & ((1u << lane) - 1u));
}

// hist[d] += 1, one atomic per distinct d among the active lanes
__device__ __forceinline__ void count(unsigned* hist, unsigned d) {
  const unsigned peers = __match_any_sync(__activemask(), d);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[d],
                                                         __popc(peers));
}

// the 8x8 bit matrix of a word, transposed: bit k of byte c becomes bit c
// of byte k (ops/detect._transpose8)
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  return x ^ t ^ (t << 28);
}

__global__ void __launch_bounds__(kTile)
cells_live_kernel(const float* __restrict__ cellmax,
                  const int32_t* __restrict__ cellrow,
                  const uint8_t* __restrict__ cellbits, int w, int ld,
                  int w8, int nb, uint64_t* __restrict__ live,
                  int32_t* __restrict__ counts, uint64_t* __restrict__ rows) {
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  const int b = blockIdx.x * kTile + static_cast<int>(threadIdx.x);
  uint64_t best = kNone;
  if (b < nb) {
    const int i = b / w8, x0 = (b - i * w8) * 8;
    uint64_t cols = 0;
    for (int c = 0; c < 8 && x0 + c < w; ++c) {
      const size_t o = static_cast<size_t>(i) * ld + x0 + c;
      cols |= static_cast<uint64_t>(cellbits[o]) << (8 * c);
      const float v = cellmax[o];
      if (v == __int_as_float(0xff800000)) continue;        // -inf: none
      const uint64_t key = (static_cast<uint64_t>(desc_bits(v)) << 32)
          | static_cast<uint32_t>(cellrow[o] * w + x0 + c);
      best = key < best ? key : best;
    }
    rows[b] = transpose8(cols);
  }
  if (best != kNone) live[blockIdx.x * kTile + append(&s_n)] = best;
  __syncthreads();
  if (threadIdx.x == 0) counts[blockIdx.x] = s_n;
}

struct Shared {
  int warp[kWarps];
  int total;
  int n;
  int pick[2];
  unsigned hist[256];
  uint64_t red[2 * kWarps];
};

// Exclusive prefix of v over the CTA's threads in thread order; *total
// the sum.  Every thread must call it.
__device__ int block_scan(int v, int* total, Shared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) s.warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int own = s.warp[lane];
    int wincl = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, wincl, o);
      if (lane >= o) wincl += n;
    }
    s.warp[lane] = wincl - own;
    if (lane == 31) s.total = wincl;
  }
  __syncthreads();
  const int out = s.warp[warp] + incl - v;
  *total = s.total;
  __syncthreads();
  return out;
}

// f(key) for every live key of cells_live_kernel's tiles, warps over tiles
template <class F>
__device__ __forceinline__ void for_each_live(const uint64_t* live,
                                              const int32_t* counts,
                                              int tiles, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < tiles; c += kWarps) {
    const int n = __ldg(counts + c);
    const uint64_t* src = live + static_cast<size_t>(c) * kTile;
    for (int e0 = 0; e0 < n; e0 += 4 * 32) {
      uint64_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * 32 + lane;
        v[u] = e < n ? __ldg(src + e) : kNone;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (v[u] != kNone) f(v[u]);
    }
  }
}

// a and o over the CTA: every thread gets the AND of the a's and the OR of
// the o's.  Every thread must call it.
__device__ void block_and_or(uint64_t& a, uint64_t& o, Shared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 16; d > 0; d >>= 1) {
    a &= __shfl_xor_sync(0xffffffffu, a, d);
    o |= __shfl_xor_sync(0xffffffffu, o, d);
  }
  if (lane == 0) {
    s.red[warp] = a;
    s.red[kWarps + warp] = o;
  }
  __syncthreads();
  a = kNone;
  o = 0;
  for (int k = 0; k < kWarps; ++k) {
    a &= s.red[k];
    o |= s.red[kWarps + k];
  }
  __syncthreads();
}

// The key of rank r (from 0) among the unique keys that visit(f) hands to
// f, at least two of them: an MSD radix select over the bits in which they
// differ, 8 a pass.
template <class Visit>
__device__ uint64_t select_rank(Visit visit, int r, Shared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t all_and = kNone, all_or = 0;
  visit([&](uint64_t x) { all_and &= x; all_or |= x; });
  block_and_or(all_and, all_or, s);
  const int top = 63 - __clzll(static_cast<long long>(all_and ^ all_or));
  uint64_t known = ~((2ull << top) - 1);   // the bits above `top`
  uint64_t prefix = all_and & known;
  for (int hi = top; hi >= 0; hi -= 8) {
    const int lo = hi >= 7 ? hi - 7 : 0;
    const uint64_t digit = ((2ull << (hi - lo)) - 1) << lo;
    for (int t = threadIdx.x; t < 256; t += kThreads) s.hist[t] = 0;
    __syncthreads();
    visit([&](uint64_t x) {
      if ((x & known) == prefix)
        count(s.hist, static_cast<unsigned>((x & digit) >> lo));
    });
    __syncthreads();
    if (warp == 0) {
      unsigned c[8], own = 0;
      for (int j = 0; j < 8; ++j) {
        c[j] = s.hist[lane * 8 + j];
        own += c[j];
      }
      unsigned incl = own;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned n = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += n;
      }
      unsigned below = incl - own;
      const unsigned rr = static_cast<unsigned>(r);
      if (below <= rr && rr < incl) {
        for (int j = 0; j < 8; ++j) {
          if (rr < below + c[j]) {
            s.pick[0] = lane * 8 + j;
            s.pick[1] = static_cast<int>(below);
            break;
          }
          below += c[j];
        }
      }
    }
    __syncthreads();
    r -= s.pick[1];
    prefix |= static_cast<uint64_t>(s.pick[0]) << lo;
    known |= digit;
    __syncthreads();
  }
  return prefix;
}

// the bucket of a run: its bits lo .. lo + nbits - 1
__device__ __forceinline__ unsigned bucket_of(uint64_t run, int lo,
                                              int nbits) {
  return static_cast<unsigned>(run >> lo) & ((1u << nbits) - 1u);
}

// Exclusive prefix of v over the CTA's threads in thread order (64 bits);
// *total the sum.  Every thread must call it.
__device__ uint64_t block_scan64(uint64_t v, uint64_t* total, Shared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) s.red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint64_t own = s.red[lane];
    uint64_t wincl = own;
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t n = __shfl_up_sync(0xffffffffu, wincl, o);
      if (lane >= o) wincl += n;
    }
    s.red[lane] = wincl - own;
    if (lane == 31) s.red[kWarps] = wincl;
  }
  __syncthreads();
  const uint64_t out = s.red[warp] + incl - v;
  *total = s.red[kWarps];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads, 1)
cells_bucket_kernel(const uint64_t* __restrict__ live,
                    const int32_t* __restrict__ counts, int tiles,
                    const uint64_t* __restrict__ rows, int w, int w8,
                    int shift, int kq, uint64_t* kglobal, uint64_t* rtmp,
                    uint64_t* __restrict__ bkeys,
                    uint64_t* __restrict__ brows,
                    int32_t* __restrict__ boff, int32_t* __restrict__ soff,
                    int32_t* __restrict__ hdr) {
  extern __shared__ uint64_t s_keys[];
  unsigned* cursor = reinterpret_cast<unsigned*>(s_keys + kCap);
  unsigned* survivors = cursor + kBuckets;
  __shared__ Shared s;
  const int tid = threadIdx.x, lane = tid & 31;

  // a. the kept blocks, re-keyed, and the AND and OR of their runs
  int part = 0;
  for (int c = tid; c < tiles; c += kThreads) part += __ldg(counts + c);
  int nlive;
  block_scan(part, &nlive, s);
  const int m = min(nlive, kq);
  uint64_t* kept = m <= kCap ? s_keys : kglobal;
  const uint32_t wu = static_cast<uint32_t>(w);
  uint64_t run_and = kNone, run_or = 0;
  auto rekey = [&](uint64_t x) -> uint64_t {      // winner index -> block
    const uint32_t idx = static_cast<uint32_t>(x), y = idx / wu;
    const uint64_t key = (x & kHigh) | ((y >> 3) << shift)
                         | ((idx - y * wu) >> 3);
    run_and &= key >> shift;
    run_or |= key >> shift;
    return key;
  };
  if (tid == 0) s.n = 0;
  __syncthreads();
  if (nlive <= kCap) {
    for_each_live(live, counts, tiles,
                  [&](uint64_t x) { s_keys[append(&s.n)] = x; });
    __syncthreads();
    if (nlive > kq) {
      const uint64_t last = select_rank([&](auto f) {
        for (int e = tid; e < nlive; e += kThreads) f(s_keys[e]);
      }, kq - 1, s);
      // keep the keys up to `last`, in place: a tile is read before any
      // of it is written, and a key only moves down
      int out = 0;
      for (int base = 0; base < nlive; base += kThreads) {
        const int e = base + tid;
        const uint64_t x = e < nlive ? s_keys[e] : kNone;
        const bool keep = x <= last;
        int total;
        const int pos = block_scan(keep, &total, s);
        if (keep) s_keys[out + pos] = rekey(x);
        out += total;
        __syncthreads();
      }
    } else {
      for (int e = tid; e < nlive; e += kThreads) s_keys[e] = rekey(s_keys[e]);
    }
  } else {
    const uint64_t last = nlive > kq ? select_rank([&](auto f) {
      for_each_live(live, counts, tiles, f);
    }, kq - 1, s) : kNone;
    for_each_live(live, counts, tiles, [&](uint64_t x) {
      if (x <= last) kept[append(&s.n)] = rekey(x);
    });
  }
  block_and_or(run_and, run_or, s);     // its syncs publish `kept`

  // b. buckets: about log2(m) bits of a run, at most kBucketBits, from the
  // highest in which the runs differ down (fewer if that is near bit 0)
  const uint64_t differ = m > 1 ? run_and ^ run_or : 0;
  const int top = differ ? 63 - __clzll(static_cast<long long>(differ)) : 0;
  const int lo = max(top + 1 - min(kBucketBits, 32 - __clz(m)), 0);
  const int nbits = differ ? top - lo + 1 : 0;
  const int nb = 1 << nbits;
  for (int d = tid; d < nb; d += kThreads) {
    cursor[d] = 0;
    survivors[d] = 0;
  }
  __syncthreads();
  const uint32_t cmask = (1u << shift) - 1u;
  auto block_of = [&](uint64_t key) -> int {
    const uint32_t low = static_cast<uint32_t>(key);
    return static_cast<int>((low >> shift) * w8 + (low & cmask));
  };
  for (int t = tid; t < m; t += kThreads) {
    const uint64_t key = kept[t];
    const unsigned d = bucket_of(key >> shift, lo, nbits);
    const uint64_t r = __ldg(rows + block_of(key));
    rtmp[t] = r;
    const unsigned n = __popcll(r);
    // one atomic a warp where its lanes share a bucket (ties), else one
    // a lane
    const unsigned active = __activemask();
    const int leader = __ffs(active) - 1;
    if (__all_sync(active, d == __shfl_sync(active, d, leader))) {
      const unsigned sum = __reduce_add_sync(active, n);
      if (lane == leader) {
        atomicAdd(&cursor[d], __popc(active));
        atomicAdd(&survivors[d], sum);
      }
    } else {
      atomicAdd(&cursor[d], 1u);
      atomicAdd(&survivors[d], n);
    }
  }
  __syncthreads();
  // exclusive scans of the block (high half) and survivor counts, 4
  // buckets a thread
  {
    uint64_t c[4], sum = 0;
    for (int k = 0; k < 4; ++k) {
      const int d = 4 * tid + k;
      c[k] = d < nb ? (static_cast<uint64_t>(cursor[d]) << 32) | survivors[d]
                    : 0;
      sum += c[k];
    }
    uint64_t total;
    uint64_t base = block_scan64(sum, &total, s);
    for (int k = 0; k < 4; ++k) {
      const int d = 4 * tid + k;
      if (d < nb) {
        boff[d] = static_cast<int32_t>(base >> 32);
        soff[d] = static_cast<int32_t>(base);
      }
      cursor[d] = static_cast<unsigned>(base >> 32);
      base += c[k];
    }
    if (tid == 0) {
      boff[nb] = static_cast<int32_t>(total >> 32);
      hdr[0] = m;
      hdr[1] = static_cast<int32_t>(total);
      hdr[2] = lo;
      hdr[3] = nbits;
    }
  }
  __syncthreads();
  for (int t = tid; t < m; t += kThreads) {
    const uint64_t key = kept[t];
    const unsigned d = bucket_of(key >> shift, lo, nbits);
    const unsigned active = __activemask();
    const int leader = __ffs(active) - 1;
    unsigned pos;
    if (__all_sync(active, d == __shfl_sync(active, d, leader))) {
      unsigned base = 0;
      if (lane == leader) base = atomicAdd(&cursor[d], __popc(active));
      pos = __shfl_sync(active, base, leader)
            + __popc(active & ((1u << lane) - 1u));
    } else {
      pos = atomicAdd(&cursor[d], 1u);
    }
    bkeys[pos] = key;
    brows[pos] = rtmp[t];
  }
}

// the survivors of each row of a block, byte k the count of row k
__device__ __forceinline__ uint64_t row_counts(uint64_t r) {
  r = r - ((r >> 1) & 0x5555555555555555ull);
  r = (r & 0x3333333333333333ull) + ((r >> 2) & 0x3333333333333333ull);
  return (r + (r >> 4)) & 0x0F0F0F0F0F0F0F0Full;
}

__global__ void __launch_bounds__(kPlaceThreads)
cells_place_kernel(const uint64_t* __restrict__ bkeys,
                   const uint64_t* __restrict__ brows,
                   const int32_t* __restrict__ boff,
                   const int32_t* __restrict__ soff,
                   const int32_t* __restrict__ hdr, int shift, int w8,
                   int quota, int32_t* __restrict__ ys,
                   int32_t* __restrict__ xs, float* __restrict__ resp,
                   uint8_t* __restrict__ valid) {
  const int j = blockIdx.x * kPlaceThreads + threadIdx.x;
  const int m = hdr[0], total = hdr[1];
  if (j < quota && j >= total) {
    ys[j] = 0;
    xs[j] = 0;
    resp[j] = 0.f;
    valid[j] = 0;
  }
  if (j >= m) return;
  const uint64_t key = bkeys[j], run = key >> shift, own = brows[j];
  const unsigned d = bucket_of(run, hdr[2], hdr[3]);
  int before = soff[d];                // survivors ahead of this run
  // per row, the survivors of the run and those of its blocks before this
  // one: rows 0, 2, 4, 6 and 1, 3, 5, 7 in 16-bit lanes, or one by one
  uint64_t even = 0, odd = 0, even_ahead = 0, odd_ahead = 0;
  int row_total[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int row_before[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const bool lanes = w8 <= kLaneRun;
  auto add = [&](uint64_t k, uint64_t r) {
    if ((k >> shift) < run) {
      before += __popcll(r);
    } else if ((k >> shift) == run) {
      const uint64_t c = row_counts(r);
      const bool ahead = k < key;
      if (lanes) {
        even += c & 0x00FF00FF00FF00FFull;
        odd += (c >> 8) & 0x00FF00FF00FF00FFull;
        if (ahead) {
          even_ahead += c & 0x00FF00FF00FF00FFull;
          odd_ahead += (c >> 8) & 0x00FF00FF00FF00FFull;
        }
      } else {
#pragma unroll
        for (int row = 0; row < 8; ++row) {
          const int n = static_cast<int>((c >> (8 * row)) & 0xFFu);
          row_total[row] += n;
          if (ahead) row_before[row] += n;
        }
      }
    }
  };
  // the bucket's blocks, 4 loads of each kind in flight
  int u = boff[d];
  const int end = boff[d + 1];
  for (; u + 4 <= end; u += 4) {
    uint64_t k[4], r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      k[q] = bkeys[u + q];
      r[q] = brows[u + q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) add(k[q], r[q]);
  }
  for (; u < end; ++u) add(bkeys[u], brows[u]);
  if (lanes) {
#pragma unroll
    for (int row = 0; row < 8; ++row) {
      const int sh = 16 * (row >> 1);
      row_total[row] = static_cast<int>(((row & 1 ? odd : even) >> sh)
                                        & 0xFFFFu);
      row_before[row] = static_cast<int>(
          ((row & 1 ? odd_ahead : even_ahead) >> sh) & 0xFFFFu);
    }
  }
  const uint32_t low = static_cast<uint32_t>(key);
  const int y0 = static_cast<int>(low >> shift) * 8;
  const int x0 = static_cast<int>(low & ((1u << shift) - 1u)) * 8;
  const float v = from_desc(static_cast<uint32_t>(key >> 32));
#pragma unroll
  for (int row = 0; row < 8; ++row) {
    int slot = before + row_before[row];
    before += row_total[row];
    for (unsigned byte = static_cast<unsigned>(own >> (8 * row)) & 0xFFu;
         byte && slot < quota; byte &= byte - 1, ++slot) {
      ys[slot] = y0 + row;
      xs[slot] = x0 + __ffs(byte) - 1;
      resp[slot] = v;
      valid[slot] = 1;
    }
  }
}

}  // namespace

// bytes of scratch: per tile of kTile blocks their live keys and their row
// bytes; per kept block its key in device memory, its rows, and both in
// bucket order (8 B each); the buckets' two scans, a header of 4 and the
// tile counts
extern "C" int64_t eff_select_cells_scratch_bytes(int h, int w, int quota) {
  const int64_t w8 = (w + 7) / 8, nb = (h + 7) / 8 * w8;
  const int64_t tiles = (nb + kTile - 1) / kTile;
  const int64_t kq = quota < nb ? quota : nb;
  return 16 * tiles * kTile + 32 * kq + 8 * (kBuckets + 1) + 16 + 4 * tiles;
}

extern "C" int eff_select_cells(const float* cellmax, const int32_t* cellrow,
                                const uint8_t* cellbits, int h, int w, int ld,
                                int quota, void* scratch,
                                int64_t scratch_bytes, int32_t* ys,
                                int32_t* xs, float* resp, uint8_t* valid,
                                void* stream) {
  if (h < 1 || w < 1 || ld < w || quota < 1
      || static_cast<int64_t>(h) * w >= (static_cast<int64_t>(1) << 31)
      || quota > h * w
      || scratch_bytes < eff_select_cells_scratch_bytes(h, w, quota))
    return cudaErrorInvalidValue;
  const int w8 = (w + 7) / 8, nb = (h + 7) / 8 * w8;
  const int tiles = (nb + kTile - 1) / kTile, kq = quota < nb ? quota : nb;
  int shift = 0;                       // bits of a block column
  while ((1 << shift) < w8) ++shift;
  uint64_t* live = static_cast<uint64_t*>(scratch);
  uint64_t* rows = live + static_cast<size_t>(tiles) * kTile;
  uint64_t* kglobal = rows + static_cast<size_t>(tiles) * kTile;
  uint64_t* rtmp = kglobal + kq;
  uint64_t* bkeys = rtmp + kq;
  uint64_t* brows = bkeys + kq;
  int32_t* boff = reinterpret_cast<int32_t*>(brows + kq);
  int32_t* soff = boff + kBuckets + 1;
  int32_t* hdr = soff + kBuckets + 1;
  int32_t* counts = hdr + 4;
  cudaError_t err = cudaFuncSetAttribute(
      cells_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cells_live_kernel<<<tiles, kTile, 0, st>>>(
      cellmax, cellrow, cellbits, w, ld, w8, nb, live, counts, rows);
  cells_bucket_kernel<<<1, kThreads, kSmemBytes, st>>>(
      live, counts, tiles, rows, w, w8, shift, kq, kglobal, rtmp, bkeys, brows,
      boff, soff, hdr);
  const int threads = kq > quota ? kq : quota;
  cells_place_kernel<<<(threads + kPlaceThreads - 1) / kPlaceThreads,
                       kPlaceThreads, 0, st>>>(bkeys, brows, boff, soff, hdr,
                                               shift, w8, quota, ys, xs, resp,
                                               valid);
  return cudaGetLastError();
}
