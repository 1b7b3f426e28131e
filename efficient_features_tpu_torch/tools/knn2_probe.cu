// Tensor-core rate probe for K6's two operand forms.  No part of the port's
// kernel library: tools/knn2_probe.py builds this file alone, into a library
// of its own, when it is run, and times it.
//
// K6 (knn2_hamming.cu) forms its distances with the 1-bit warpgroup MMA
// `m64n128k256.s32.b1.b1.and.popc` on the packed descriptors.  The other
// exact form is an int8 product of the bits unpacked to one byte each,
// `m64n128k32.s32.s8.s8`, eight instructions per 256 bits.  This kernel
// runs either product alone, with K6's grid, block, tile walk and
// start-and-wait pattern and the shared memory each form would need (the
// query strip and two train stages: 12 KB per 256 bits packed, 96 KB per
// 256 bits unpacked), on zeroed operands, without loading, unpacking or
// folding anything: the least either form could take inside this design.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_m64n128.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlane = 128 * 32;       // 128 rows x 32 bytes of K
constexpr int kSbo = kWgmmaSbo;

EFF_WGMMA_M64N128(wgmma_b1,
                  "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc")
EFF_WGMMA_M64N128(wgmma_s8,
                  "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8")

// PLANES: 32-byte K steps per descriptor row in shared memory, one MMA each.
template <bool INT8, int PLANES>
__global__ void __launch_bounds__(kThreads)
product_probe_kernel(int tiles, int32_t* __restrict__ sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_q = smem;
  unsigned char* s_t = smem + PLANES * kPlane;       // two stages
  for (int i = threadIdx.x * 16; i < 3 * PLANES * kPlane; i += kThreads * 16)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  int acc[64];
  int seen = 0;
  for (int tile = 0; tile < tiles; ++tile) {
    __syncthreads();                   // K6's one barrier per tile
    const unsigned char* t = s_t + (tile & 1) * PLANES * kPlane;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < PLANES; ++k) {
      const uint64_t da = mma_desc(s_q + k * kPlane + wg * 8 * kSbo);
      const uint64_t db = mma_desc(t + k * kPlane);
      if (INT8) wgmma_s8(acc, da, db, k);
      else wgmma_b1(acc, da, db, k);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[i]) :: "memory");
    seen |= acc[0] | acc[63];
  }
  if (seen != 0) sink[0] = seen;       // zero operands: never taken
}

template <bool INT8, int PLANES>
int launch(int n1, int n2, int split_len, int32_t* sink, cudaStream_t s) {
  const size_t smem = 3 * PLANES * kPlane;
  const cudaError_t err = cudaFuncSetAttribute(
      product_probe_kernel<INT8, PLANES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n1 + 127) / 128, (n2 + split_len - 1) / split_len);
  product_probe_kernel<INT8, PLANES><<<grid, kThreads, smem, s>>>(
      split_len / 128, sink);
  return cudaGetLastError();
}

}  // namespace

// The product alone of an n1 x n2 search at nbits 256 or 512, over K6's grid
// with `split_len` train rows a block, as the int8 product of unpacked bits
// (int8_form 1) or the 1-bit AND-popcount product K6 uses (0).  sink: one
// int32 on the device, left unwritten.  Returns the launch's CUDA error code.
extern "C" int eff_knn2_product_probe(int int8_form, int n1, int n2, int nbits,
                                      int split_len, int32_t* sink,
                                      void* stream) {
  if (n1 < 1 || n2 < 1 || split_len < 128 || split_len % 128 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8_form && nbits == 256)
    return launch<true, 8>(n1, n2, split_len, sink, s);
  if (int8_form && nbits == 512)
    return launch<true, 16>(n1, n2, split_len, sink, s);
  if (!int8_form && nbits == 256)
    return launch<false, 1>(n1, n2, split_len, sink, s);
  if (!int8_form && nbits == 512)
    return launch<false, 2>(n1, n2, split_len, sink, s);
  return cudaErrorInvalidValue;
}
