// Hopper's warpgroup MMA as K6 (knn2_hamming.cu) issues it: the shared-memory
// matrix descriptor of the no-swizzle core-matrix layout (8 rows x 16 bytes
// contiguous, the next 16 bytes of K kWgmmaLbo bytes on, the next 8 rows
// kWgmmaSbo bytes on) and a wrapper of one m64n128 instruction with its 64
// accumulator registers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWgmmaLbo = 128;   // bytes between core matrices along K
constexpr int kWgmmaSbo = 256;   // bytes between 8-row groups

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor: no swizzle, base offset 0.
__device__ __forceinline__ uint64_t mma_desc(const void* p) {
  uint64_t d = (smem_addr(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>(kWgmmaLbo >> 4) << 16;
  d |= static_cast<uint64_t>(kWgmmaSbo >> 4) << 32;
  return d;
}

}  // namespace

// Defines NAME(d, da, db, scale_d): d (+)= A x B for the m64n128 instruction
// INSTR, A (64 rows) and B (128 rows) K-major in shared memory behind the
// descriptors da and db; scale_d 0 overwrites d.
#define EFF_WGMMA_M64N128(NAME, INSTR)                                        \
  __device__ __forceinline__ void NAME(int (&d)[64], uint64_t da,             \
                                       uint64_t db, int scale_d) {            \
    asm volatile(                                                             \
        "{\n"                                                                 \
        ".reg .pred p;\n"                                                     \
        "setp.ne.b32 p, %66, 0;\n" INSTR " "                                  \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "            \
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "             \
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "             \
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "             \
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "             \
        "%57, %58, %59, %60, %61, %62, %63}, "                                \
        "%64, %65, p;\n"                                                      \
        "}\n"                                                                 \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),         \
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),         \
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),    \
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),    \
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),    \
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),    \
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),    \
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),    \
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),    \
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),    \
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),    \
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),    \
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])                  \
        : "l"(da), "l"(db), "r"(scale_d));                                    \
  }
