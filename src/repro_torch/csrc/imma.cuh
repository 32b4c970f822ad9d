// int8 tensor-core building blocks shared by the "imma" routes of
// rerank.cu and similarity.cu (sm_90a): cp.async staging (from
// cp_async.cuh), ldmatrix fragment loads, mma.sync m16n8k32 with s32
// accumulators, and the operand planes made in registers (masks 1[v > 0],
// squares split into u8 lo / hi bytes).
//
// Fragment layout (PTX ISA, mma.m16n8k32 with .s8 / .u8): an A fragment
// is four 32-bit registers holding a 16 × 32 byte tile, a B fragment two
// registers holding a 32 × 8 tile, the accumulator four s32 values at
// (row g, cols 2t, 2t+1) and (row g + 8, the same cols), g = lane / 4,
// t = lane % 4.  Every operand plane is stored row-major in shared memory
// with a row stride of LDS bytes, so the 16-byte ldmatrix rows of a warp
// fall on distinct banks when LDS is 16 bytes past a multiple of 64.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace repro_imma {

using repro_cp::cp_async16;
using repro_cp::cp_async_commit;
using repro_cp::cp_async_wait;
using repro_cp::smem_u32;

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragments of TM m16 tiles and B fragments of TN n8 tiles, k32 wide,
// from a plane of row stride LDS at p (the lane's ldmatrix offset added:
// see a_lane_offset / b_lane_offset).
template <int TM, int LDS>
__device__ __forceinline__ void load_a(unsigned (&a)[TM][4],
                                       const unsigned char* p) {
#pragma unroll
  for (int m = 0; m < TM; ++m) ldsm_x4(a[m], p + m * 16 * LDS);
}

template <int TN, int LDS>
__device__ __forceinline__ void load_b(unsigned (&b)[TN][2],
                                       const unsigned char* p) {
  static_assert(TN % 2 == 0, "one x4 load feeds two n8 tiles");
#pragma unroll
  for (int n = 0; n < TN; n += 2) {
    unsigned r[4];
    ldsm_x4(r, p + n * 8 * LDS);
    b[n][0] = r[0];
    b[n][1] = r[1];
    b[n + 1][0] = r[2];
    b[n + 1][1] = r[3];
  }
}

// ldmatrix lane offsets of a warp's first A tile (row a_row0) and first
// B tile (row b_row0) in a plane of row stride LDS: A x4 = (rows 0-7 |
// 8-15) × (bytes 0-15 | 16-31) → a0..a3; B x4 = two n8 tiles × (bytes
// 0-15 | 16-31) → b0, b1 of each.
template <int LDS>
__device__ __forceinline__ int a_lane_offset(int a_row0, int lane) {
  return (a_row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
         (lane >> 4) * 16;
}

template <int LDS>
__device__ __forceinline__ int b_lane_offset(int b_row0, int lane) {
  return (b_row0 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDS +
         ((lane >> 3) & 1) * 16;
}

// D += A·B on one m16n8k32 tile; A / B signed (s8) or unsigned (u8).
#define REPRO_IMMA(NAME, AT, BT)                                          \
  __device__ __forceinline__ void NAME(int (&d)[4], const unsigned (&a)[4], \
                                       unsigned b0, unsigned b1) {         \
    asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT        \
                 ".s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "            \
                 "{%0,%1,%2,%3};\n"                                       \
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),   \
                   "r"(b1));                                               \
  }
REPRO_IMMA(mma_ss, "s8", "s8")
REPRO_IMMA(mma_us, "u8", "s8")
REPRO_IMMA(mma_su, "s8", "u8")
#undef REPRO_IMMA

// 1 in each byte of w that is > 0 (signed), else 0.
__device__ __forceinline__ unsigned mask4(unsigned w) {
  return __vcmpgts4(w, 0u) & 0x01010101u;
}

// Squares of the four signed bytes of w, split v² = 256·hi + lo (u8
// bytes); returns whether some |v| > 15 (hi ≠ 0).
__device__ __forceinline__ bool square4(unsigned w, unsigned& lo,
                                        unsigned& hi) {
  lo = 0u;
  hi = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int v = static_cast<int>(static_cast<signed char>(w >> (8 * b)));
    const unsigned sq = static_cast<unsigned>(v * v);
    lo |= (sq & 255u) << (8 * b);
    hi |= (sq >> 8) << (8 * b);
  }
  return hi != 0u;
}

}  // namespace repro_imma
