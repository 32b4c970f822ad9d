// bf16 tensor-core helpers (sm_80 and later, used here for sm_90a): the
// ldmatrix loads, the mma.sync m16n8k16 bf16 → f32 product, the bf16 pair
// packing and the bf16 row staging shared by flash_attention.cu (the
// forward's "mma" and "split" routes) and flash_attention_bwd.cu (the
// backward's "mma" route).
//
// Fragment layouts are those of mma.m16n8k16: lane = 4·g + t4; an
// accumulator holds (row g, cols 2·t4, 2·t4 + 1) in [0, 1] and row g + 8
// in [2, 3]; an A fragment (16 × 16, row-major) is the accumulators of two
// adjacent 8-column blocks packed as bf16 pairs, so a product's result
// feeds the next product's A operand without shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace repro_mma {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(repro_cp::smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(repro_cp::smem_u32(p)));
}

// c (16×8 f32) += a (16×16 bf16, row) · b (16×8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) → bf16x2, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) → bf16x2 hi = round(x, y) and lo = round((x, y) − hi)
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The A fragment of k-chunk kk from accumulators c (16 rows × 8 columns a
// block): columns 16·kk … 16·kk + 15, each value rounded once to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int kk) {
  a[0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Stage `nrows` bf16 rows of `width` columns (a multiple of 8) at row
// stride ld: row r comes from row_ptr(r) (nullptr: zeros), columns ≥ ncols
// are zero.  vec: 16-byte cp.async (ncols a multiple of 8, rows 16-byte
// aligned; the caller commits and waits); else element by element.
template <typename RowPtr>
__device__ __forceinline__ void stage_bf16(bf16* dst, int ld, int nrows,
                                           int ncols, int width, bool vec,
                                           const void* any, RowPtr row_ptr) {
  if (vec) {
    const int cpr = width / 8;
    for (int i = threadIdx.x; i < nrows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      const bf16* src = row_ptr(r);
      const bool ok = src != nullptr && c < ncols;
      repro_cp::cp_async16(dst + r * ld + c,
                           ok ? static_cast<const void*>(src + c) : any,
                           ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __ushort_as_bfloat16(static_cast<unsigned short>(0));
    for (int i = threadIdx.x; i < nrows * width; i += blockDim.x) {
      const int r = i / width, c = i - r * width;
      const bf16* src = row_ptr(r);
      dst[r * ld + c] = (src != nullptr && c < ncols) ? src[c] : zero;
    }
  }
}

}  // namespace repro_mma
