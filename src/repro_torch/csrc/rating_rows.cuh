// Building blocks shared by the kernels that read int8 rating rows by
// neighbor id and form the predictor's num / den in the pinned order —
// the "int8" routes of predict.cu (the tile predictor) and support.cu (the
// support scorer) (sm_90a): a byte's float value, one element's products
// with the skip of unrated terms, one neighbor row's 16 columns, and the
// predictor's epilogue.
//
// Per element (query row b, neighbor j, item i), with r = r[nb_j, i]:
//   rated (r > 0):   num += w·(r − μ_j),  den += w·1
//   unrated:         num += wd0_j,        den += wm0_j
// where wd0 and wm0 are the products an unrated term adds in the plain
// version (support's tables: w·0 for both; the tile predictor: w·((r −
// μ)·0) and w·0).  Both are ±0 whenever w and μ are finite.  num and den
// start at +0, and a round-to-nearest sum is −0 only when both addends
// are, so neither is ever −0 and adding ±0 leaves its bits as they are:
// the unrated terms can then be skipped (ZERO).  Every multiply and add is
// separately rounded (__fmul_rn / __fadd_rn: no multiply-add contraction).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_rows {

constexpr float EPS = 1e-8f;

// clip(q + num / max(den, 1e-8), 1, 5), or q when den ≤ 1e-8.
__device__ __forceinline__ float epilogue(float num, float den, float q) {
  float pred = __fadd_rn(q, __fdiv_rn(num, fmaxf(den, EPS)));
  pred = (den > EPS) ? pred : q;
  return fminf(fmaxf(pred, 1.f), 5.f);
}

// The float value of byte b of w as an unsigned 8-bit integer: __byte_perm
// places it in the mantissa of 2^23, and subtracting 2^23 is exact.
__device__ __forceinline__ float byte_value(unsigned w, int b) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + b)),
                   8388608.f);
}

// True when the unrated products wd0 and wm0 are both ±0, so the unrated
// terms may be skipped.
__device__ __forceinline__ bool zero_products(float wd0, float wm0) {
  return ((__float_as_uint(wd0) | __float_as_uint(wm0)) << 1) == 0u;
}

// One element's products.  x: the rating's float value, read only where
// it is positive (pos); w1 = w·1.  ZERO: wd0 and wm0 are ±0 and the
// unrated term is skipped.
template <bool ZERO>
__device__ __forceinline__ void products(bool pos, float x, float mu, float w1,
                                         float wd0, float wm0, float wj,
                                         float& num, float& den) {
  if (ZERO) {
    if (pos) {
      num = __fadd_rn(num, __fmul_rn(wj, __fsub_rn(x, mu)));
      den = __fadd_rn(den, w1);
    }
  } else {
    const float pd = pos ? __fmul_rn(wj, __fsub_rn(x, mu)) : wd0;
    num = __fadd_rn(num, pd);
    den = __fadd_rn(den, pos ? w1 : wm0);
  }
}

// One neighbor row's 16 columns.  VEC: the 16-byte word v holds them, all
// inside the row or all past it (then v is zero); else the scalar bytes at
// src, columns c0 + e ≥ limit read as 0.
template <bool VEC, bool ZERO>
__device__ __forceinline__ void neighbor(const uint4& v, const int8_t* src,
                                         int c0, int limit, float mu,
                                         float w1, float wd0, float wm0,
                                         float wj, float (&num)[16],
                                         float (&den)[16]) {
  if (VEC) {
    const unsigned wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // bytes that are not positive (signed) → 0, so x > 0 is r > 0
      const unsigned pw = wd[q] & __vcmpgts4(wd[q], 0u);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float x = byte_value(pw, b);
        products<ZERO>(x > 0.f, x, mu, w1, wd0, wm0, wj, num[4 * q + b],
                       den[4 * q + b]);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = c0 + e < limit ? src[e] : 0;
      products<ZERO>(r > 0, static_cast<float>(r), mu, w1, wd0, wm0, wj,
                     num[e], den[e]);
    }
  }
}

}  // namespace repro_rows
