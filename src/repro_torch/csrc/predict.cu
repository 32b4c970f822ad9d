// Fused tile predictor for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/predict.py
// (fused_tile_predict, body _predict_kernel).  For query row u and item i
// in the range [lo, hi):
//   num = Σ_j w[u,j] · (r[nb_j, i] − n̄[u,j]) · 1[r > 0]
//   den = Σ_j w[u,j] · 1[r[nb_j, i] > 0]
//   out = clip(q̄[u] + num / max(den, 1e-8), 1, 5)   (q̄[u] when den ≤ 1e-8)
//
// The TPU kernel takes an (m, k, T) tile gathered outside it; on the GPU
// the gather moves into the kernel, which reads the rating matrix by
// neighbor id, so that tile is never written to device memory — and the
// item range is not tiled either: the caller launches once over [0, I)
// and the kernel writes the (m, I) output directly.  Ids outside [0, U)
// contribute nothing (the callers pass clipped ids; the guard only keeps
// a bad id from reading out of bounds).  Two routes, chosen by the caller
// from the source's dtype:
//
// "int8" (predict_int8_kernel): the (U, I) int8 rating matrix.  One warp
// owns one query row and 512 consecutive items, each lane 16 of them, read
// as one 16-byte load per neighbor row (a warp reads a 512-byte row
// segment).  Each lane holds one of the row's next 32 neighbors (id,
// weight, mean, the unrated products) in registers, and the warp walks
// them by shuffles — no shared memory, no barrier.  UNROLL neighbor rows
// are loaded before any is used, so that many gathers are in flight a
// thread.  A byte becomes a float by __byte_perm, and the unrated terms
// are skipped where their products are ±0 (csrc/rating_rows.cuh, shared
// with the support scorer, which computes the same num / den).  A launch
// whose range or row stride is not 16-byte aligned, or whose width is
// not a multiple of 16, reads the bytes one by one (the same arithmetic).
//
// "f32" (predict_kernel): f32 ratings (half stars).  One block per (query
// row, 256 items), one thread per item; the row's neighbor ids, weights
// and means staged in shared memory in chunks of 64.
//
// Order of sums.  j runs 0..k−1 with separately rounded multiplies and
// adds (__fmul_rn / __fadd_rn, no multiply-add contraction) and an IEEE
// division, the order of the plain version
// repro_torch.core.predict._tile_predict, so the two agree bit for bit.
//
// Bound.  At one 1024-row user block of the exact recommend (k 40, the
// whole 3952-item range) the kernel must read the distinct neighbor rows
// (at most U·I bytes: 23.9 MB at ML-1M, which stays in the 50 MB L2), the
// (m, k) ids, weights and means, and write the (m, I) f32 output (16 MB),
// ~0.012 ms at 3.35 TB/s; the pinned order's multiplies and adds are 4
// instructions an element (1.6e8 elements: ~0.019 ms at half the f32
// peak, the no-FMA floor), and the byte's conversion, the mask and the
// skip add about as many again, so the int8 route is bound by issued
// instructions, with its gathers served from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rating_rows.cuh"

namespace {

using namespace repro_rows;

constexpr int NT = 256;       // items per block, "f32" route
constexpr int KC = 64;        // neighbors staged per shared-memory chunk

__global__ void __launch_bounds__(NT)
predict_kernel(const float* __restrict__ src, int n_users, int n_items,
               const int* __restrict__ ids, const float* __restrict__ w,
               const float* __restrict__ nb_means,
               const float* __restrict__ q_means, float* __restrict__ out,
               int k, int lo, int t_len) {
  __shared__ int s_id[KC];
  __shared__ float s_w[KC];
  __shared__ float s_nbm[KC];

  const int row = blockIdx.x;
  const int t = blockIdx.y * NT + threadIdx.x;
  const size_t rk = static_cast<size_t>(row) * k;
  float num = 0.f;
  float den = 0.f;
  for (int j0 = 0; j0 < k; j0 += KC) {
    const int kc = min(KC, k - j0);
    __syncthreads();
    if (threadIdx.x < kc) {
      s_id[threadIdx.x] = ids[rk + j0 + threadIdx.x];
      s_w[threadIdx.x] = w[rk + j0 + threadIdx.x];
      s_nbm[threadIdx.x] = nb_means[rk + j0 + threadIdx.x];
    }
    __syncthreads();
    if (t < t_len) {
      for (int j = 0; j < kc; ++j) {
        const int id = s_id[j];
        if (id < 0 || id >= n_users) continue;
        const float r = src[static_cast<size_t>(id) * n_items + lo + t];
        const float mask = (r > 0.f) ? 1.f : 0.f;
        const float dev = __fmul_rn(__fsub_rn(r, s_nbm[j]), mask);
        num = __fadd_rn(num, __fmul_rn(s_w[j], dev));
        den = __fadd_rn(den, __fmul_rn(s_w[j], mask));
      }
    }
  }
  if (t < t_len)
    out[static_cast<size_t>(row) * t_len + t] =
        epilogue(num, den, q_means[row]);
}

constexpr int WARPS = 4;          // warps a block, "int8" route
constexpr int SEG = 32 * 16;      // items a warp: 16 a lane
constexpr int UNROLL = 4;         // neighbor rows loaded before use
constexpr unsigned FULL = 0xffffffffu;

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
predict_int8_kernel(const int8_t* __restrict__ src, int n_users,
                    int n_items, const int* __restrict__ ids,
                    const float* __restrict__ w,
                    const float* __restrict__ nb_means,
                    const float* __restrict__ q_means,
                    float* __restrict__ out, int m, int k, int lo, int t_len,
                    int segs) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (gw >= m * segs) return;                     // warp-uniform
  const int row = gw / segs;
  const int c0 = (gw - row * segs) * SEG + lane * 16;
  // lanes past the range keep walking the neighbors with the warp (the
  // shuffles need every lane) but load and store nothing
  const bool active = c0 < t_len;
  const int8_t* base = src + lo + c0;
  const size_t rk = static_cast<size_t>(row) * k;
  float num[16], den[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    num[e] = 0.f;
    den[e] = 0.f;
  }
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int kc = min(32, k - j0);
    int id_l = -1;
    float w_l = 0.f, mu_l = 0.f, wd0_l = 0.f, wm0_l = 0.f;
    if (lane < kc) {
      const int id = ids[rk + j0 + lane];
      w_l = w[rk + j0 + lane];
      mu_l = nb_means[rk + j0 + lane];
      id_l = (id >= 0 && id < n_users) ? id : -1;
      // the plain version's unrated products: w·((r − μ)·0) and w·0
      wd0_l = __fmul_rn(w_l, __fmul_rn(__fsub_rn(0.f, mu_l), 0.f));
      wm0_l = __fmul_rn(w_l, 0.f);
    }
    const unsigned zero = __ballot_sync(FULL, zero_products(wd0_l, wm0_l));
    for (int j = 0; j < kc; j += UNROLL) {
      int nid[UNROLL];
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        nid[u] = __shfl_sync(FULL, id_l, j + u);   // lanes ≥ kc hold −1
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (VEC && active && nid[u] >= 0)
          v[u] = __ldg(reinterpret_cast<const uint4*>(
              base + static_cast<size_t>(nid[u]) * n_items));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float wj = __shfl_sync(FULL, w_l, j + u);
        const float mu = __shfl_sync(FULL, mu_l, j + u);
        if (nid[u] < 0) continue;                  // warp-uniform
        const int8_t* p = base + static_cast<size_t>(nid[u]) * n_items;
        if ((zero >> (j + u)) & 1u) {             // warp-uniform
          neighbor<VEC, true>(v[u], p, c0, t_len, mu, wj, 0.f, 0.f, wj,
                              num, den);
        } else {
          const float wd0 = __shfl_sync(FULL, wd0_l, j + u);
          const float wm0 = __shfl_sync(FULL, wm0_l, j + u);
          neighbor<VEC, false>(v[u], p, c0, t_len, mu, __fmul_rn(wj, 1.f),
                               wd0, wm0, wj, num, den);
        }
      }
    }
  }
  if (!active) return;
  const float q = q_means[row];
  float* o = out + static_cast<size_t>(row) * t_len + c0;
  if (VEC) {
#pragma unroll
    for (int e = 0; e < 16; e += 4)
      *reinterpret_cast<float4*>(o + e) = make_float4(
          epilogue(num[e], den[e], q), epilogue(num[e + 1], den[e + 1], q),
          epilogue(num[e + 2], den[e + 2], q),
          epilogue(num[e + 3], den[e + 3], q));
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (c0 + e < t_len) o[e] = epilogue(num[e], den[e], q);
  }
}

}  // namespace

// src: (n_users, n_items) int8 (dtype 1, the "int8" route) or f32 (dtype
// 0, "f32"); ids/w/nb_means: (m, k); q_means: (m,); out: (m, hi − lo).
// Returns cudaGetLastError() after the launch (0 = launched); the caller
// raises on anything else.
extern "C" int repro_tile_predict(const void* src, int dtype, int n_users,
                                  int n_items, const void* ids,
                                  const void* w, const void* nb_means,
                                  const void* q_means, void* out, int m,
                                  int k, int lo, int hi, void* stream) {
  const int t_len = hi - lo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i32 = static_cast<const int*>(ids);
  const float* wf = static_cast<const float*>(w);
  const float* nbm = static_cast<const float*>(nb_means);
  const float* qm = static_cast<const float*>(q_means);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    const dim3 grid(m, (t_len + NT - 1) / NT);
    predict_kernel<<<grid, NT, 0, s>>>(static_cast<const float*>(src),
                                       n_users, n_items, i32, wf, nbm, qm, o,
                                       k, lo, t_len);
  } else if (dtype == 1) {
    const int8_t* r = static_cast<const int8_t*>(src);
    const int segs = (t_len + SEG - 1) / SEG;
    const long long warps = static_cast<long long>(m) * segs;
    if (warps > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = static_cast<int>((warps + WARPS - 1) / WARPS);
    const bool vec = lo % 16 == 0 && n_items % 16 == 0 && t_len % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(o) % 16 == 0;
    if (vec) {
      predict_int8_kernel<true><<<grid, WARPS * 32, 0, s>>>(
          r, n_users, n_items, i32, wf, nbm, qm, o, m, k, lo, t_len, segs);
    } else {
      predict_int8_kernel<false><<<grid, WARPS * 32, 0, s>>>(
          r, n_users, n_items, i32, wf, nbm, qm, o, m, k, lo, t_len, segs);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
