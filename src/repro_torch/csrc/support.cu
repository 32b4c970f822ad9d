// Fused support scorer (segmented SpMM) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/support.py
// (fused_support_scores, body _support_kernel).  For query row b and
// item column i of the (U, I') deviation / rated-mask tables:
//   num = Σ_j w[b,j] · dev[nb[b,j], i]
//   den = Σ_j w[b,j] · msk[nb[b,j], i]
//   out = clip(q̄[b] + num / max(den, 1e-8), 1, 5)   (q̄[b] when den ≤ 1e-8)
// — the item index's exact shortlist scorer: the predictor's num/den form
// for every item.
//
// Two routes, chosen by the caller from the operand's dtype:
//
// "table" (support_kernel): the f32 (U, I') dev / msk tables the item
// index builds.  One thread block per (query row, 512-column tile), the
// row's k neighbor ids and weights staged in shared memory in chunks of
// 64, each of the 128 threads owning 4 consecutive columns, read as one
// float4 per table per neighbor (neighboring threads on neighboring
// 16-byte words, so each warp's loads coalesce into 512-byte segments).
// Widths that are not a multiple of 4 take a scalar path.
//
// "int8" (support_int8_kernel): the (U, I) int8 rating matrix and the
// (U,) f32 user means in place of the tables.  Both tables are functions
// of them — dev = where(r > 0, r − mean[u], 0), msk = (r > 0), zero past
// I — so the kernel rebuilds each element bit for bit from one byte and
// the neighbor's mean: d = r > 0 ? __fsub_rn(r, mean) : 0, m = r > 0.
// One byte a gathered element instead of eight, from a matrix (23.9 MB
// at ML-1M) that stays in the 50 MB L2, where the 198 MB of tables did
// not.  One thread block per (query row, 2048-column tile); each of the
// 128 threads owns 16 consecutive columns, read as one 16-byte load per
// neighbor (a warp reads a 512-byte row segment); the row's neighbor ids,
// weights and means are staged in shared memory.  A byte becomes a float
// without the int → float converter: __byte_perm places it in the
// mantissa of 2^23, and subtracting 2^23 is exact; where w·0 is +0 the
// unrated terms are skipped.  Those helpers live in csrc/rating_rows.cuh,
// shared with the tile predictor's "int8" route.  Rows whose width is
// not a multiple of 16, or that are not 16-byte aligned, take a scalar
// path.
//
// Both routes: ids outside [0, U) contribute nothing (the callers pass
// clipped ids; the guard only keeps a bad id from reading out of bounds).
//
// Order of sums.  j runs 0..k−1 with separately rounded multiplies and
// adds (__fmul_rn / __fadd_rn, so no multiply-add contraction) and an
// IEEE division (__fdiv_rn): the order of the plain version
// repro_torch.kernels.support.support_scores_plain, so the two agree bit
// for bit — and, on the same rounded r − r̄ values, the order of the tile
// predictor, so the support score equals the exact prediction.  On the
// "int8" route the products are w·d and w·m exactly as the table route
// forms them (w·0 included), so the two routes agree bit for bit too.
//
// Bound.  At one 6040-row chunk, k = 40, I' = 4096: 4·b·k·I' f32
// operations (~4.0e9: ~0.06 ms at 67 TFLOP/s; the pinned order forbids
// FMA, so ~0.12 ms at the no-FMA rate) against, on the "table" route,
// 2·U·I'·4 + b·I'·4 bytes (~0.30 GB, ~0.09 ms at 3.35 TB/s) of tables
// read once — but the kernel reads each neighbor's rows once per query
// row, b·k·I'·8 bytes (~7.9 GB) of gathers, and the tables do not fit in
// L2, so it is bound by those gathers.  On the "int8" route the bytes
// are U·I + b·I'·4 (~0.12 GB, ~0.04 ms) and the gathers, b·k·I' bytes,
// hit L2: it is bound by operations — the pinned order's four, plus the
// byte's conversion, the subtraction and the two selects of the rebuild.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rating_rows.cuh"

namespace {

using namespace repro_rows;

constexpr int BT = 512;       // columns per block
constexpr int NT = BT / 4;    // threads per block, 4 columns each
constexpr int KC = 64;        // neighbors staged per shared-memory chunk

template <bool VEC>
__global__ void __launch_bounds__(NT)
support_kernel(const float* __restrict__ dev, const float* __restrict__ msk,
               int n_users, int n_cols, const int* __restrict__ ids,
               const float* __restrict__ w, const float* __restrict__ q_means,
               float* __restrict__ out, int k) {
  __shared__ int s_id[KC];
  __shared__ float s_w[KC];

  const int row = blockIdx.x;
  const int c0 = blockIdx.y * BT + threadIdx.x * 4;
  const size_t rk = static_cast<size_t>(row) * k;
  float num[4] = {0.f, 0.f, 0.f, 0.f};
  float den[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < k; j0 += KC) {
    const int kc = min(KC, k - j0);
    __syncthreads();
    if (threadIdx.x < kc) {
      s_id[threadIdx.x] = ids[rk + j0 + threadIdx.x];
      s_w[threadIdx.x] = w[rk + j0 + threadIdx.x];
    }
    __syncthreads();
    if (c0 >= n_cols) continue;
    for (int j = 0; j < kc; ++j) {
      const int id = s_id[j];
      if (id < 0 || id >= n_users) continue;
      const float wj = s_w[j];
      const size_t base = static_cast<size_t>(id) * n_cols + c0;
      float d[4], m[4];
      if (VEC) {
        const float4 dv = *reinterpret_cast<const float4*>(dev + base);
        const float4 mv = *reinterpret_cast<const float4*>(msk + base);
        d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
        m[0] = mv.x; m[1] = mv.y; m[2] = mv.z; m[3] = mv.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = c0 + e < n_cols;
          d[e] = in ? dev[base + e] : 0.f;
          m[e] = in ? msk[base + e] : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        num[e] = __fadd_rn(num[e], __fmul_rn(wj, d[e]));
        den[e] = __fadd_rn(den[e], __fmul_rn(wj, m[e]));
      }
    }
  }
  if (c0 >= n_cols) return;
  const float q = q_means[row];
  float* o = out + static_cast<size_t>(row) * n_cols + c0;
  if (VEC) {
    *reinterpret_cast<float4*>(o) =
        make_float4(epilogue(num[0], den[0], q), epilogue(num[1], den[1], q),
                    epilogue(num[2], den[2], q), epilogue(num[3], den[3], q));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < n_cols) o[e] = epilogue(num[e], den[e], q);
  }
}

constexpr int BT8 = 2048;     // columns per block, "int8" route
constexpr int NT8 = BT8 / 16;  // threads per block, 16 columns each

template <bool VEC>
__global__ void __launch_bounds__(NT8)
support_int8_kernel(const int8_t* __restrict__ r,
                    const float* __restrict__ means, int n_users,
                    int n_items, int n_cols, const int* __restrict__ ids,
                    const float* __restrict__ w,
                    const float* __restrict__ q_means,
                    float* __restrict__ out, int k) {
  __shared__ int s_id[KC];
  __shared__ float s_w[KC], s_w1[KC], s_w0[KC], s_mu[KC];

  const int row = blockIdx.x;
  const int c0 = blockIdx.y * BT8 + threadIdx.x * 16;
  const size_t rk = static_cast<size_t>(row) * k;
  float num[16], den[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    num[e] = 0.f;
    den[e] = 0.f;
  }
  for (int j0 = 0; j0 < k; j0 += KC) {
    const int kc = min(KC, k - j0);
    __syncthreads();
    if (threadIdx.x < kc) {
      const int id = ids[rk + j0 + threadIdx.x];
      const float wj = w[rk + j0 + threadIdx.x];
      const bool ok = id >= 0 && id < n_users;
      s_id[threadIdx.x] = ok ? id : -1;
      s_w[threadIdx.x] = wj;
      s_w1[threadIdx.x] = __fmul_rn(wj, 1.f);
      s_w0[threadIdx.x] = __fmul_rn(wj, 0.f);
      s_mu[threadIdx.x] = ok ? means[id] : 0.f;
    }
    __syncthreads();
    if (c0 >= n_cols) continue;
#pragma unroll 2
    for (int j = 0; j < kc; ++j) {
      const int id = s_id[j];
      if (id < 0) continue;
      const float wj = s_w[j], w1 = s_w1[j], w0 = s_w0[j], mu = s_mu[j];
      const int8_t* src = r + static_cast<size_t>(id) * n_items + c0;
      // n_items and n_cols are multiples of 16 on the VEC path: a
      // thread's 16 columns lie all inside [0, I) or all past it
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (VEC && c0 < n_items) v = *reinterpret_cast<const uint4*>(src);
      if (__float_as_uint(w0) == 0u) {   // block-uniform
        neighbor<VEC, true>(v, src, c0, n_items, mu, w1, w0, w0, wj, num,
                            den);
      } else {
        neighbor<VEC, false>(v, src, c0, n_items, mu, w1, w0, w0, wj, num,
                             den);
      }
    }
  }
  if (c0 >= n_cols) return;
  const float q = q_means[row];
  float* o = out + static_cast<size_t>(row) * n_cols + c0;
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
      if (c0 + e < n_cols) o[e] = epilogue(num[e], den[e], q);
  }
}

}  // namespace

// The "table" route.  dev/msk: (n_users, n_cols) f32; ids: (b, k) int32;
// w: (b, k) f32 masked weights; q_means: (b,); out: (b, n_cols).  Returns
// cudaGetLastError() after the launch (0 = launched); the caller raises
// on anything else.
extern "C" int repro_support_scores(const void* dev, const void* msk,
                                    int n_users, int n_cols, const void* ids,
                                    const void* w, const void* q_means,
                                    void* out, int b, int k, void* stream) {
  const dim3 grid(b, (n_cols + BT - 1) / BT);
  const dim3 block(NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n_cols % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(dev) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(msk) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const float* d = static_cast<const float*>(dev);
  const float* m = static_cast<const float*>(msk);
  const int* i32 = static_cast<const int*>(ids);
  const float* wf = static_cast<const float*>(w);
  const float* qm = static_cast<const float*>(q_means);
  float* o = static_cast<float*>(out);
  if (vec) {
    support_kernel<true><<<grid, block, 0, s>>>(d, m, n_users, n_cols, i32,
                                                wf, qm, o, k);
  } else {
    support_kernel<false><<<grid, block, 0, s>>>(d, m, n_users, n_cols, i32,
                                                 wf, qm, o, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// The "int8" route.  ratings: (n_users, n_items) int8; means: (n_users,)
// f32; out: (b, n_cols) with n_cols ≥ n_items (columns past n_items score
// as the tables' zero padding); ids, w, q_means as above.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_support_scores_int8(const void* ratings,
                                         const void* means, int n_users,
                                         int n_items, int n_cols,
                                         const void* ids, const void* w,
                                         const void* q_means, void* out,
                                         int b, int k, void* stream) {
  const dim3 grid(b, (n_cols + BT8 - 1) / BT8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n_items % 16 == 0 && n_cols % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ratings) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int8_t* r = static_cast<const int8_t*>(ratings);
  const float* mu = static_cast<const float*>(means);
  const int* i32 = static_cast<const int*>(ids);
  const float* wf = static_cast<const float*>(w);
  const float* qm = static_cast<const float*>(q_means);
  float* o = static_cast<float*>(out);
  if (vec) {
    support_int8_kernel<true><<<grid, NT8, 0, s>>>(
        r, mu, n_users, n_items, n_cols, i32, wf, qm, o, k);
  } else {
    support_int8_kernel<false><<<grid, NT8, 0, s>>>(
        r, mu, n_users, n_items, n_cols, i32, wf, qm, o, k);
  }
  return static_cast<int>(cudaGetLastError());
}
