// Fused support scorer (segmented SpMM) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/support.py
// (fused_support_scores, body _support_kernel).  For query row b and
// item column i of the (U, I') deviation / rated-mask tables:
//   num = Σ_j w[b,j] · dev[nb[b,j], i]
//   den = Σ_j w[b,j] · msk[nb[b,j], i]
//   out = clip(q̄[b] + num / max(den, 1e-8), 1, 5)   (q̄[b] when den ≤ 1e-8)
// — the item index's exact shortlist scorer: the predictor's num/den form
// for every item, with the neighbors' deviation rows precomputed.
//
// Design.  The TPU kernel walks a (b, I'/bt, k) grid with the neighbor
// axis innermost, DMA-ing one (1, bt) row tile of each table per step
// into VMEM accumulators.  Here the k loop moves inside the block: one
// thread block per (query row, 512-column tile), the row's k neighbor ids
// and weights staged in shared memory in chunks of 64, and each of the
// 128 threads owns 4 consecutive columns, read as one float4 per table
// per neighbor (neighboring threads on neighboring 16-byte words, so each
// warp's loads coalesce into 512-byte segments).  Widths that are not a
// multiple of 4 (tables narrower than one tile are not padded) take a
// scalar path.  Ids outside [0, U) contribute nothing (the callers pass
// clipped ids; the guard only keeps a bad id from reading out of bounds).
//
// Order of sums.  j runs 0..k−1 with separately rounded multiplies and
// adds (__fmul_rn / __fadd_rn, so no multiply-add contraction) and an
// IEEE division (__fdiv_rn): the order of the plain version
// repro_torch.kernels.support.support_scores_plain, so the two agree bit
// for bit — and, on the same rounded r − r̄ values, the order of the tile
// predictor, so the support score equals the exact prediction.
//
// Bound.  The function reads each table once and writes the output once:
// at one 6040-row chunk, k = 40, I' = 4096 that is 2·U·I'·4 + b·I'·4 bytes
// (~0.30 GB, ~0.09 ms at 3.35 TB/s) against 4·b·k·I' f32 operations
// (~4.0e9, ~0.06 ms at 67 TFLOP/s): bound by bytes.  This kernel reads
// each neighbor's rows once per query row instead, b·k·I'·8 bytes
// (~7.9 GB) of gathered rows, and the 198 MB of tables do not fit in the
// 50 MB L2 — so it is bound by those gathers, milliseconds, not the
// bound.  Ordering query rows so that rows sharing neighbors run together
// (L2 reuse) and TMA row gathers are the next design, not this file's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 512;       // columns per block
constexpr int NT = BT / 4;    // threads per block, 4 columns each
constexpr int KC = 64;        // neighbors staged per shared-memory chunk
constexpr float EPS = 1e-8f;

__device__ __forceinline__ float epilogue(float num, float den, float q) {
  float pred = __fadd_rn(q, __fdiv_rn(num, fmaxf(den, EPS)));
  pred = (den > EPS) ? pred : q;
  return fminf(fmaxf(pred, 1.f), 5.f);
}

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

}  // namespace

// dev/msk: (n_users, n_cols) f32; ids: (b, k) int32; w: (b, k) f32 masked
// weights; q_means: (b,); out: (b, n_cols).  Returns cudaGetLastError()
// after the launch (0 = launched); the caller raises on anything else.
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
