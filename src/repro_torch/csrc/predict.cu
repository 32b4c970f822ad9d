// Fused tile predictor for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/predict.py
// (fused_tile_predict, body _predict_kernel).  For query row u and item i
// in the tile [lo, hi):
//   num = Σ_j w[u,j] · (r[nb_j, i] − n̄[u,j]) · 1[r > 0]
//   den = Σ_j w[u,j] · 1[r[nb_j, i] > 0]
//   out = clip(q̄[u] + num / max(den, 1e-8), 1, 5)   (q̄[u] when den ≤ 1e-8)
//
// Design.  The TPU kernel takes an (m, k, T) tile gathered outside it; on
// the GPU the gather moves into the kernel, so that tile is never written
// to device memory.  The kernel reads the int8 (or f32) rating matrix
// directly by neighbor id: one thread block per (query row, 256 items),
// the row's k neighbor ids, weights and means staged in shared memory in
// chunks of 64, and each thread walking the k neighbors for its item.
// Neighboring threads read neighboring items of one neighbor row, so the
// reads coalesce.  Ids outside [0, U) contribute nothing (the callers
// pass clipped ids; the guard only keeps a bad id from reading out of
// bounds).
//
// Order of sums.  j runs 0..k−1 with separately rounded multiplies and
// adds (__fmul_rn / __fadd_rn), the order of the plain version
// repro_torch.core.predict._tile_predict, so the two agree bit for bit.
//
// Bound.  Per launch the kernel must read the rows of the distinct
// neighbors over the tile (int8: at most U·T bytes; the whole 6040 × 3952
// int8 matrix is 24 MB and stays in the 50 MB L2), the (m, k) ids,
// weights and means, and write the (m, T) f32 output; it does 6 f32
// operations per (row, neighbor, item).  At the recommend tile (1024 rows
// × 40 neighbors × 512 items) the two least times are close — ~1.9 µs
// for the operations on the CUDA cores, ~1.3 µs for the bytes — so the
// kernel sits near the ridge point, and its real limit is the latency of
// each thread's k dependent gathers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // items per block
constexpr int KC = 64;        // neighbors staged per shared-memory chunk
constexpr float EPS = 1e-8f;

template <typename T>
__global__ void __launch_bounds__(NT)
predict_kernel(const T* __restrict__ src, int n_users, int n_items,
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
        const float r = static_cast<float>(
            src[static_cast<size_t>(id) * n_items + lo + t]);
        const float mask = (r > 0.f) ? 1.f : 0.f;
        const float dev = __fmul_rn(__fsub_rn(r, s_nbm[j]), mask);
        num = __fadd_rn(num, __fmul_rn(s_w[j], dev));
        den = __fadd_rn(den, __fmul_rn(s_w[j], mask));
      }
    }
  }
  if (t < t_len) {
    const float q = q_means[row];
    float pred = __fadd_rn(q, __fdiv_rn(num, fmaxf(den, EPS)));
    pred = (den > EPS) ? pred : q;
    out[static_cast<size_t>(row) * t_len + t] = fminf(fmaxf(pred, 1.f), 5.f);
  }
}

}  // namespace

// src: (n_users, n_items) int8 (dtype 1) or f32 (dtype 0); ids/w/nb_means:
// (m, k); q_means: (m,); out: (m, hi − lo).  Returns cudaGetLastError()
// after the launch (0 = launched); the caller raises on anything else.
extern "C" int repro_tile_predict(const void* src, int dtype, int n_users,
                                  int n_items, const void* ids,
                                  const void* w, const void* nb_means,
                                  const void* q_means, void* out, int m,
                                  int k, int lo, int hi, void* stream) {
  const int t_len = hi - lo;
  const dim3 grid(m, (t_len + NT - 1) / NT);
  const dim3 block(NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i32 = static_cast<const int*>(ids);
  const float* wf = static_cast<const float*>(w);
  const float* nbm = static_cast<const float*>(nb_means);
  const float* qm = static_cast<const float*>(q_means);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    predict_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(src), n_users, n_items, i32, wf, nbm, qm,
        o, k, lo, t_len);
  } else if (dtype == 1) {
    predict_kernel<int8_t><<<grid, block, 0, s>>>(
        static_cast<const int8_t*>(src), n_users, n_items, i32, wf, nbm, qm,
        o, k, lo, t_len);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
