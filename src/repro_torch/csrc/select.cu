// Blockwise canonical top-M selection for Hopper (sm_90a), CUDA C++.
//
// Replaces two Pallas TPU kernels of repro/kernels/select.py that share
// one running merge (_topm_step / _merge_topm):
//   * fused_scan_topm (_scan_kernel): proxy scores q·Pᵀ of a query block
//     against the whole pool, self-pair knocked out, canonical top-M per
//     query — the (Q, N) score matrix is never written to device memory;
//   * select_topm (_select_kernel): the same selection over precomputed
//     (Q, N) scores.
// Selection is canonical: descending score, ties to the lower candidate
// id, and every -inf slot (knockout, or a row with fewer than M finite
// scores) carries the sentinel id N — the order of the plain version
// (repro_torch.kernels.ref.select_topm_ref, a stable two-key sort).
//
// Design.  A thread block owns QT query rows and keeps, per row, a
// buffer of CAP (score, id) pairs in shared memory (CAP a power of two
// ≥ MB + S, MB = M padded to 128).  The candidate axis is walked in
// sub-chunks of S = 512 columns; each thread scores two columns of a
// sub-chunk for all QT rows (scan mode: the dot product over the proxy
// dimension in order p = 0..P−1 with separately rounded products and
// sums, the plain version's order, with the query rows in shared memory;
// select mode: a coalesced load of the score rows).  A candidate enters a
// row's buffer only if it beats the row's current M-th entry — an exact
// prune, since that threshold only rises — at a slot taken with a
// shared-memory atomic.  Before a sub-chunk could overflow a buffer, and
// after the last one, all QT buffers are bitonic-sorted by
// (score desc, id asc), which makes the slot order irrelevant; the top
// MB stay, and the MB-th becomes the new threshold.  The output is the
// first M entries of the final sort.  Per-row scores use one fixed order,
// so the kernel and its plain version give the same bits.
//
// Bound.  Scan mode on one 2048-query block at 6040 users, P = 256:
// 2·Q·N·P = 6.3e9 f32 operations (~0.09 ms at 67 TFLOP/s) and
// (Q + N)·P·4 + Q·M·8 bytes (~8.4 MB, ~0.003 ms): the GEMM is cheap; the
// kernel is bound by the merge — the bitonic sorts of the CAP-wide
// buffers in shared memory, which no roofline of the card counts.
//
// Next design (not in this file): a radix select of the M-th key per row
// instead of full bitonic sorts, warp-per-row buffers, and the proxy GEMM
// on the tensor cores (a fixed-order TF32-free split would keep the bits).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int S = 512;        // candidate columns per sub-chunk (2/thread)

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Sort every row's buffer [0, CAP) by (score desc, id asc), after filling
// the unused tail [cnt, CAP) with the sentinel (-inf, n).  Afterwards the
// row keeps its best mb entries (cnt = mb) and thr = its mb-th entry.
template <int QT>
__device__ void sort_rows(float* val, int* idx, int* cnt, float* thr_v,
                          int* thr_i, int cap, int mb, int n) {
  const int tid = threadIdx.x;
  for (int t = tid; t < QT * cap; t += NT) {
    const int r = t / cap, e = t % cap;
    if (e >= cnt[r]) {
      val[t] = -INFINITY;
      idx[t] = n;
    }
  }
  __syncthreads();
  const int half = cap / 2;
  for (int k = 2; k <= cap; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < QT * half; t += NT) {
        const int r = t / half, h = t % half;
        const int i = ((h & ~(j - 1)) << 1) | (h & (j - 1));
        const int l = i | j;
        const int a = r * cap + i, b = r * cap + l;
        const float av = val[a], bv = val[b];
        const int ai = idx[a], bi = idx[b];
        const bool up = (i & k) == 0;      // better-first segment
        if (up ? better(bv, bi, av, ai) : better(av, ai, bv, bi)) {
          val[a] = bv; val[b] = av;
          idx[a] = bi; idx[b] = ai;
        }
      }
      __syncthreads();
    }
  }
  if (tid < QT) {
    cnt[tid] = mb;
    thr_v[tid] = val[tid * cap + mb - 1];
    thr_i[tid] = idx[tid * cap + mb - 1];
  }
  __syncthreads();
}

// SCAN: scores are q·p over the P proxy dimensions; otherwise they are
// read from `scores` (Q, N).
template <int QT, bool SCAN>
__global__ void __launch_bounds__(NT)
topm_kernel(const float* __restrict__ q, const float* __restrict__ prox,
            const float* __restrict__ scores, const int* __restrict__ q_ids,
            float* __restrict__ out_v, int* __restrict__ out_i, int nq,
            int n, int p, int m, int mb, int cap) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int p4 = (p + 3) & ~3;
  float* qs = smem;                                   // QT × p4 (scan)
  float* val = qs + (SCAN ? QT * p4 : 0);             // QT × cap
  int* idx = reinterpret_cast<int*>(val + QT * cap);  // QT × cap
  int* cnt = idx + QT * cap;                          // QT
  float* thr_v = reinterpret_cast<float*>(cnt + QT);  // QT
  int* thr_i = reinterpret_cast<int*>(thr_v + QT);    // QT
  int* qid = thr_i + QT;                              // QT

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * QT;
  const int rows = min(QT, nq - row0);

  if (SCAN) {
    for (int t = tid; t < QT * p4; t += NT) {
      const int r = t / p4, f = t % p4;
      qs[t] = (r < rows && f < p) ? q[static_cast<size_t>(row0 + r) * p + f]
                                  : 0.f;
    }
  }
  if (tid < QT) {
    cnt[tid] = 0;
    thr_v[tid] = -INFINITY;
    thr_i[tid] = n;
    qid[tid] = tid < rows ? q_ids[row0 + tid] : -1;
  }
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += S) {
    bool full = false;
    if (tid < QT) full = cnt[tid] + S > cap;
    if (__syncthreads_or(full)) {
      sort_rows<QT>(val, idx, cnt, thr_v, thr_i, cap, mb, n);
    }
    for (int j = c0 + tid; j < min(c0 + S, n); j += NT) {
      float s[QT];
      if (SCAN) {
#pragma unroll
        for (int r = 0; r < QT; ++r) s[r] = 0.f;
        const float* pj = prox + static_cast<size_t>(j) * p;
        if ((p & 3) == 0) {
          for (int f = 0; f < p; f += 4) {
            const float4 v = *reinterpret_cast<const float4*>(pj + f);
#pragma unroll
            for (int r = 0; r < QT; ++r) {
              const float4 a =
                  *reinterpret_cast<const float4*>(qs + r * p4 + f);
              s[r] = __fadd_rn(s[r], __fmul_rn(a.x, v.x));
              s[r] = __fadd_rn(s[r], __fmul_rn(a.y, v.y));
              s[r] = __fadd_rn(s[r], __fmul_rn(a.z, v.z));
              s[r] = __fadd_rn(s[r], __fmul_rn(a.w, v.w));
            }
          }
        } else {
          for (int f = 0; f < p; ++f) {
            const float v = pj[f];
#pragma unroll
            for (int r = 0; r < QT; ++r) {
              s[r] = __fadd_rn(s[r], __fmul_rn(qs[r * p4 + f], v));
            }
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < QT; ++r) {
          s[r] = r < rows ? scores[static_cast<size_t>(row0 + r) * n + j]
                          : -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        if (r >= rows) continue;
        float v = s[r];
        if (j == qid[r]) v = -INFINITY;
        const int id = (v == -INFINITY) ? n : j;
        if (better(v, id, thr_v[r], thr_i[r])) {
          const int pos = atomicAdd(&cnt[r], 1);
          val[r * cap + pos] = v;
          idx[r * cap + pos] = id;
        }
      }
    }
    __syncthreads();
  }
  sort_rows<QT>(val, idx, cnt, thr_v, thr_i, cap, mb, n);

  for (int t = tid; t < rows * m; t += NT) {
    const int r = t / m, e = t % m;
    const size_t o = static_cast<size_t>(row0 + r) * m + e;
    out_v[o] = val[r * cap + e];
    out_i[o] = idx[r * cap + e];
  }
}

size_t smem_bytes(int qt, bool scan, int p, int cap) {
  const size_t p4 = static_cast<size_t>((p + 3) & ~3);
  return (scan ? qt * p4 * 4 : 0) + static_cast<size_t>(qt) * cap * 8 +
         static_cast<size_t>(qt) * 16;
}

template <int QT, bool SCAN>
int launch(const float* q, const float* prox, const float* scores,
           const int* q_ids, float* out_v, int* out_i, int nq, int n, int p,
           int m, int mb, int cap, cudaStream_t stream) {
  const size_t smem = smem_bytes(QT, SCAN, p, cap);
  cudaError_t err = cudaFuncSetAttribute(
      topm_kernel<QT, SCAN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (nq + QT - 1) / QT;
  topm_kernel<QT, SCAN><<<grid, NT, smem, stream>>>(
      q, prox, scores, q_ids, out_v, out_i, nq, n, p, m, mb, cap);
  return static_cast<int>(cudaGetLastError());
}

constexpr size_t SMEM_MAX = 200 * 1024;   // of the 227 KB opt-in

template <bool SCAN>
int dispatch(const float* q, const float* prox, const float* scores,
             const int* q_ids, float* out_v, int* out_i, int nq, int n,
             int p, int m, int mb, int cap, cudaStream_t stream) {
  if (smem_bytes(8, SCAN, p, cap) <= SMEM_MAX && nq >= 8)
    return launch<8, SCAN>(q, prox, scores, q_ids, out_v, out_i, nq, n, p,
                           m, mb, cap, stream);
  if (smem_bytes(4, SCAN, p, cap) <= SMEM_MAX && nq >= 4)
    return launch<4, SCAN>(q, prox, scores, q_ids, out_v, out_i, nq, n, p,
                           m, mb, cap, stream);
  if (smem_bytes(2, SCAN, p, cap) <= SMEM_MAX && nq >= 2)
    return launch<2, SCAN>(q, prox, scores, q_ids, out_v, out_i, nq, n, p,
                           m, mb, cap, stream);
  if (smem_bytes(1, SCAN, p, cap) <= SMEM_MAX)
    return launch<1, SCAN>(q, prox, scores, q_ids, out_v, out_i, nq, n, p,
                           m, mb, cap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int buffer_cap(int mb) {
  int cap = 1;
  while (cap < mb + S) cap <<= 1;
  return cap;
}

}  // namespace

// (Q, P) queries × (N, P) proxies → canonical top-m (Q, m) values + ids.
// mb is m padded to 128 (≥ m).  Returns cudaGetLastError() after the
// launch (0 = launched); the caller raises on anything else.
extern "C" int repro_scan_topm(const void* q, const void* prox,
                               const void* q_ids, void* out_v, void* out_i,
                               int nq, int n, int p, int m, int mb,
                               void* stream) {
  return dispatch<true>(static_cast<const float*>(q),
                        static_cast<const float*>(prox), nullptr,
                        static_cast<const int*>(q_ids),
                        static_cast<float*>(out_v), static_cast<int*>(out_i),
                        nq, n, p, m, mb, buffer_cap(mb),
                        static_cast<cudaStream_t>(stream));
}

// (Q, N) precomputed scores → canonical top-m (Q, m) values + ids.
extern "C" int repro_select_topm(const void* scores, const void* q_ids,
                                 void* out_v, void* out_i, int nq, int n,
                                 int m, int mb, void* stream) {
  return dispatch<false>(nullptr, nullptr, static_cast<const float*>(scores),
                         static_cast<const int*>(q_ids),
                         static_cast<float*>(out_v),
                         static_cast<int*>(out_i), nq, n, 0, m, mb,
                         buffer_cap(mb), static_cast<cudaStream_t>(stream));
}
