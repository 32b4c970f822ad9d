// Canonical top-M selection for Hopper (sm_90a), CUDA C++.
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
// Scan design.  A thread block owns QT query rows and keeps, per row, a
// buffer of CAP (score, id) pairs in shared memory (CAP a power of two
// ≥ MB + S, MB = M padded to 128).  The candidate axis is walked in
// sub-chunks of S = 512 columns; each thread scores two columns of a
// sub-chunk for all QT rows (the dot product over the proxy dimension in
// order p = 0..P−1 with separately rounded products and sums, the plain
// version's order, with the query rows in shared memory).  A candidate
// enters a row's buffer only if it beats the row's current M-th entry —
// an exact prune, since that threshold only rises — at a slot taken with
// a shared-memory atomic.  Before a sub-chunk could overflow a buffer,
// and after the last one, all QT buffers are bitonic-sorted by
// (score desc, id asc), which makes the slot order irrelevant; the top
// MB stay, and the MB-th becomes the new threshold.  The output is the
// first M entries of the final sort.  Per-row scores use one fixed order,
// so the kernel and its plain version give the same bits.
//
// Select design (radix select).  One block of 256 threads owns one row
// of L scores, staged once in shared memory when it fits (L ≤ 32768) and
// read from device memory on every pass otherwise.  Each score maps to an
// order-preserving u32 key (−0.0 folded into +0.0, which the plain
// version's sort treats as equal, so the tie goes to the lower id);
// −inf, NaN and the knocked-out column are not candidates.  With c
// candidates, k = min(M, c) are taken: four 8-bit passes, most
// significant digit first, each a 256-bin shared-memory histogram
// (warp-aggregated atomics) of the keys that match the digits found so
// far and a block scan over the bins from the top, find the key T of the
// k-th best candidate and how many of the candidates equal to T go in.
// One ordered pass over the ids then takes every key above T and the
// lowest-id ties at T, their slots decided by block prefix scans (no
// atomics), and a bitonic sort of those k (key, ~id) pairs in shared
// memory puts them in canonical order; slots past k get (−inf, L).
//
// Bound.  Scan mode on one 2048-query block at 6040 users, P = 256:
// 2·Q·N·P = 6.3e9 f32 operations (~0.09 ms at 67 TFLOP/s) and
// (Q + N)·P·4 + Q·M·8 bytes (~8.4 MB, ~0.003 ms): the GEMM is cheap; the
// kernel is bound by the merge — the bitonic sorts of the CAP-wide
// buffers in shared memory, which no roofline of the card counts.
// Select mode reads Q·L·4 bytes once and writes Q·M·8: bound by bytes
// (1.0e7 bytes, 3.1 µs, at the cluster query's Q 256, L 8192, M 906).
// The four histogram passes re-read the row from shared memory, and the
// final bitonic sort of k ≤ M entries costs log²(k)/2 block barriers.
//
// Next design for the scan (not in this file): the same radix select in
// place of the running bitonic merge, and the proxy GEMM on the tensor
// cores (a fixed-order TF32-free split would keep the bits).

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

// Proxy scores q·p over the P proxy dimensions, merged into a running
// canonical top-M per query row.
template <int QT>
__global__ void __launch_bounds__(NT)
topm_kernel(const float* __restrict__ q, const float* __restrict__ prox,
            const int* __restrict__ q_ids, float* __restrict__ out_v,
            int* __restrict__ out_i, int nq, int n, int p, int m, int mb,
            int cap) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int p4 = (p + 3) & ~3;
  float* qs = smem;                                   // QT × p4
  float* val = qs + QT * p4;                          // QT × cap
  int* idx = reinterpret_cast<int*>(val + QT * cap);  // QT × cap
  int* cnt = idx + QT * cap;                          // QT
  float* thr_v = reinterpret_cast<float*>(cnt + QT);  // QT
  int* thr_i = reinterpret_cast<int*>(thr_v + QT);    // QT
  int* qid = thr_i + QT;                              // QT

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * QT;
  const int rows = min(QT, nq - row0);

  for (int t = tid; t < QT * p4; t += NT) {
    const int r = t / p4, f = t % p4;
    qs[t] = (r < rows && f < p) ? q[static_cast<size_t>(row0 + r) * p + f]
                                : 0.f;
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
#pragma unroll
      for (int r = 0; r < QT; ++r) s[r] = 0.f;
      const float* pj = prox + static_cast<size_t>(j) * p;
      if ((p & 3) == 0) {
        for (int f = 0; f < p; f += 4) {
          const float4 v = *reinterpret_cast<const float4*>(pj + f);
#pragma unroll
          for (int r = 0; r < QT; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(qs + r * p4 + f);
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

size_t smem_bytes(int qt, int p, int cap) {
  const size_t p4 = static_cast<size_t>((p + 3) & ~3);
  return qt * p4 * 4 + static_cast<size_t>(qt) * cap * 8 +
         static_cast<size_t>(qt) * 16;
}

template <int QT>
int launch(const float* q, const float* prox, const int* q_ids,
           float* out_v, int* out_i, int nq, int n, int p, int m, int mb,
           int cap, cudaStream_t stream) {
  const size_t smem = smem_bytes(QT, p, cap);
  cudaError_t err = cudaFuncSetAttribute(
      topm_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (nq + QT - 1) / QT;
  topm_kernel<QT><<<grid, NT, smem, stream>>>(q, prox, q_ids, out_v, out_i,
                                              nq, n, p, m, mb, cap);
  return static_cast<int>(cudaGetLastError());
}

constexpr size_t SMEM_MAX = 200 * 1024;   // of the 227 KB opt-in

int dispatch(const float* q, const float* prox, const int* q_ids,
             float* out_v, int* out_i, int nq, int n, int p, int m, int mb,
             int cap, cudaStream_t stream) {
  if (smem_bytes(8, p, cap) <= SMEM_MAX && nq >= 8)
    return launch<8>(q, prox, q_ids, out_v, out_i, nq, n, p, m, mb, cap,
                     stream);
  if (smem_bytes(4, p, cap) <= SMEM_MAX && nq >= 4)
    return launch<4>(q, prox, q_ids, out_v, out_i, nq, n, p, m, mb, cap,
                     stream);
  if (smem_bytes(2, p, cap) <= SMEM_MAX && nq >= 2)
    return launch<2>(q, prox, q_ids, out_v, out_i, nq, n, p, m, mb, cap,
                     stream);
  if (smem_bytes(1, p, cap) <= SMEM_MAX)
    return launch<1>(q, prox, q_ids, out_v, out_i, nq, n, p, m, mb, cap,
                     stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int buffer_cap(int mb) {
  int cap = 1;
  while (cap < mb + S) cap <<= 1;
  return cap;
}

// ---- select mode: radix select ------------------------------------------

constexpr int ROW_STAGE_MAX = 32768;   // scores staged in shared memory
static_assert(NT == 256, "one histogram bin a thread");

// Order-preserving key of a candidate score (−0.0 folded into +0.0).
__device__ __forceinline__ unsigned score_key(float v) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// −inf, NaN and the knocked-out column are never selected.
__device__ __forceinline__ bool candidate(float v, int j, int qid) {
  return j != qid && v != -INFINITY && v == v;
}

// Inclusive scan of x over the block's NT threads; *total gets the sum.
// scratch holds NT / 32 ints; the block must reach every call.
__device__ __forceinline__ int block_scan(int x, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NT / 32 ? scratch[lane] : 0;
#pragma unroll
    for (int off = 1; off < NT / 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < NT / 32) scratch[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += scratch[warp - 1];
  *total = scratch[NT / 32 - 1];
  __syncthreads();
  return x;
}

// One block per row of `scores` (Q, n): canonical top-m into out_v/out_i.
// Shared memory: row (n floats, STAGED only) | buf (sort_cap u64) |
// hist (256 ints) | scratch (NT / 32 ints) | sel (2 ints).
template <bool STAGED>
__global__ void __launch_bounds__(NT)
radix_topm_kernel(const float* __restrict__ scores,
                  const int* __restrict__ q_ids, float* __restrict__ out_v,
                  int* __restrict__ out_i, int n, int m, int sort_cap,
                  int vec) {
  extern __shared__ float4 smem4[];
  float* row_s = reinterpret_cast<float*>(smem4);
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(
      row_s + (STAGED ? ((n + 1) & ~1) : 0));
  int* hist = reinterpret_cast<int*>(buf + sort_cap);
  int* scratch = hist + 256;
  int* sel = scratch + NT / 32;

  const int tid = threadIdx.x, lane = tid & 31;
  const size_t row = blockIdx.x;
  const float* src = scores + row * n;
  const int qid = q_ids[row];

  if (STAGED) {
    if (vec) {
      for (int j = tid * 4; j < n; j += NT * 4)
        *reinterpret_cast<float4*>(row_s + j) =
            __ldg(reinterpret_cast<const float4*>(src + j));
    } else {
      for (int j = tid; j < n; j += NT) row_s[j] = __ldg(src + j);
    }
    __syncthreads();
  }
  auto score = [&](int j) -> float { return STAGED ? row_s[j] : __ldg(src + j); };

  // radix select of the k-th best key, most significant byte first
  unsigned prefix = 0u, pmask = 0u;
  int k = 0, need = 0;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    hist[tid] = 0;                                  // NT == 256 bins
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += NT) {
      const int j = j0 + tid;
      bool hit = false;
      unsigned bin = 0u;
      if (j < n) {
        const float v = score(j);
        if (candidate(v, j, qid)) {
          const unsigned key = score_key(v);
          hit = (key & pmask) == prefix;
          bin = (key >> shift) & 255u;
        }
      }
      const unsigned act = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const unsigned peers = __match_any_sync(act, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
      }
    }
    __syncthreads();
    // counts from the top bin down: bin 255 − tid
    const int own = hist[255 - tid];
    int total;
    const int incl = block_scan(own, scratch, &total);
    if (pass == 0) {
      k = min(m, total);
      need = k;
      if (k == 0) break;                            // block-uniform
    }
    if (incl - own < need && incl >= need) {
      sel[0] = 255 - tid;
      sel[1] = need - (incl - own);
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(sel[0]) << shift;
    pmask |= 255u << shift;
    need = sel[1];
    __syncthreads();
  }
  const unsigned thr = prefix;       // key of the k-th best candidate
  const int n_gt = k - need;         // candidates above thr; `need` ties

  // ordered gather: every key above thr, then the lowest-id ties at thr
  int base_gt = 0, base_eq = 0;
  for (int c0 = 0; k > 0 && c0 < n && (base_gt < n_gt || base_eq < need);
       c0 += NT * 4) {
    unsigned keys[4];
    int cgt = 0, ceq = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = c0 + tid * 4 + e;
      keys[e] = 0u;
      if (j < n) {
        const float v = score(j);
        if (candidate(v, j, qid)) keys[e] = score_key(v);
      }
      cgt += keys[e] > thr;
      ceq += keys[e] == thr;
    }
    int tot;
    const int own = (ceq << 16) | cgt;
    const int pre = block_scan(own, scratch, &tot) - own;
    int at_gt = base_gt + (pre & 0xffff), at_eq = base_eq + (pre >> 16);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned j = static_cast<unsigned>(c0 + tid * 4 + e);
      const unsigned long long item =
          (static_cast<unsigned long long>(keys[e]) << 32) | (~j);
      if (keys[e] > thr) {
        buf[at_gt++] = item;
      } else if (keys[e] == thr) {
        if (at_eq < need) buf[n_gt + at_eq] = item;
        ++at_eq;
      }
    }
    base_gt += tot & 0xffff;
    base_eq += tot >> 16;
  }

  // bitonic sort of the k chosen (key, ~id) pairs, descending
  int len = 1;
  while (len < k) len <<= 1;
  for (int t = k + tid; t < len; t += NT) buf[t] = 0ull;
  __syncthreads();
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < len / 2; t += NT) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const unsigned long long a = buf[lo], b = buf[hi];
        if (((lo & size) == 0) ? a < b : a > b) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int t = tid; t < m; t += NT) {
    const size_t o = row * m + t;
    if (t < k) {
      const int j = static_cast<int>(~static_cast<unsigned>(buf[t]));
      out_v[o] = score(j);
      out_i[o] = j;
    } else {
      out_v[o] = -INFINITY;
      out_i[o] = n;
    }
  }
}

int select_dispatch(const float* scores, const int* q_ids, float* out_v,
                    int* out_i, int nq, int n, int m, cudaStream_t stream) {
  int sort_cap = 1;
  while (sort_cap < m) sort_cap <<= 1;
  const size_t tail = static_cast<size_t>(sort_cap) * 8 + (256 + NT / 32 + 2) * 4;
  const size_t staged = static_cast<size_t>((n + 1) & ~1) * 4 + tail;
  const bool stage = n <= ROW_STAGE_MAX && staged <= SMEM_MAX;
  const size_t smem = stage ? staged : tail;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(scores) % 16 == 0) ? 1 : 0;
  auto kern = stage ? radix_topm_kernel<true> : radix_topm_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<nq, NT, smem, stream>>>(scores, q_ids, out_v, out_i, n, m, sort_cap,
                                 vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (Q, P) queries × (N, P) proxies → canonical top-m (Q, m) values + ids.
// mb is m padded to 128 (≥ m).  Returns cudaGetLastError() after the
// launch (0 = launched); the caller raises on anything else.
extern "C" int repro_scan_topm(const void* q, const void* prox,
                               const void* q_ids, void* out_v, void* out_i,
                               int nq, int n, int p, int m, int mb,
                               void* stream) {
  return dispatch(static_cast<const float*>(q),
                  static_cast<const float*>(prox),
                  static_cast<const int*>(q_ids), static_cast<float*>(out_v),
                  static_cast<int*>(out_i), nq, n, p, m, mb, buffer_cap(mb),
                  static_cast<cudaStream_t>(stream));
}

// (Q, N) precomputed scores → canonical top-m (Q, m) values + ids, m ≤ N
// and m ≤ 16384 (the sort buffer's shared memory); cudaErrorInvalidValue
// past that.
extern "C" int repro_select_topm(const void* scores, const void* q_ids,
                                 void* out_v, void* out_i, int nq, int n,
                                 int m, void* stream) {
  return select_dispatch(static_cast<const float*>(scores),
                         static_cast<const int*>(q_ids),
                         static_cast<float*>(out_v),
                         static_cast<int*>(out_i), nq, n, m,
                         static_cast<cudaStream_t>(stream));
}
