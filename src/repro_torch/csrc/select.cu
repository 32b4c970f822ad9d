// Canonical top-M selection for Hopper (sm_90a), CUDA C++.
//
// Replaces two Pallas TPU kernels of repro/kernels/select.py that share
// one running merge (_topm_step / _merge_topm):
//   * fused_scan_topm (_scan_kernel): proxy scores q·Pᵀ of a query block
//     against the whole pool, self-pair knocked out, canonical top-M per
//     query;
//   * select_topm (_select_kernel): the same selection over precomputed
//     (Q, N) scores.
// Selection is canonical: descending score, ties to the lower candidate
// id, and every -inf slot (knockout, or a row with fewer than M finite
// scores) carries the sentinel id N — the order of the plain version
// (repro_torch.kernels.ref.select_topm_ref, a stable two-key sort).
//
// Scan design: two launches on one stream, the score matrix in between
// in a device workspace the wrapper allocates (the TPU kernel folds each
// score block into a running top-M so that the (Q, N) matrix never
// exists; on this card that fold was the slow part).
//   1. proxy_scores_kernel: a register-tiled f32 product, 128 × 128
//      outputs a block, 8 × 8 a thread (rows ty + 16i, columns tx + 16j),
//      32-dimension K slices of q and the proxies staged by cp.async in a
//      double buffer.  Each output's sum walks p = 0..P−1 in order with
//      separately rounded products and sums (__fmul_rn, __fadd_rn, no
//      FMA) — the plain version's order (ref.proxy_scores_ref), so the
//      scores are equal bit for bit whatever the tiling.  The zero-filled
//      tail of the last slice adds +0 to a sum that is never −0.
//   2. radix_topm_kernel (below) on the workspace, with q_ids for the
//      self-pair knockout: the same canonical top-M as select mode.
// One workspace holds every row: row slabs whose scores stay in the
// 50 MB L2 until the select reads them were slower at both index shapes
// (tools/kernel_times.py times them).
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
// Domain: M ≤ 16384 (the sort buffer's shared memory).
//
// Bound.  Scan mode on one 2048-query block at 6040 users, P = 256:
// 2·Q·N·P = 6.3e9 f32 operations (~0.09 ms at 67 TFLOP/s, which counts
// an FMA as two) and (Q + N)·P·4 + Q·M·8 bytes (~8.4 MB, ~0.003 ms).
// The pinned order forbids the FMA, so the floor for these inputs is
// 2·Q·N·P = 6.3e9 single-rounded instructions on 132 × 128 lanes,
// ~0.19 ms at 1.98 GHz.  The workspace adds Q·N·4 bytes written and read
// (49.5 MB at this shape).  Select mode reads Q·L·4 bytes once and
// writes Q·M·8: bound by bytes (1.0e7 bytes, 3.1 µs, at the cluster
// query's Q 256, L 8192, M 906).  The four histogram passes re-read the
// row from shared memory, and the final bitonic sort of k ≤ M entries
// costs log²(k)/2 block barriers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int NT = 256;                   // threads per block
constexpr size_t SMEM_MAX = 200 * 1024;   // of the 227 KB opt-in

// ---- scan mode: fixed-order proxy scores ----------------------------------

constexpr int BQ = 128;            // query rows a block
constexpr int BC = 128;            // pool rows (score columns) a block
constexpr int BP = 32;             // proxy dimensions a K slice
constexpr int LDP = BP + 4;        // shared row stride (floats)
constexpr int TQ = 8, TC = 8;      // outputs a thread: 8 rows × 8 columns
constexpr int SCORE_SMEM = 2 * (BQ + BC) * LDP * 4;
static_assert(NT == (BQ / TQ) * (BC / TC), "16 × 16 threads");

using repro_cp::cp_async16;
using repro_cp::cp_async_commit;
using repro_cp::cp_async_wait;

// (nq, p) × (n, p) → (nq, n) scores, p a multiple of 4, rows 16-byte
// aligned.
__global__ void __launch_bounds__(NT, 1)
proxy_scores_kernel(const float* __restrict__ q,
                    const float* __restrict__ prox, float* __restrict__ out,
                    int nq, int n, int p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BQ, col0 = blockIdx.x * BC;
  const int n_slices = (p + BP - 1) / BP;

  // one stage: BQ query rows then BC pool rows, BP / 4 16-byte chunks each
  auto load = [&](int stage, int kt) {
    float* dst = sm + stage * (BQ + BC) * LDP;
    for (int c = tid; c < (BQ + BC) * (BP / 4); c += NT) {
      const int r = c / (BP / 4), ch = c % (BP / 4);
      const int gk = kt * BP + ch * 4;
      const bool is_q = r < BQ;
      const int gr = is_q ? row0 + r : col0 + r - BQ;
      const bool ok = gk < p && gr < (is_q ? nq : n);
      const float* base = is_q ? q : prox;
      const float* src = ok ? base + static_cast<size_t>(gr) * p + gk : base;
      cp_async16(dst + r * LDP + ch * 4, src, ok ? 16 : 0);
    }
  };

  float acc[TQ][TC];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int jj = 0; jj < TC; ++jj) acc[i][jj] = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_slices; ++kt) {
    if (kt + 1 < n_slices) load((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* as = sm + (kt & 1) * (BQ + BC) * LDP;
    const float* bs = as + BQ * LDP;
#pragma unroll
    for (int f = 0; f < BP; f += 4) {
      float4 b[TC];
#pragma unroll
      for (int jj = 0; jj < TC; ++jj)
        b[jj] = *reinterpret_cast<const float4*>(bs + (tx + 16 * jj) * LDP + f);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(as + (ty + 16 * i) * LDP + f);
#pragma unroll
        for (int jj = 0; jj < TC; ++jj) {
          float s = acc[i][jj];
          s = __fadd_rn(s, __fmul_rn(a.x, b[jj].x));
          s = __fadd_rn(s, __fmul_rn(a.y, b[jj].y));
          s = __fadd_rn(s, __fmul_rn(a.z, b[jj].z));
          s = __fadd_rn(s, __fmul_rn(a.w, b[jj].w));
          acc[i][jj] = s;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= nq) continue;
#pragma unroll
    for (int jj = 0; jj < TC; ++jj) {
      const int c = col0 + tx + 16 * jj;
      if (c < n) out[static_cast<size_t>(r) * n + c] = acc[i][jj];
    }
  }
}

int scores_launch(const float* q, const float* prox, float* out, int nq,
                  int n, int p, cudaStream_t stream) {
  if (p % 4 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(prox) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      proxy_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SCORE_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BC - 1) / BC, (nq + BQ - 1) / BQ);
  proxy_scores_kernel<<<grid, NT, SCORE_SMEM, stream>>>(q, prox, out, nq, n,
                                                        p);
  return static_cast<int>(cudaGetLastError());
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

// (Q, P) queries × (N, P) proxies → (Q, N) f32 scores in the plain
// version's order (P a multiple of 4, 16-byte aligned rows).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_proxy_scores(const void* q, const void* prox,
                                  void* out, int nq, int n, int p,
                                  void* stream) {
  return scores_launch(static_cast<const float*>(q),
                       static_cast<const float*>(prox),
                       static_cast<float*>(out), nq, n, p,
                       static_cast<cudaStream_t>(stream));
}

// (Q, P) queries × (N, P) proxies → canonical top-m (Q, m) values + ids:
// the scores into `ws` (Q × N f32), then the radix select of every row
// with the self-pair knockout.  P a multiple of 4, 16-byte aligned rows,
// m ≤ min(N, 16384).  Returns the first launch error (0 = both went).
extern "C" int repro_scan_topm(const void* q, const void* prox,
                               const void* q_ids, void* ws, void* out_v,
                               void* out_i, int nq, int n, int p, int m,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const int err = scores_launch(static_cast<const float*>(q),
                                static_cast<const float*>(prox), w, nq, n,
                                p, s);
  if (err != 0) return err;
  return select_dispatch(w, static_cast<const int*>(q_ids),
                         static_cast<float*>(out_v), static_cast<int*>(out_i),
                         nq, n, m, s);
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
