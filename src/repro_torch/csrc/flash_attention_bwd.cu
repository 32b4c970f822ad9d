// Causal GQA flash attention (backward) for Hopper (sm_90a), CUDA C++.
//
// The gradient of csrc/flash_attention.cu's forward (kernel 8, the port
// of repro/kernels/flash_attention.py::flash_attention).  The TPU kernel
// has no backward: the reference differentiates its XLA
// chunked_attention (repro/models/common.py) under jax.checkpoint, which
// recomputes the scores chunk by chunk.  This file computes the same
// gradients without ever storing the (Sq × Skv) score matrix.
//
// For query head h = kv·g + j of batch row b (g = Hq / Hkv), query i at
// position q_off + i (q_off = Skv − Sq) and key p:
//   s_ip = scale · q_i·k_p, masked (p ≥ Skv, or p > q_off + i when causal)
//   P_ip = exp(s_ip − m_i) / l_i        (0 where masked)
//   dV_p = Σ_(h in group, i) P_ip dO_i
//   dP_ip = dO_i · v_p,  Δ_i = Σ_e dO_ie O_ie,  dS_ip = P_ip (dP_ip − Δ_i)
//   dQ_i = scale · Σ_p dS_ip k_p,   dK_p = scale · Σ_(h, i) dS_ip q_i
// A row with no visible key has P = 0, so its gradients are 0, as the
// forward's output is.
//
// Three launches, deterministic (no atomics), all f32 on the CUDA cores
// from q/k/v/o/dO in f32 or bf16, gradients written in the input dtype:
//  1. stats, grid (Sq/T, Hq, B): a block takes T query rows of one head,
//     walks the K tiles up to the causal edge with an online max / sum of
//     exp (per thread over its columns, merged over the 16 lanes of a
//     row at the end) and writes m_i, 1/max(l_i, 1e-30) and Δ_i to an
//     f32 workspace (3 floats a row).  The forward keeps its ABI: its
//     log-sum-exp is recomputed here, not stored there.
//  2. dK/dV, grid (Skv/T, Hkv, B): a block owns T keys of one kv head
//     (K and V tiles in shared memory, dK and dV accumulated in
//     registers) and loops over the q tiles of all g query heads of the
//     group from the first tile that sees its keys: S and dP for the
//     tile, P and dS to shared memory, then dV += Pᵀ·dO and dK += dSᵀ·Q.
//  3. dQ, grid (Sq/T, Hq, B): a block owns T query rows of one head and
//     loops over the K/V tiles up to the causal edge: dQ += dS·K.
// Tiles: T = 64 keys and query rows when d, dv ≤ 128 (T = 32 up to 256),
// 256 threads as 16 × 16, each thread a (T/16) × (T/16) block of a score
// tile and (T/16) rows × (DMAX/16) columns of a T × d product; shared
// rows are padded to an odd stride, so the column operand's 16 lanes hit
// 16 banks and the row operand is a broadcast.
//
// Bound.  At Llama-3.2-1B's prefill shapes (B 4, Hq 32, Hkv 8, S 2048,
// d 64, bf16, causal) the work is five of the forward's two matmuls
// (recomputed S, dV, dP, dQ, dK), each 2·B·Hq·S²·d with half of it
// masked: 1.7e11 operations, 0.17 ms at the 989 TFLOP/s bf16
// tensor-core peak, against ~100 MB of inputs and gradients (0.03 ms
// at 3.35 TB/s) — bound by operations.  This first design does eight
// such products (the stats pass and the dQ pass recompute S, the dQ pass
// dP) in f32 FMAs on the CUDA cores, fed from shared memory; mma.sync /
// wgmma tiles are a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -FLT_MAX;  // finfo(f32).min, as the forward
constexpr int THREADS = 256;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* gq;  // dQ, dK, dV
  void* gk;
  void* gv;
  float* stats;  // (B, Hq, Sq, 3): m, 1/max(l, 1e-30), Δ
  // (batch, head, row) element strides of q, k, v, o, dO, dQ, dK, dV
  long long s[8][3];
  int Hq, Hkv, Sq, Skv, d, dv;
  float scale;
  int causal;
};

enum { Q_, K_, V_, O_, DO_, DQ_, DK_, DV_ };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as .to(bf16)
}

template <typename T>
__device__ __forceinline__ const T* row_base(const void* t,
                                             const long long* st, int b,
                                             int h) {
  return static_cast<const T*>(t) + b * st[0] + h * st[1];
}

// dst[r][c] (row stride ld) = src row (row0 + r), column c, for r < rows
// and c < DMAX; zero past `end` rows or `width` columns.
template <typename T, int DMAX>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int end, int width, int rows) {
  for (int i = threadIdx.x; i < rows * DMAX; i += THREADS) {
    const int r = i / DMAX, c = i - r * DMAX;
    const int gr = row0 + r;
    dst[r * ld + c] = (gr < end && c < width)
                          ? to_f32(src[gr * row_stride + c])
                          : 0.f;
  }
}

__device__ __forceinline__ float lane16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float lane16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc[i][j] = Σ_kk A[(ty+16i)][kk] · B[(tx+16j)][kk], kk < n (A·Bᵀ)
template <int RT>
__device__ __forceinline__ void dot_tile(float (&acc)[RT][RT],
                                         const float* A, const float* B,
                                         int ld, int n, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;
  for (int kk = 0; kk < n; ++kk) {
    float a[RT], bb[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = A[(ty + 16 * i) * ld + kk];
#pragma unroll
    for (int j = 0; j < RT; ++j) bb[j] = B[(tx + 16 * j) * ld + kk];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += Σ_r A[r][(ty+16i)] · B[r][(tx+16j)], r < n (Aᵀ·B), where
// A has row stride lda and B row stride ldb.
template <int RT, int NJ>
__device__ __forceinline__ void tn_acc(float (&acc)[RT][NJ], const float* A,
                                       int lda, const float* B, int ldb,
                                       int n, int tx, int ty) {
  for (int r = 0; r < n; ++r) {
    float a[RT], bb[NJ];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = A[r * lda + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bb[j] = B[r * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += Σ_c A[(ty+16i)][c] · B[c][(tx+16j)], c < n (A·B)
template <int RT, int NJ>
__device__ __forceinline__ void nn_acc(float (&acc)[RT][NJ], const float* A,
                                       int lda, const float* B, int ldb,
                                       int n, int tx, int ty) {
  for (int c = 0; c < n; ++c) {
    float a[RT], bb[NJ];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = A[(ty + 16 * i) * lda + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bb[j] = B[c * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int qi, int kp,
                                        int q_off) {
  return qi < a.Sq && kp < a.Skv && (!a.causal || kp <= q_off + qi);
}

// exclusive end of the keys that query rows [r0, r0 + rows) can see
__device__ __forceinline__ int key_end(const BwdArgs& a, int r0, int rows) {
  if (!a.causal) return a.Skv;
  const int last = min(r0 + rows, a.Sq) - 1;
  return min(a.Skv, max(0, a.Skv - a.Sq + last + 1));
}

// ---------------------------------------------------------------------------
// 1. row statistics: m, 1/l, Δ
// ---------------------------------------------------------------------------
template <typename T, int TS, int DMAX>
__global__ void __launch_bounds__(THREADS) stats_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int LD = DMAX + 1, RT = TS / 16;
  float* sQ = sm;
  float* sK = sQ + TS * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const int q_off = a.Skv - a.Sq;
  const T* q = row_base<T>(a.q, a.s[Q_], b, h);
  const T* k = row_base<T>(a.k, a.s[K_], b, kvh);
  load_rows<T, DMAX>(sQ, LD, q, a.s[Q_][2], r0, a.Sq, a.d, TS);

  float m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  const int kend = key_end(a, r0, TS);
  for (int c0 = 0; c0 < kend; c0 += TS) {
    __syncthreads();
    load_rows<T, DMAX>(sK, LD, k, a.s[K_][2], c0, a.Skv, a.d, TS);
    __syncthreads();
    float s[RT][RT];
    dot_tile<RT>(s, sQ, sK, LD, a.d, tx, ty);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qi = r0 + ty + 16 * i;
      float tmax = NEG_INF;
      bool any = false;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        s[i][j] *= a.scale;
        if (visible(a, qi, c0 + tx + 16 * j, q_off)) {
          tmax = fmaxf(tmax, s[i][j]);
          any = true;
        }
      }
      if (!any) continue;
      const float m_new = fmaxf(m[i], tmax);
      float sum = m[i] == NEG_INF ? 0.f : l[i] * expf(m[i] - m_new);
#pragma unroll
      for (int j = 0; j < RT; ++j)
        if (visible(a, qi, c0 + tx + 16 * j, q_off))
          sum += expf(s[i][j] - m_new);
      m[i] = m_new;
      l[i] = sum;
    }
  }

  const T* o = row_base<T>(a.o, a.s[O_], b, h);
  const T* dout = row_base<T>(a.dout, a.s[DO_], b, h);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qi = r0 + ty + 16 * i;
    const float mm = lane16_max(m[i]);
    const float part = m[i] == NEG_INF ? 0.f : l[i] * expf(m[i] - mm);
    const float ll = lane16_sum(part);
    float delta = 0.f;
    if (qi < a.Sq) {
      for (int e = tx; e < a.dv; e += 16)
        delta = fmaf(to_f32(dout[qi * a.s[DO_][2] + e]),
                     to_f32(o[qi * a.s[O_][2] + e]), delta);
    }
    delta = lane16_sum(delta);
    if (tx == 0 && qi < a.Sq) {
      float* st = a.stats + ((static_cast<long long>(b) * a.Hq + h) * a.Sq +
                             qi) * 3;
      st[0] = mm;
      st[1] = 1.f / fmaxf(ll, 1e-30f);
      st[2] = delta;
    }
  }
}

// P and dS of one (q tile × k tile) pair into shared memory: rows are
// query rows r0 + ty + 16i, columns keys c0 + tx + 16j.
template <int TS, int LD, int LP>
__device__ __forceinline__ void p_ds_tile(const BwdArgs& a, const float* sQ,
                                          const float* sK, const float* sdO,
                                          const float* sV,
                                          const float* sStat, float* sP,
                                          float* sdS, int r0, int c0,
                                          int tx, int ty) {
  constexpr int RT = TS / 16;
  const int q_off = a.Skv - a.Sq;
  float s[RT][RT], dp[RT][RT];
  dot_tile<RT>(s, sQ, sK, LD, a.d, tx, ty);
  dot_tile<RT>(dp, sdO, sV, LD, a.dv, tx, ty);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = ty + 16 * i;
    const float m = sStat[r], inv_l = sStat[TS + r], delta = sStat[2 * TS + r];
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int c = tx + 16 * j;
      const float p = visible(a, r0 + r, c0 + c, q_off)
                          ? expf(s[i][j] * a.scale - m) * inv_l
                          : 0.f;
      if (sP != nullptr) sP[r * LP + c] = p;
      sdS[r * LP + c] = p * (dp[i][j] - delta);
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_stats(float* sStat, const BwdArgs& a,
                                           int b, int h, int r0, int rows) {
  const float* st = a.stats + (static_cast<long long>(b) * a.Hq + h) * a.Sq * 3;
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    const int qi = r0 + i;
    const bool in = qi < a.Sq;
    sStat[i] = in ? st[qi * 3] : 0.f;
    sStat[rows + i] = in ? st[qi * 3 + 1] : 0.f;
    sStat[2 * rows + i] = in ? st[qi * 3 + 2] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 2. dK, dV: one block per (kv tile, kv head, batch row)
// ---------------------------------------------------------------------------
template <typename T, int TS, int DMAX>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int LD = DMAX + 1, LP = TS + 1, RT = TS / 16, NJ = DMAX / 16;
  float* sK = sm;
  float* sV = sK + TS * LD;
  float* sQ = sV + TS * LD;
  float* sdO = sQ + TS * LD;
  float* sP = sdO + TS * LD;
  float* sdS = sP + TS * LP;
  float* sStat = sdS + TS * LP;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int c0 = blockIdx.x * TS, kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int q_off = a.Skv - a.Sq;
  load_rows<T, DMAX>(sK, LD, row_base<T>(a.k, a.s[K_], b, kvh), a.s[K_][2],
                     c0, a.Skv, a.d, TS);
  load_rows<T, DMAX>(sV, LD, row_base<T>(a.v, a.s[V_], b, kvh), a.s[V_][2],
                     c0, a.Skv, a.dv, TS);
  // the first query row that sees key c0 (causal): q_off + i ≥ c0
  const int first = a.causal ? max(0, c0 - q_off) : 0;
  const int r_start = (first / TS) * TS;

  float dk[RT][NJ], dv[RT][NJ];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[i][j] = 0.f;
      dv[i][j] = 0.f;
    }
  for (int j = 0; j < group; ++j) {
    const int h = kvh * group + j;
    const T* q = row_base<T>(a.q, a.s[Q_], b, h);
    const T* dout = row_base<T>(a.dout, a.s[DO_], b, h);
    for (int r0 = r_start; r0 < a.Sq; r0 += TS) {
      __syncthreads();
      load_rows<T, DMAX>(sQ, LD, q, a.s[Q_][2], r0, a.Sq, a.d, TS);
      load_rows<T, DMAX>(sdO, LD, dout, a.s[DO_][2], r0, a.Sq, a.dv, TS);
      load_stats<T>(sStat, a, b, h, r0, TS);
      __syncthreads();
      p_ds_tile<TS, LD, LP>(a, sQ, sK, sdO, sV, sStat, sP, sdS, r0, c0, tx,
                            ty);
      __syncthreads();
      tn_acc<RT, NJ>(dv, sP, LP, sdO, LD, TS, tx, ty);
      tn_acc<RT, NJ>(dk, sdS, LP, sQ, LD, TS, tx, ty);
    }
  }
  T* gk = static_cast<T*>(a.gk) + b * a.s[DK_][0] + kvh * a.s[DK_][1];
  T* gv = static_cast<T*>(a.gv) + b * a.s[DV_][0] + kvh * a.s[DV_][1];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int kp = c0 + ty + 16 * i;
    if (kp >= a.Skv) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int e = tx + 16 * j;
      if (e < a.d) put(gk + kp * a.s[DK_][2] + e, a.scale * dk[i][j]);
      if (e < a.dv) put(gv + kp * a.s[DV_][2] + e, dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block per (q tile, q head, batch row)
// ---------------------------------------------------------------------------
template <typename T, int TS, int DMAX>
__global__ void __launch_bounds__(THREADS) dq_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int LD = DMAX + 1, LP = TS + 1, RT = TS / 16, NJ = DMAX / 16;
  float* sQ = sm;
  float* sdO = sQ + TS * LD;
  float* sK = sdO + TS * LD;
  float* sV = sK + TS * LD;
  float* sdS = sV + TS * LD;
  float* sStat = sdS + TS * LP;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  load_rows<T, DMAX>(sQ, LD, row_base<T>(a.q, a.s[Q_], b, h), a.s[Q_][2],
                     r0, a.Sq, a.d, TS);
  load_rows<T, DMAX>(sdO, LD, row_base<T>(a.dout, a.s[DO_], b, h),
                     a.s[DO_][2], r0, a.Sq, a.dv, TS);
  load_stats<T>(sStat, a, b, h, r0, TS);
  const T* k = row_base<T>(a.k, a.s[K_], b, kvh);
  const T* v = row_base<T>(a.v, a.s[V_], b, kvh);

  float dq[RT][NJ];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;
  const int kend = key_end(a, r0, TS);
  for (int c0 = 0; c0 < kend; c0 += TS) {
    __syncthreads();
    load_rows<T, DMAX>(sK, LD, k, a.s[K_][2], c0, a.Skv, a.d, TS);
    load_rows<T, DMAX>(sV, LD, v, a.s[V_][2], c0, a.Skv, a.dv, TS);
    __syncthreads();
    p_ds_tile<TS, LD, LP>(a, sQ, sK, sdO, sV, sStat, nullptr, sdS, r0, c0,
                          tx, ty);
    __syncthreads();
    nn_acc<RT, NJ>(dq, sdS, LP, sK, LD, TS, tx, ty);
  }
  T* gq = static_cast<T*>(a.gq) + b * a.s[DQ_][0] + h * a.s[DQ_][1];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qi = r0 + ty + 16 * i;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int e = tx + 16 * j;
      if (e < a.d) put(gq + qi * a.s[DQ_][2] + e, a.scale * dq[i][j]);
    }
  }
}

template <int TS, int DMAX>
constexpr int stats_smem() { return 2 * TS * (DMAX + 1) * 4; }
template <int TS, int DMAX>
constexpr int dkdv_smem() {
  return (4 * TS * (DMAX + 1) + 2 * TS * (TS + 1) + 3 * TS) * 4;
}
template <int TS, int DMAX>
constexpr int dq_smem() {
  return (4 * TS * (DMAX + 1) + TS * (TS + 1) + 3 * TS) * 4;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int TS, int DMAX>
int launch(const BwdArgs& a, int batch, cudaStream_t st) {
  auto k1 = stats_kernel<T, TS, DMAX>;
  auto k2 = dkdv_kernel<T, TS, DMAX>;
  auto k3 = dq_kernel<T, TS, DMAX>;
  int err = set_smem(k1, stats_smem<TS, DMAX>());
  if (!err) err = set_smem(k2, dkdv_smem<TS, DMAX>());
  if (!err) err = set_smem(k3, dq_smem<TS, DMAX>());
  if (err) return err;
  const int q_tiles = (a.Sq + TS - 1) / TS, k_tiles = (a.Skv + TS - 1) / TS;
  if (q_tiles > 0) {
    k1<<<dim3(q_tiles, a.Hq, batch), THREADS, stats_smem<TS, DMAX>(), st>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  if (k_tiles > 0) {
    k2<<<dim3(k_tiles, a.Hkv, batch), THREADS, dkdv_smem<TS, DMAX>(), st>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  if (q_tiles > 0) {
    k3<<<dim3(q_tiles, a.Hq, batch), THREADS, dq_smem<TS, DMAX>(), st>>>(a);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

template <typename T>
int launch_t(const BwdArgs& a, int batch, cudaStream_t st) {
  const int dmax = a.d > a.dv ? a.d : a.dv;
  if (dmax <= 64) return launch<T, 64, 64>(a, batch, st);
  if (dmax <= 128) return launch<T, 64, 128>(a, batch, st);
  return launch<T, 32, 256>(a, batch, st);
}

}  // namespace

// q (B, Hq, Sq, d), k (B, Hkv, Skv, d), v (B, Hkv, Skv, dv), o and dO
// (B, Hq, Sq, dv); gradients dq (B, Hq, Sq, d), dk (B, Hkv, Skv, d), dv
// (B, Hkv, Skv, dv); each with unit stride on its last axis.  strides[24]
// (host array) holds the (batch, head, row) element strides of q, k, v, o,
// dO, dq, dk and dv in that order.  stats: a device workspace of
// B·Hq·Sq·3 floats.  dtype 0 = f32, 1 = bf16 (all eight tensors alike);
// 1 ≤ d, dv ≤ 256, Hq a multiple of Hkv.  Returns cudaErrorInvalidValue
// unlaunched on other arguments, else cudaGetLastError() after the
// launches (0 = launched).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats,
    const long long* strides, int batch, int hq, int hkv, int sq, int skv,
    int d, int dv_dim, float scale, int causal, int dtype, void* stream) {
  const bool ok = d >= 1 && d <= 256 && dv_dim >= 1 && dv_dim <= 256 &&
                  hkv > 0 && hq % hkv == 0 && (dtype == 0 || dtype == 1) &&
                  batch >= 0 && sq >= 0 && skv >= 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || hq == 0 || (sq == 0 && skv == 0)) return 0;
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.gq = dq; a.gk = dk; a.gv = dv;
  a.stats = static_cast<float*>(stats);
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) a.s[t][i] = strides[3 * t + i];
  a.Hq = hq; a.Hkv = hkv; a.Sq = sq; a.Skv = skv; a.d = d; a.dv = dv_dim;
  a.scale = scale;
  a.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_t<__nv_bfloat16>(a, batch, st);
  return launch_t<float>(a, batch, st);
}
