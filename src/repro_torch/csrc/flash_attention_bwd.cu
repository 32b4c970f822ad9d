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
//   P_ip = exp(s_ip − lse_i)            (0 where masked)
//   dV_p = Σ_(h in group, i) P_ip dO_i
//   dP_ip = dO_i · v_p,  Δ_i = Σ_e dO_ie O_ie,  dS_ip = P_ip (dP_ip − Δ_i)
//   dQ_i = scale · Σ_p dS_ip k_p,   dK_p = scale · Σ_(h, i) dS_ip q_i
// lse_i = m_i + log(max(l_i, 1e-30)) is the forward's log-sum-exp, which
// the forward writes when asked (its lse argument), so no pass recomputes
// the row statistics.  The mask, not lse, makes P zero: a row with no
// visible key has P = 0 and zero gradients, as its output is 0.
//
// Three launches on the caller's stream, deterministic: every gradient
// element is written once by one thread from a sum in a fixed order, with
// no atomics (dQ is computed by its own kernel, not scattered from the
// dK/dV kernel as FlashAttention-2 does).  Launch 1 (both routes) is the Δ
// pass: one warp a query row, Δ in f32 into a (B, Hq, Sq) workspace the
// wrapper allocates (Δ is a launch of its own, not folded into the dQ
// kernel's prologue).  Launches 2 (dK/dV) and 3 (dQ) take one of two
// routes, chosen by the caller (the wrapper) by dtype and width:
//
// "mma" (bf16, d ≤ 192 and dv ≤ 128).  Every product is mma.sync m16n8k16
// bf16 → f32, 128 threads a block, 16 rows a warp; d is zero-padded to 64,
// 128 or 192 and dv to 64 or 128 in shared memory (exact; 192 / 128 is
// MLA's heads, DeepSeek-V2's q·k 128 nope + 64 rope and v 128, below);
// rows there are padded by 16 bytes so ldmatrix is conflict-free; the
// streamed operand goes through a two-stage cp.async ring of 16-byte
// copies (element by element where rows are not 16-byte aligned, as the
// forward's vec flag); masks apply only on tiles that reach Skv, Sq or
// the causal diagonal.  P and dS are rounded once to bf16 as the A
// operand of the next product, straight from the accumulators (no shared
// memory), as FlashAttention-2 does.
//  2. dK/dV, grid (Skv/64, Hkv, B): a block owns 64 keys of one kv head
//     (4 warps × 16 keys) and loops over the q tiles (BN rows: 64 when d,
//     dv ≤ 64, else 32) of all g query heads of the group in a fixed
//     order from the first tile that sees its keys.
//     Key-major, so that each warp's accumulator rows are its keys: Sᵀ =
//     K·Qᵀ, Pᵀ = exp(Sᵀ − lse) (lse and Δ index the accumulator's
//     column), dV += Pᵀ·dO, dPᵀ = V·dOᵀ, dSᵀ = Pᵀ ∘ (dPᵀ − Δ), dK +=
//     dSᵀ·Q.  K and V fragments stay in
//     registers (d, dv ≤ 64; reloaded from shared memory past that); Q and
//     dO stream through the ring, each read both ways (ldmatrix for the
//     ·Qᵀ products, ldmatrix.trans for the ·Q ones), with lse and Δ beside
//     them (4-byte cp.async).  dK, dV in f32 registers, written once in
//     bf16, the scale folded into dK.
//  3. dQ, grid (Sq/64, Hq, B), the longest (last) row tiles first: a block
//     owns 64 query rows of one head (4 warps × 16) and loops over the K/V
//     tiles (BN keys) up to its causal edge: S = Q·Kᵀ, P = exp(S − lse),
//     dP = dO·Vᵀ, dS = P ∘ (dP − Δ), dQ += dS·K — Q (d ≤ 128) and dO
//     fragments in registers, K and V through the ring (K read both ways).
//
// MLA's 192 / 128 heads on "mma".  Registers decide the design: a lane
// of the dK/dV kernel holds its 16 keys' dK (192 wide: 96 f32) and dV
// (128: 64) for the whole loop, beside Sᵀ and dPᵀ (16 each at 32-row q
// tiles): 192 accumulators of the 255.  ptxas fits the kernel in 254
// registers with no spill (K and V fragments come from shared memory, as
// they do past 64), and it runs 4.19 ms at B 1, H 128, S 2048 against
// 4.65 ms with 16-row q tiles (240 registers) (H100, tools/
// flash_mla_variants.py), so the tile and the 128 threads stay as they
// are at 128 / 128.  The dQ kernel keeps dQ (96) and dO (32) and
// restages Q's fragments from shared memory per key tile: with Q in
// registers (48 more) ptxas spills 8 bytes at 255 and the backward is
// no faster.  Every other choice stands: no atomics, one order of every
// sum, P and dS rounded once to bf16 from the accumulators, the scale
// folded into dK and dQ.  Two warps a 16-key slab (256 threads, dK's
// columns split) or dK held in shared memory were not needed.
//
// "simt" (f32; bf16 with d > 192 or dv > 128).  The same three launches in f32
// FMAs on the CUDA cores from f32 copies in shared memory: T = 64 keys and
// query rows when d, dv ≤ 128 (T = 32 up to 256), 256 threads as 16 × 16,
// each thread a (T/16) × (T/16) block of a score tile and (T/16) rows ×
// (DMAX/16) columns of a T × d product; shared rows are padded to an odd
// stride, so the column operand's 16 lanes hit 16 banks and the row
// operand is a broadcast.  P and dS go through shared memory in f32.
//
// Bound.  At Llama-3.2-1B's prefill shapes (B 4, Hq 32, Hkv 8, S 2048,
// d 64, bf16, causal) the function is five of the forward's two matmuls
// (S, dV, dP, dQ, dK), each 2·B·Hq·S²·d with half of it masked: 1.72e11
// operations, 0.174 ms at the 989 TFLOP/s bf16 tensor-core peak, against
// ~100 MB of inputs and gradients (0.03 ms at 3.35 TB/s) — bound by
// operations.  Determinism without atomics costs two products more (the
// dQ kernel recomputes S and dP): seven, 2.41e11 operations, a floor of
// 0.243 ms at that peak.  The "mma" route runs them as mma.sync (not
// wgmma, whose 64-row warpgroup tiles fed by TMA are the next step), with
// the softmax's exponentials on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr float NEG_INF = -FLT_MAX;  // finfo(f32).min, as the forward
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 256;         // "simt" blocks
constexpr int DELTA_THREADS = 256;   // the Δ pass: a warp a row

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* gq;  // dQ, dK, dV
  void* gk;
  void* gv;
  const float* lse;  // (B, Hq, Sq): the forward's log-sum-exp
  float* delta;      // (B, Hq, Sq): Δ, written by launch 1
  // (batch, head, row) element strides of q, k, v, o, dO, dQ, dK, dV
  long long s[8][3];
  int Hq, Hkv, Sq, Skv, d, dv;
  float scale;
  int causal;
  int vec;  // "mma": 16-byte copies of q, k, v and dO rows allowed
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

__device__ __forceinline__ long long row_index(const BwdArgs& a, int b,
                                               int h) {
  return (static_cast<long long>(b) * a.Hq + h) * a.Sq;
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
// 1. Δ_i = Σ_e dO_ie O_ie (both routes): one warp a (b, h, i) row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
delta_kernel(const BwdArgs a, long long n_rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (DELTA_THREADS / 32) +
      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int i = static_cast<int>(row % a.Sq);
  const long long bh = row / a.Sq;
  const int h = static_cast<int>(bh % a.Hq), b = static_cast<int>(bh / a.Hq);
  const T* o = row_base<T>(a.o, a.s[O_], b, h) + i * a.s[O_][2];
  const T* dout = row_base<T>(a.dout, a.s[DO_], b, h) + i * a.s[DO_][2];
  float x = 0.f;
  for (int e = lane; e < a.dv; e += 32)
    x = fmaf(to_f32(dout[e]), to_f32(o[e]), x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if (lane == 0) a.delta[row] = x;
}

// ---------------------------------------------------------------------------
// "simt": f32 FMAs from f32 copies in shared memory
// ---------------------------------------------------------------------------

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

// P and dS of one (q tile × k tile) pair into shared memory: rows are
// query rows r0 + ty + 16i, columns keys c0 + tx + 16j; sStat holds the
// tile's lse (T floats), then its Δ.
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
    const float lse = sStat[r], delta = sStat[TS + r];
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int c = tx + 16 * j;
      const float p = visible(a, r0 + r, c0 + c, q_off)
                          ? expf(s[i][j] * a.scale - lse)
                          : 0.f;
      if (sP != nullptr) sP[r * LP + c] = p;
      sdS[r * LP + c] = p * (dp[i][j] - delta);
    }
  }
}

__device__ __forceinline__ void load_stats(float* sStat, const BwdArgs& a,
                                           int b, int h, int r0, int rows) {
  const long long base = row_index(a, b, h);
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    const int qi = r0 + i;
    const bool in = qi < a.Sq;
    sStat[i] = in ? a.lse[base + qi] : 0.f;
    sStat[rows + i] = in ? a.delta[base + qi] : 0.f;
  }
}

// dK, dV: one block per (kv tile, kv head, batch row)
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
      load_stats(sStat, a, b, h, r0, TS);
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

// dQ: one block per (q tile, q head, batch row)
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
  load_stats(sStat, a, b, h, r0, TS);
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
constexpr int dkdv_smem() {
  return (4 * TS * (DMAX + 1) + 2 * TS * (TS + 1) + 2 * TS) * 4;
}
template <int TS, int DMAX>
constexpr int dq_smem() {
  return (4 * TS * (DMAX + 1) + TS * (TS + 1) + 2 * TS) * 4;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int TS, int DMAX>
int launch_simt(const BwdArgs& a, int batch, cudaStream_t st) {
  auto k2 = dkdv_kernel<T, TS, DMAX>;
  auto k3 = dq_kernel<T, TS, DMAX>;
  int err = set_smem(k2, dkdv_smem<TS, DMAX>());
  if (!err) err = set_smem(k3, dq_smem<TS, DMAX>());
  if (err) return err;
  const int q_tiles = (a.Sq + TS - 1) / TS, k_tiles = (a.Skv + TS - 1) / TS;
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
int launch_simt_t(const BwdArgs& a, int batch, cudaStream_t st) {
  const int dmax = a.d > a.dv ? a.d : a.dv;
  if (dmax <= 64) return launch_simt<T, 64, 64>(a, batch, st);
  if (dmax <= 128) return launch_simt<T, 64, 128>(a, batch, st);
  return launch_simt<T, 32, 256>(a, batch, st);
}

// ---------------------------------------------------------------------------
// "mma": bf16 tensor cores
// ---------------------------------------------------------------------------

using repro_cp::cp_async_commit;
using repro_cp::cp_async_wait;
using repro_mma::acc_to_a;
using repro_mma::bf16;
using repro_mma::ldsm_x4;
using repro_mma::ldsm_x4_t;
using repro_mma::mma_bf16;
using repro_mma::stage_bf16;

constexpr int MMA_THREADS = 128;  // 4 warps, 16 rows (keys or queries) each
constexpr int MMA_ROWS = 64;      // keys a dK/dV block, query rows a dQ block

// rows a stage of the streamed operand holds: q rows (dK/dV), keys (dQ)
__host__ __device__ constexpr int dkdv_bn(int dk, int dv) {
  return dk <= 64 && dv <= 64 ? 64 : 32;
}
__host__ __device__ constexpr int dq_bn(int dk, int dv) {
  return dk <= 64 && dv <= 64 ? 64 : 32;
}

// 4-byte global → shared copy; bytes 0 zero-fills (src is not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   repro_cp::smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// Shared memory (bytes) of the dK/dV kernel: K, V (64 rows) | 2 stages of
// Q, dO (BN rows) | 2 stages of lse, Δ (BN floats).
__host__ __device__ constexpr int dkdv_mma_smem(int dk, int dv) {
  return 2 * (MMA_ROWS + 2 * dkdv_bn(dk, dv)) * (dk + 8 + dv + 8) +
         4 * 4 * dkdv_bn(dk, dv);
}

// Shared memory (bytes) of the dQ kernel: Q, dO (64 rows) | 2 stages of K,
// V (BN rows).
__host__ __device__ constexpr int dq_mma_smem(int dk, int dv) {
  return 2 * (MMA_ROWS + 2 * dq_bn(dk, dv)) * (dk + 8 + dv + 8);
}

// B fragments of two adjacent 8-column blocks from a tile whose rows are
// the product's n (ldmatrix): rows n0 … n0 + 15, columns k0 … k0 + 15.
__device__ __forceinline__ void ld_b_rows(uint32_t (&r)[4], const bf16* t,
                                          int ld, int n0, int k0, int lane) {
  ldsm_x4(r, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments from a tile whose rows are the product's k (ldmatrix.trans):
// rows k0 … k0 + 15, columns n0 … n0 + 15.
__device__ __forceinline__ void ld_b_cols(uint32_t (&r)[4], const bf16* t,
                                          int ld, int k0, int n0, int lane) {
  ldsm_x4_t(r, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                   (lane >> 4) * 8);
}

// c[n] (16 × 8 blocks, N = 2·n2 count) += A (16 × 16·KC) · B, the B tile's
// rows the product's n; A fragments from `af(kc)`.
template <int KC, int NB, typename AFrag>
__device__ __forceinline__ void mma_rows(float (&c)[NB][4], AFrag af,
                                         const bf16* t, int ld, int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[4];
    af(a, kc);
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2) {
      uint32_t bfr[4];
      ld_b_rows(bfr, t, ld, n2 * 16, kc * 16, lane);
      mma_bf16(c[2 * n2], a, bfr[0], bfr[1]);
      mma_bf16(c[2 * n2 + 1], a, bfr[2], bfr[3]);
    }
  }
}

// c[n] (16 × 8 blocks) += X (16 × 16·KK, the accumulators x) · T, the T
// tile's rows the product's k.
template <int KK, int NB, int XB>
__device__ __forceinline__ void mma_cols(float (&c)[NB][4],
                                         const float (&x)[XB][4],
                                         const bf16* t, int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t a[4];
    acc_to_a(a, x, kk);
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2) {
      uint32_t bfr[4];
      ld_b_cols(bfr, t, ld, kk * 16, n2 * 16, lane);
      mma_bf16(c[2 * n2], a, bfr[0], bfr[1]);
      mma_bf16(c[2 * n2 + 1], a, bfr[2], bfr[3]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&c)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// DK, DV: d and dv padded (DK 64, 128 or 192; DV 64 or 128).
template <int DK, int DV>
__global__ void __launch_bounds__(MMA_THREADS)
dkdv_mma_kernel(const BwdArgs a) {
  constexpr int BN = dkdv_bn(DK, DV), LDK = DK + 8, LDV = DV + 8;
  constexpr bool KVREG = DK <= 64 && DV <= 64;
  extern __shared__ uint4 smem_u4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_u4);
  bf16* v_s = k_s + MMA_ROWS * LDK;
  bf16* q_s = v_s + MMA_ROWS * LDV;   // 2 stages of BN × LDK
  bf16* do_s = q_s + 2 * BN * LDK;    // 2 stages of BN × LDV
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BN * LDV);  // 2 × BN
  float* dl_s = lse_s + 2 * BN;                                  // 2 × BN

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.x * MMA_ROWS, kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int q_off = a.Skv - a.Sq;
  const bool vec = a.vec != 0;
  const bf16* kb = row_base<bf16>(a.k, a.s[K_], b, kvh);
  const bf16* vb = row_base<bf16>(a.v, a.s[V_], b, kvh);
  stage_bf16(k_s, LDK, MMA_ROWS, a.d, DK, vec, a.k,
             [&](int r) -> const bf16* {
               const int p = c0 + r;
               return p < a.Skv ? kb + p * a.s[K_][2] : nullptr;
             });
  stage_bf16(v_s, LDV, MMA_ROWS, a.dv, DV, vec, a.v,
             [&](int r) -> const bf16* {
               const int p = c0 + r;
               return p < a.Skv ? vb + p * a.s[V_][2] : nullptr;
             });
  cp_async_commit();

  // q tiles from the first that sees key c0 (causal: q_off + i ≥ c0), for
  // each head of the group in turn
  const int first = a.causal ? max(0, c0 - q_off) : 0;
  const int r_start = (first / BN) * BN;
  const int n_qt = a.Sq > r_start ? (a.Sq - r_start + BN - 1) / BN : 0;
  const int n_it = group * n_qt;
  auto load_q = [&](int it, int st) {
    const int j = it / n_qt, r0 = r_start + (it - j * n_qt) * BN;
    const int h = kvh * group + j;
    const bf16* qb = row_base<bf16>(a.q, a.s[Q_], b, h);
    const bf16* ob = row_base<bf16>(a.dout, a.s[DO_], b, h);
    stage_bf16(q_s + st * BN * LDK, LDK, BN, a.d, DK, vec, a.q,
               [&](int r) -> const bf16* {
                 const int qi = r0 + r;
                 return qi < a.Sq ? qb + qi * a.s[Q_][2] : nullptr;
               });
    stage_bf16(do_s + st * BN * LDV, LDV, BN, a.dv, DV, vec, a.dout,
               [&](int r) -> const bf16* {
                 const int qi = r0 + r;
                 return qi < a.Sq ? ob + qi * a.s[DO_][2] : nullptr;
               });
    const long long base = row_index(a, b, h);
    for (int i = threadIdx.x; i < 2 * BN; i += MMA_THREADS) {
      const int r = i < BN ? i : i - BN, qi = r0 + r;
      const bool in = qi < a.Sq;
      const float* src = (i < BN ? a.lse : a.delta) + base + (in ? qi : 0);
      cp_async4((i < BN ? lse_s : dl_s) + st * BN + r, src, in ? 4 : 0);
    }
    cp_async_commit();
  };
  if (n_it > 0) load_q(0, 0);

  const int wr = warp * 16;
  const int kp0 = c0 + wr + g, kp1 = kp0 + 8;  // this thread's keys
  const bf16* k_row = k_s + (wr + (lane & 15)) * LDK + (lane >> 4) * 8;
  const bf16* v_row = v_s + (wr + (lane & 15)) * LDV + (lane >> 4) * 8;
  uint32_t kf[KVREG ? DK / 16 : 1][4], vf[KVREG ? DV / 16 : 1][4];
  float dk[DK / 8][4], dv[DV / 8][4];
  zero(dk);
  zero(dv);
  const float sl2 = a.scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {
      load_q(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (KVREG && it == 0) {
#pragma unroll
      for (int kc = 0; kc < (KVREG ? DK / 16 : 1); ++kc)
        ldsm_x4(kf[kc], k_row + kc * 16);
#pragma unroll
      for (int kc = 0; kc < (KVREG ? DV / 16 : 1); ++kc)
        ldsm_x4(vf[kc], v_row + kc * 16);
    }
    const int r0 = r_start + (it % n_qt) * BN;
    const bf16* qs = q_s + st * BN * LDK;
    const bf16* dos = do_s + st * BN * LDV;
    const float* ls = lse_s + st * BN;
    const float* ds = dl_s + st * BN;

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (rows: keys, columns: the tile's queries)
    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
    mma_rows<DK / 16>(s, [&](uint32_t (&af)[4], int kc) {
      if (KVREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = kf[KVREG ? kc : 0][e];
      } else {
        ldsm_x4(af, k_row + kc * 16);
      }
    }, qs, LDK, lane);
    mma_rows<DV / 16>(dp, [&](uint32_t (&af)[4], int kc) {
      if (KVREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = vf[KVREG ? kc : 0][e];
      } else {
        ldsm_x4(af, v_row + kc * 16);
      }
    }, dos, LDV, lane);

    // Pᵀ = exp(Sᵀ·scale − lse), dSᵀ = Pᵀ (dPᵀ − Δ): lse and Δ by column
    const bool edge = c0 + MMA_ROWS > a.Skv || r0 + BN > a.Sq ||
                      (a.causal && c0 + MMA_ROWS - 1 > q_off + r0);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        const bool ok =
            !edge || visible(a, r0 + col, e < 2 ? kp0 : kp1, q_off);
        const float p =
            ok ? exp2f(fmaf(s[n][e], sl2, -ls[col] * LOG2E)) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - ds[col]);
      }

    // dV += Pᵀ dO, dK += dSᵀ Q (dO and Q by ldmatrix.trans)
    mma_cols<BN / 16>(dv, s, dos, LDV, lane);
    mma_cols<BN / 16>(dk, dp, qs, LDK, lane);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  bf16* gk = static_cast<bf16*>(a.gk) + b * a.s[DK_][0] + kvh * a.s[DK_][1];
  bf16* gv = static_cast<bf16*>(a.gv) + b * a.s[DV_][0] + kvh * a.s[DV_][1];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = half ? kp1 : kp0;
    if (kp >= a.Skv) continue;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t4 + e;
        if (col < a.d)
          gk[kp * a.s[DK_][2] + col] =
              __float2bfloat16_rn(a.scale * dk[n][2 * half + e]);
      }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t4 + e;
        if (col < a.dv)
          gv[kp * a.s[DV_][2] + col] =
              __float2bfloat16_rn(dv[n][2 * half + e]);
      }
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(MMA_THREADS)
dq_mma_kernel(const BwdArgs a) {
  constexpr int BN = dq_bn(DK, DV), LDK = DK + 8, LDV = DV + 8;
  constexpr bool QREG = DK <= 128;  // Q's fragments kept in registers
  extern __shared__ uint4 smem_u4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_u4);
  bf16* do_s = q_s + MMA_ROWS * LDK;
  bf16* k_s = do_s + MMA_ROWS * LDV;  // 2 stages of BN × LDK
  bf16* v_s = k_s + 2 * BN * LDK;     // 2 stages of BN × LDV

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * MMA_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const int q_off = a.Skv - a.Sq;
  const bool vec = a.vec != 0;
  const bf16* qb = row_base<bf16>(a.q, a.s[Q_], b, h);
  const bf16* ob = row_base<bf16>(a.dout, a.s[DO_], b, h);
  const bf16* kb = row_base<bf16>(a.k, a.s[K_], b, kvh);
  const bf16* vb = row_base<bf16>(a.v, a.s[V_], b, kvh);
  stage_bf16(q_s, LDK, MMA_ROWS, a.d, DK, vec, a.q,
             [&](int r) -> const bf16* {
               const int qi = r0 + r;
               return qi < a.Sq ? qb + qi * a.s[Q_][2] : nullptr;
             });
  stage_bf16(do_s, LDV, MMA_ROWS, a.dv, DV, vec, a.dout,
             [&](int r) -> const bf16* {
               const int qi = r0 + r;
               return qi < a.Sq ? ob + qi * a.s[DO_][2] : nullptr;
             });
  cp_async_commit();
  const int kend = key_end(a, r0, MMA_ROWS);
  const int n_kt = (kend + BN - 1) / BN;
  auto load_kv = [&](int t, int st) {
    const int k0 = t * BN;
    stage_bf16(k_s + st * BN * LDK, LDK, BN, a.d, DK, vec, a.k,
               [&](int r) -> const bf16* {
                 const int p = k0 + r;
                 return p < kend ? kb + p * a.s[K_][2] : nullptr;
               });
    stage_bf16(v_s + st * BN * LDV, LDV, BN, a.dv, DV, vec, a.v,
               [&](int r) -> const bf16* {
                 const int p = k0 + r;
                 return p < kend ? vb + p * a.s[V_][2] : nullptr;
               });
    cp_async_commit();
  };
  if (n_kt > 0) load_kv(0, 0);

  const int wr = warp * 16;
  const int qi0 = r0 + wr + g, qi1 = qi0 + 8;  // this thread's rows
  const long long base = row_index(a, b, h);
  const float nl0 = qi0 < a.Sq ? -a.lse[base + qi0] * LOG2E : 0.f;
  const float nl1 = qi1 < a.Sq ? -a.lse[base + qi1] * LOG2E : 0.f;
  const float dl0 = qi0 < a.Sq ? a.delta[base + qi0] : 0.f;
  const float dl1 = qi1 < a.Sq ? a.delta[base + qi1] : 0.f;
  const float sl2 = a.scale * LOG2E;
  const bf16* q_row = q_s + (wr + (lane & 15)) * LDK + (lane >> 4) * 8;
  uint32_t qf[QREG ? DK / 16 : 1][4], of[DV / 16][4];
  float dq[DK / 8][4];
  zero(dq);

  for (int t = 0; t < n_kt; ++t) {
    const int st = t & 1;
    if (t + 1 < n_kt) {
      load_kv(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < (QREG ? DK / 16 : 1); ++kc)
        if (QREG) ldsm_x4(qf[kc], q_row + kc * 16);
#pragma unroll
      for (int kc = 0; kc < DV / 16; ++kc)
        ldsm_x4(of[kc], do_s + (wr + (lane & 15)) * LDV + (lane >> 4) * 8 +
                            kc * 16);
    }
    const int k0 = t * BN;
    const bf16* ks = k_s + st * BN * LDK;
    const bf16* vs = v_s + st * BN * LDV;

    // S = Q Kᵀ and dP = dO Vᵀ (rows: queries, columns: the tile's keys)
    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
    mma_rows<DK / 16>(s, [&](uint32_t (&af)[4], int kc) {
      if (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = qf[QREG ? kc : 0][e];
      } else {
        ldsm_x4(af, q_row + kc * 16);
      }
    }, ks, LDK, lane);
    mma_rows<DV / 16>(dp, [&](uint32_t (&af)[4], int kc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) af[e] = of[kc][e];
    }, vs, LDV, lane);

    // P = exp(S·scale − lse), dS = P (dP − Δ): lse and Δ by row
    const bool edge =
        k0 + BN > a.Skv || (a.causal && k0 + BN - 1 > q_off + r0);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + n * 8 + 2 * t4 + (e & 1);
        const bool ok = !edge || visible(a, e < 2 ? qi0 : qi1, kp, q_off);
        const float p =
            ok ? exp2f(fmaf(s[n][e], sl2, e < 2 ? nl0 : nl1)) : 0.f;
        dp[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1));
      }

    // dQ += dS K (K by ldmatrix.trans)
    mma_cols<BN / 16>(dq, dp, ks, LDK, lane);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  bf16* gq = static_cast<bf16*>(a.gq) + b * a.s[DQ_][0] + h * a.s[DQ_][1];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? qi1 : qi0;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t4 + e;
        if (col < a.d)
          gq[qi * a.s[DQ_][2] + col] =
              __float2bfloat16_rn(a.scale * dq[n][2 * half + e]);
      }
  }
}

template <int DK, int DV>
int launch_mma(const BwdArgs& a, int batch, cudaStream_t st) {
  auto k2 = dkdv_mma_kernel<DK, DV>;
  auto k3 = dq_mma_kernel<DK, DV>;
  constexpr int b2 = dkdv_mma_smem(DK, DV), b3 = dq_mma_smem(DK, DV);
  int err = set_smem(k2, b2);
  if (!err) err = set_smem(k3, b3);
  if (err) return err;
  const int k_tiles = (a.Skv + MMA_ROWS - 1) / MMA_ROWS;
  const int q_tiles = (a.Sq + MMA_ROWS - 1) / MMA_ROWS;
  if (k_tiles > 0) {
    k2<<<dim3(k_tiles, a.Hkv, batch), MMA_THREADS, b2, st>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  if (q_tiles > 0) {
    k3<<<dim3(q_tiles, a.Hq, batch), MMA_THREADS, b3, st>>>(a);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

// d, dv padded to the instantiation's DK, DV: 64 / 64, 64 / 128, 128 / 64,
// 128 / 128, and 192 / 128 for any d in 129 … 192 (dv ≤ 128)
int launch_mma_all(const BwdArgs& a, int batch, cudaStream_t st) {
  if (a.d > 128) return launch_mma<192, 128>(a, batch, st);
  if (a.d <= 64 && a.dv <= 64) return launch_mma<64, 64>(a, batch, st);
  if (a.d <= 64) return launch_mma<64, 128>(a, batch, st);
  if (a.dv <= 64) return launch_mma<128, 64>(a, batch, st);
  return launch_mma<128, 128>(a, batch, st);
}

template <typename T>
int launch_delta(const BwdArgs& a, int batch, cudaStream_t st) {
  const long long n_rows = static_cast<long long>(batch) * a.Hq * a.Sq;
  if (n_rows == 0) return 0;
  constexpr int per_block = DELTA_THREADS / 32;
  const long long blocks = (n_rows + per_block - 1) / per_block;
  delta_kernel<T><<<static_cast<unsigned>(blocks), DELTA_THREADS, 0, st>>>(
      a, n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, Sq, d), k (B, Hkv, Skv, d), v (B, Hkv, Skv, dv), o and dO
// (B, Hq, Sq, dv); gradients dq (B, Hq, Sq, d), dk (B, Hkv, Skv, d), dv
// (B, Hkv, Skv, dv); each with unit stride on its last axis.  strides[24]
// (host array) holds the (batch, head, row) element strides of q, k, v, o,
// dO, dq, dk and dv in that order.  lse: the forward's (B, Hq, Sq)
// contiguous f32 log-sum-exp; delta: a (B, Hq, Sq) f32 device workspace.
// dtype 0 = f32, 1 = bf16 (all eight tensors alike); 1 ≤ d, dv ≤ 256, Hq a
// multiple of Hkv.  route 0 = "simt", 1 = "mma" (bf16, d ≤ 192, dv ≤ 128).
// Returns cudaErrorInvalidValue unlaunched on other arguments, else
// cudaGetLastError() after the launches (0 = launched).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, const long long* strides, int batch, int hq, int hkv,
    int sq, int skv, int d, int dv_dim, float scale, int causal, int dtype,
    int route, void* stream) {
  const bool ok = d >= 1 && d <= 256 && dv_dim >= 1 && dv_dim <= 256 &&
                  hkv > 0 && hq % hkv == 0 && (dtype == 0 || dtype == 1) &&
                  batch >= 0 && sq >= 0 && skv >= 0 &&
                  (route == 0 ||
                   (route == 1 && dtype == 1 && d <= 192 && dv_dim <= 128));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || hq == 0 || (sq == 0 && skv == 0)) return 0;
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.gq = dq; a.gk = dk; a.gv = dv;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) a.s[t][i] = strides[3 * t + i];
  a.Hq = hq; a.Hkv = hkv; a.Sq = sq; a.Skv = skv; a.d = d; a.dv = dv_dim;
  a.scale = scale;
  a.causal = causal;
  // 16-byte copies need rows of whole 8-element chunks at 16-byte
  // addresses: q, k, v and dO (the tensors the "mma" route stages)
  const int staged[4] = {Q_, K_, V_, DO_};
  const void* ptrs[4] = {q, k, v, dout};
  bool vec = d % 8 == 0 && dv_dim % 8 == 0;
  for (int t = 0; t < 4; ++t) {
    vec = vec && reinterpret_cast<uintptr_t>(ptrs[t]) % 16 == 0;
    for (int i = 0; i < 3; ++i) vec = vec && a.s[staged[t]][i] % 8 == 0;
  }
  a.vec = vec ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = dtype == 1 ? launch_delta<__nv_bfloat16>(a, batch, st)
                       : launch_delta<float>(a, batch, st);
  if (err) return err;
  if (route == 1) return launch_mma_all(a, batch, st);
  if (dtype == 1) return launch_simt_t<__nv_bfloat16>(a, batch, st);
  return launch_simt_t<float>(a, batch, st);
}
