// Causal GQA flash attention (forward) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel).  For query head h = kv·g + j of
// batch row b, query i at position q_off + i and key position p:
//   s   = scale · q·k_p                  (NEG_INF where masked)
//   out = Σ_p softmax(s)_p · v_p        (0 on a row with no visible key)
// with an online softmax over KV tiles in f32 and the output in q's
// dtype.  Masked: p ≥ kv_end, and p > q_off + i when causal.  Without
// kv_len, kv_end = Skv and q_off = Skv − Sq (the TPU kernel's decode
// alignment); with kv_len (B,) int32, kv_end = min(kv_len[b], Skv) and
// q_off = kv_len[b] − Sq — the reference's decode_attention
// (repro/models/common.py) when Sq = 1.
//
// Rows are packed as in the TPU kernel's GQA reading: one block owns
// (batch row, kv head) and a run of packed rows — (query position, head
// of the group) pairs, query-major — so the group's Hq/Hkv heads share
// every K/V tile the block stages, and K/V is read once per kv head.
// One C entry point takes three routes, chosen by the caller (the
// wrapper) by dtype and by packed rows R = Sq·Hq/Hkv:
//
// "simt" (f32).  BR = 64 packed rows a block (16 when R ≤ 16); each
// 64-key K and V tile is staged in shared memory as f32 (16-byte loads
// where strides allow), scores for a BR × 64 tile come from 4×4 register
// tiles per thread, row max / sum are reduced with warp shuffles, p goes
// to shared memory, and each thread accumulates 4 rows × DVT output
// columns.  f32 FMAs on the CUDA cores keep the 1e-5 contract of the
// reference's Precision.HIGHEST (TF32 tensor cores would not).
//
// "mma" (bf16, R > 16).  BR = 64 packed rows a block, 16 a warp.  K and V
// tiles of 32 keys stay bf16 in shared memory (32 keys, not 64: 96
// registers, five blocks an SM, 11 % faster at the Llama shape), fed
// by a two-stage cp.async ring of 16-byte copies (the next tile loads
// while this one is computed), rows padded by 16 bytes so ldmatrix is
// conflict-free.  The warp's Q fragments are loaded once with ldmatrix
// and kept in registers (d ≤ QREG_MAX_DK and dv ≤ 128; reloaded from
// shared memory per tile past that).  S = QKᵀ is mma.sync m16n8k16 bf16
// → f32; the online softmax runs on the accumulator fragments in f32; P
// goes from the S registers to A fragments without shared memory, split
// as p_hi = bf16(p), p_lo = bf16(p − p_hi), and O += P·V is two mma.sync
// (V fragments by ldmatrix.trans), so P keeps ~2⁻¹⁷ of relative
// precision while l is summed from the f32 p.  d is zero-padded to 64,
// 128, 192 or 256 and dv to 64, 128 or 256 in shared memory (exact).
// 192 is MLA's q·k width (DeepSeek-V2: 128 nope + 64 rope, v 128): its
// own tile runs S = QKᵀ as 12 k-steps of 16 with no zero columns, where
// padding to 256 would run 16.  Masks apply only on tiles that reach
// kv_end or the causal frontier of the block's first row.  Blocks run
// the longest (last) row tiles first.
//
// "split" (bf16, R ≤ 16: decode).  Split-K over the keys, two launches.
// Launch 1, grid (splits, Hkv, B): a block takes 128 keys of one
// (b, kv head) — K and V by 16-byte cp.async, V landing while the scores
// are computed — one key a thread: R dot products in f32 against the
// group's q rows (f32 in shared memory), the chunk's row max and sum by
// warp shuffles, p in shared memory, and P·V by (column pair, key group)
// threads reduced in a fixed order; it writes the rows' partial m, l and
// unnormalised acc (f32) to a workspace the wrapper allocates.  Launch 2,
// grid (Hkv, B), combines the splits in split order: M = max m_s, w_s =
// exp(m_s − M) (0 where m_s is NEG_INF), L = Σ w_s·l_s, acc = Σ w_s·acc_s,
// out = acc / max(L, 1e-30) in bf16.  A split at or past a row's key end
// is never started or read, so kv_len 0 gives exact zeros.
//
// Log-sum-exp (for the backward, csrc/flash_attention_bwd.cu): when the
// caller passes an lse buffer, each route's epilogue also writes every
// row's m + log(max(l, 1e-30)) from the m and l it already holds ("split":
// the combine's M and L).  Without one nothing else changes: "mma" takes
// the write as a template argument, since at 64 / 64 it costs the one
// register (97) that would leave four blocks an SM instead of five.
//
// Guards, as in the TPU kernel, on every route: NEG_INF is
// finfo(f32).min, not -inf; p = exp(s − m_new) but 0 where s == NEG_INF;
// alpha = exp(m_prev − m_new) but 0 where m_prev == NEG_INF; the output
// divides by max(l, 1e-30), so a fully masked row is 0.  Exponentials are
// expf (not __expf), the final division is IEEE (__fdiv_rn), and l is
// updated with separately rounded products and sums.  No key at or past
// a row's kv_end (nor past the block's causal frontier) is loaded.
//
// Bound.  At the prefill launch of Llama-3.2-1B (B = 4, Hq = 32, Hkv = 8,
// S = 2048, d = 64, bf16, causal) the function needs 4·B·Hq·S²·d/2 ≈ 6.9e10
// operations (0.07 ms at the 989 TFLOP/s bf16 tensor-core peak) against
// ~84 MB of q/k/v/o (0.025 ms at 3.35 TB/s): bound by operations.  The
// mma route does QKᵀ once and PV twice (the P split) on mma.sync, not
// wgmma, and its softmax on the CUDA cores.  A decode launch (Sq = 1,
// kv_len ≈ 2049) must read 2·B·Hkv·L·d·2 B ≈ 16.8 MB of cache (5.0 µs at
// 3.35 TB/s): bound by bytes; the split route puts 17 × 8 × 4 = 544
// blocks of 128 keys on the 132 SMs, so every SM has loads in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BC = 64;              // keys per K/V tile
constexpr float NEG_INF = -FLT_MAX;  // finfo(f32).min, as the TPU kernel

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;         // (B, Hq, Sq) f32 log-sum-exp of the scaled scores, or
                      // nullptr: not written
  const int* kv_len;  // nullptr: kv_end = Skv, q_off = Skv − Sq
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, row) strides
  int Hq, Hkv, Sq, Skv, d, dv;
  float scale;
  int causal;
  int vec;  // 16-byte loads of q/k/v rows allowed
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

// one 16-byte chunk of a row → f32 in shared memory
__device__ __forceinline__ void chunk_to_f32(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

// Stage `nrows` rows into dst (row stride ld floats, `width` columns, a
// multiple of 4 — and of the chunk width when vec).  Row r comes from
// row_ptr(r) (nullptr: a row of zeros); columns ≥ ncols are zero.
template <typename T, typename RowPtr>
__device__ __forceinline__ void stage(float* dst, int ld, int nrows,
                                      int ncols, int width, bool vec,
                                      RowPtr row_ptr) {
  constexpr int VW = 16 / sizeof(T);
  if (vec) {
    const int cpr = width / VW;
    for (int i = threadIdx.x; i < nrows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) * VW;
      float* d = dst + r * ld + c;
      const T* src = row_ptr(r);
      if (src != nullptr && c < ncols) {
        chunk_to_f32(d, src + c);
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) d[e] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < nrows * width; i += blockDim.x) {
      const int r = i / width, c = i - r * width;
      const T* src = row_ptr(r);
      dst[r * ld + c] = (src != nullptr && c < ncols) ? to_f32(src[c]) : 0.f;
    }
  }
}

__device__ __forceinline__ float row_reduce_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_reduce_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Shared-memory layout (floats): q BR×ld | k BC×ld | v BC×ldv | p BR×ldp.
__host__ __device__ __forceinline__ int smem_floats(int br, int d, int dvt) {
  const int ld = round4(d) + 4;
  return br * ld + BC * ld + BC * 16 * dvt + br * (BC + 4);
}

// BR packed query rows per block; (BR/4) × 16 threads, each owning 4 rows
// × (4 score columns, DVT output columns).
template <typename T, int BR, int DVT>
__global__ void __launch_bounds__(BR * 4)
flash_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int width = round4(a.d), ld = width + 4;
  constexpr int LDV = 16 * DVT, LDP = BC + 4;
  float* q_s = smem;
  float* k_s = q_s + BR * ld;
  float* v_s = k_s + BC * ld;
  float* p_s = v_s + BC * LDV;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int n_rows = a.Sq * group;
  const int r0 = blockIdx.x * BR;
  const int kv_req = a.kv_len != nullptr ? a.kv_len[b] : a.Skv;
  const int kv_end = max(0, min(kv_req, a.Skv));
  const int q_off = kv_req - a.Sq;
  int key_end = kv_end;  // no row of this tile sees a key at or past this
  if (a.causal) {
    const int last_qi = (min(r0 + BR, n_rows) - 1) / group;
    key_end = min(kv_end, max(0, q_off + last_qi + 1));
  }
  const int n_tiles = (key_end + BC - 1) / BC;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const bool vec = a.vec != 0;

  stage<T>(q_s, ld, BR, a.d, width, vec, [&](int r) -> const T* {
    const int pr = r0 + r;
    if (pr >= n_rows) return nullptr;
    const int qi = pr / group, h = hk * group + (pr - qi * group);
    return qb + h * a.qs[1] + qi * a.qs[2];
  });

  int qpos[4];
  float m[4], l[4], acc[4][DVT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q_off + (r0 + ty * 4 + i) / group;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DVT; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BC;
    __syncthreads();  // the previous tile's k_s / v_s / p_s are consumed
    stage<T>(k_s, ld, BC, a.d, width, vec, [&](int r) -> const T* {
      const int p = k0 + r;
      return p < key_end ? kb + p * a.ks[2] : nullptr;
    });
    stage<T>(v_s, LDV, BC, a.dv, LDV, vec, [&](int r) -> const T* {
      const int p = k0 + r;
      return p < key_end ? vb + p * a.vs[2] : nullptr;
    });
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int kk = 0; kk < width; kk += 4) {
      float4 qa[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * ld + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * ld + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = fmaf(qa[i].x, kv[j].x, x);
          x = fmaf(qa[i].y, kv[j].y, x);
          x = fmaf(qa[i].z, kv[j].z, x);
          x = fmaf(qa[i].w, kv[j].w, x);
          s[i][j] = x;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = k0 + tx + 16 * j;
        const bool ok = p < kv_end && (!a.causal || p <= qpos[i]);
        s[i][j] = ok ? __fmul_rn(s[i][j], a.scale) : NEG_INF;
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_reduce_max(mc));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == NEG_INF ? 0.f : expf(s[i][j] - m_new);
        ps = __fadd_rn(ps, p);
        p_s[(ty * 4 + i) * LDP + tx + 16 * j] = p;
      }
      ps = row_reduce_sum(ps);
      const float alpha = m[i] == NEG_INF ? 0.f : expf(m[i] - m_new);
      l[i] = __fadd_rn(__fmul_rn(alpha, l[i]), ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DVT; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
    }
    __syncthreads();

    for (int j = 0; j < BC; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(p_s + (ty * 4 + i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DVT];
#pragma unroll
        for (int c4 = 0; c4 < DVT; c4 += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              v_s + (j + jj) * LDV + tx * DVT + c4);
          vv[c4] = x.x; vv[c4 + 1] = x.y; vv[c4 + 2] = x.z; vv[c4 + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y
                        : jj == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < DVT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* ob = static_cast<T*>(a.o) + b * a.os[0];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pr = r0 + ty * 4 + i;
    if (pr >= n_rows) continue;
    const int qi = pr / group, h = hk * group + (pr - qi * group);
    T* orow = ob + h * a.os[1] + qi * a.os[2];
    const float den = fmaxf(l[i], 1e-30f);
    if (a.lse != nullptr && tx == 0)
      a.lse[(static_cast<long long>(b) * a.Hq + h) * a.Sq + qi] =
          m[i] + logf(den);
#pragma unroll
    for (int c = 0; c < DVT; ++c) {
      const int col = tx * DVT + c;
      if (col < a.dv) store_out(orow + col, __fdiv_rn(acc[i][c], den));
    }
  }
}

template <typename T, int BR, int DVT>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int n_rows = a.Sq * (a.Hq / a.Hkv);
  const dim3 grid((n_rows + BR - 1) / BR, a.Hkv, batch);
  const size_t bytes = sizeof(float) * smem_floats(BR, a.d, DVT);
  auto kern = flash_kernel<T, BR, DVT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, BR * 4, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BR>
int launch_dv(const Args& a, int batch, cudaStream_t stream) {
  if (a.dv <= 64) return launch<T, BR, 4>(a, batch, stream);
  if (a.dv <= 128) return launch<T, BR, 8>(a, batch, stream);
  return launch<T, BR, 16>(a, batch, stream);
}

template <typename T>
int launch_t(const Args& a, int batch, cudaStream_t stream) {
  if (a.Sq * (a.Hq / a.Hkv) <= 16) return launch_dv<T, 16>(a, batch, stream);
  return launch_dv<T, 64>(a, batch, stream);
}


// ---- bf16 routes: shared pieces --------------------------------------------

using repro_mma::bf16;

using repro_cp::cp_async_commit;
using repro_cp::cp_async_wait;
using repro_mma::ldsm_x4;
using repro_mma::ldsm_x4_t;
using repro_mma::mma_bf16;
using repro_mma::split_bf16x2;
using repro_mma::stage_bf16;

// ---- "mma": tensor-core prefill (bf16, more than 16 packed rows) -----------

constexpr int MMA_BR = 64;       // packed rows a block, 16 a warp
constexpr int MMA_THREADS = 128;
constexpr int MMA_KEYS = 32;     // keys a K/V tile
// Widest padded d whose Q fragments a warp keeps in registers (with dv ≤
// 128).  At MLA's 192 / 128 they would be 48 more registers a lane: ptxas
// gives 177 with them (two blocks an SM) and 140 without (three), and the
// MLA prefill runs 5.71 ms without, 7.11 ms with (H100, tools/
// flash_mla_variants.py), so past 128 they are reloaded per key tile.
constexpr int QREG_MAX_DK = 128;

__host__ __device__ constexpr int mma_smem_bytes(int dk, int dv) {
  return 2 * (MMA_BR * (dk + 8) + 2 * MMA_KEYS * (dk + 8) +
              2 * MMA_KEYS * (dv + 8));
}

// DK, DV: d and dv padded (DK 64, 128, 192 or 256; DV 64, 128 or 256).
// Fragment layouts are those of mma.m16n8k16: lane = 4·g + t4; an
// accumulator holds (row g, cols 2·t4, 2·t4 + 1) in [0, 1] and row g + 8
// in [2, 3].  LSE: write a.lse (a template argument, so that without it
// the kernel keeps its registers: 96 at 64 / 64, five blocks an SM).
template <int DK, int DV, bool LSE>
__global__ void __launch_bounds__(MMA_THREADS)
mma_kernel(const Args a) {
  constexpr int BK = MMA_KEYS;
  constexpr int LDK = DK + 8, LDV = DV + 8;
  constexpr bool QREG = DK <= QREG_MAX_DK && DV <= 128;
  extern __shared__ uint4 smem_u4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_u4);
  bf16* k_s = q_s + MMA_BR * LDK;
  bf16* v_s = k_s + 2 * BK * LDK;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int n_rows = a.Sq * group;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * MMA_BR;
  const int kv_req = a.kv_len != nullptr ? a.kv_len[b] : a.Skv;
  const int kv_end = max(0, min(kv_req, a.Skv));
  const int q_off = kv_req - a.Sq;
  int key_end = kv_end;  // no row of this block sees a key at or past this
  if (a.causal) {
    const int last_qi = (min(r0 + MMA_BR, n_rows) - 1) / group;
    key_end = min(kv_end, max(0, q_off + last_qi + 1));
  }
  const int n_tiles = (key_end + BK - 1) / BK;
  const int qpos_first = q_off + r0 / group;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs[0];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const bool vec = a.vec != 0;

  stage_bf16(q_s, LDK, MMA_BR, a.d, DK, vec, a.q, [&](int r) -> const bf16* {
    const int pr = r0 + r;
    if (pr >= n_rows) return nullptr;
    const int qi = pr / group, h = hk * group + (pr - qi * group);
    return qb + h * a.qs[1] + qi * a.qs[2];
  });
  cp_async_commit();
  auto load_kv = [&](int t, int st) {
    const int k0 = t * BK;
    stage_bf16(k_s + st * BK * LDK, LDK, BK, a.d, DK, vec, a.k,
               [&](int r) -> const bf16* {
                 const int p = k0 + r;
                 return p < key_end ? kb + p * a.ks[2] : nullptr;
               });
    stage_bf16(v_s + st * BK * LDV, LDV, BK, a.dv, DV, vec, a.v,
               [&](int r) -> const bf16* {
                 const int p = k0 + r;
                 return p < key_end ? vb + p * a.vs[2] : nullptr;
               });
    cp_async_commit();
  };
  if (n_tiles > 0) load_kv(0, 0);

  const int wr = warp * 16;
  const int pr0 = r0 + wr + g, pr1 = pr0 + 8;
  const int qpos0 = q_off + pr0 / group, qpos1 = q_off + pr1 / group;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  uint32_t qf[QREG ? DK / 16 : 1][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = k_s + st * BK * LDK;
    const bf16* vs = v_s + st * BK * LDV;
    const bf16* q_row = q_s + (wr + (lane & 15)) * LDK + (lane >> 4) * 8;
    if (QREG && t == 0) {
#pragma unroll
      for (int kc = 0; kc < (QREG ? DK / 16 : 1); ++kc)
        ldsm_x4(qf[kc], q_row + kc * 16);
    }

    // S = Q Kᵀ over the tile's BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DK / 16; ++kc) {
      uint32_t af[4];
      if (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = qf[QREG ? kc : 0][e];
      } else {
        ldsm_x4(af, q_row + kc * 16);
      }
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        uint32_t bfr[4];
        ldsm_x4(bfr, ks + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDK +
                         kc * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * n2], af, bfr[0], bfr[1]);
        mma_bf16(s[2 * n2 + 1], af, bfr[2], bfr[3]);
      }
    }

    // online softmax on the fragments (rows g and g + 8 of the warp)
    const int k0 = t * BK;
    const bool edge =
        k0 + BK > kv_end || (a.causal && k0 + BK - 1 > qpos_first);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = k0 + n * 8 + 2 * t4 + (e & 1);
        const int qp = e < 2 ? qpos0 : qpos1;
        const bool ok =
            !edge || (p < kv_end && (!a.causal || p <= qp));
        const float x = ok ? __fmul_rn(s[n][e], a.scale) : NEG_INF;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        const float p = s[n][e] == NEG_INF ? 0.f : expf(s[n][e] - mn);
        s[n][e] = p;
        if (e < 2) ps0 = __fadd_rn(ps0, p); else ps1 = __fadd_rn(ps1, p);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 = __fadd_rn(ps0, __shfl_xor_sync(0xffffffffu, ps0, off));
      ps1 = __fadd_rn(ps1, __shfl_xor_sync(0xffffffffu, ps1, off));
    }
    const float al0 = m0 == NEG_INF ? 0.f : expf(m0 - mn0);
    const float al1 = m1 == NEG_INF ? 0.f : expf(m1 - mn1);
    l0 = __fadd_rn(__fmul_rn(al0, l0), ps0);
    l1 = __fadd_rn(__fmul_rn(al1, l1), ps1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[n][0] = __fmul_rn(o[n][0], al0);
      o[n][1] = __fmul_rn(o[n][1], al0);
      o[n][2] = __fmul_rn(o[n][2], al1);
      o[n][3] = __fmul_rn(o[n][3], al1);
    }

    // O += P V, P as p_hi + p_lo
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int n2 = 0; n2 < DV / 16; ++n2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             LDV + n2 * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * n2], ah, vf[0], vf[1]);
        mma_bf16(o[2 * n2], al, vf[0], vf[1]);
        mma_bf16(o[2 * n2 + 1], ah, vf[2], vf[3]);
        mma_bf16(o[2 * n2 + 1], al, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  bf16* ob = static_cast<bf16*>(a.o) + b * a.os[0];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pr = half ? pr1 : pr0;
    if (pr >= n_rows) continue;
    const int qi = pr / group, h = hk * group + (pr - qi * group);
    bf16* orow = ob + h * a.os[1] + qi * a.os[2];
    const float den = fmaxf(half ? l1 : l0, 1e-30f);
    if (LSE && t4 == 0)
      a.lse[(static_cast<long long>(b) * a.Hq + h) * a.Sq + qi] =
          (half ? m1 : m0) + logf(den);
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t4 + e;
        if (col < a.dv)
          orow[col] = __float2bfloat16_rn(__fdiv_rn(o[n][2 * half + e], den));
      }
  }
}

template <int DK, int DV>
int launch_mma(const Args& a, int batch, cudaStream_t stream) {
  const int n_rows = a.Sq * (a.Hq / a.Hkv);
  const dim3 grid((n_rows + MMA_BR - 1) / MMA_BR, a.Hkv, batch);
  constexpr int bytes = mma_smem_bytes(DK, DV);
  auto kern = a.lse != nullptr ? mma_kernel<DK, DV, true>
                               : mma_kernel<DK, DV, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, MMA_THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DK>
int launch_mma_dv(const Args& a, int batch, cudaStream_t stream) {
  if (a.dv <= 64) return launch_mma<DK, 64>(a, batch, stream);
  if (a.dv <= 128) return launch_mma<DK, 128>(a, batch, stream);
  return launch_mma<DK, 256>(a, batch, stream);
}

// d padded to the tile's DK: 64, 128, 192 (MLA's q·k width) or 256; the
// wrapper's mma_tile() states the same rule
int launch_mma_all(const Args& a, int batch, cudaStream_t stream) {
  if (a.d <= 64) return launch_mma_dv<64>(a, batch, stream);
  if (a.d <= 128) return launch_mma_dv<128>(a, batch, stream);
  if (a.d <= 192) return launch_mma_dv<192>(a, batch, stream);
  return launch_mma_dv<256>(a, batch, stream);
}

// ---- "split": split-K decode (bf16, at most 16 packed rows) ----------------

constexpr int SPLIT_KEYS = 128;   // keys a split block takes, one a thread
constexpr int SPLIT_ROWS = 16;    // packed rows a split holds at most
constexpr int SPLIT_THREADS = SPLIT_KEYS;
constexpr int COMBINE_THREADS = 256;

__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }
// V is staged VW columns wide: 32, 64 or 128 column pairs cover dv
__host__ __device__ __forceinline__ int split_vw(int dv) {
  return dv <= 64 ? 64 : dv <= 128 ? 128 : 256;
}

struct SplitLayout {   // shared-memory offsets in bytes
  int q, kr, v, p, red, bytes;
};

__host__ __device__ __forceinline__ SplitLayout split_layout(int rows, int d,
                                                             int dv) {
  const int dw = round8(d), vw = split_vw(dv);
  const int kg = SPLIT_THREADS / (vw / 2);
  SplitLayout L;
  L.q = 0;                                          // rows × dw f32
  L.kr = L.q + rows * dw * 4;                       // K, then the PV partials
  const int k_bytes = SPLIT_KEYS * (dw + 8) * 2;
  const int red_bytes = kg * rows * vw * 4;
  L.v = L.kr + (k_bytes > red_bytes ? k_bytes : red_bytes);
  L.p = L.v + SPLIT_KEYS * (vw + 8) * 2;            // rows × SPLIT_KEYS f32
  L.red = L.p + rows * SPLIT_KEYS * 4;              // 2 × 4 warps × 16 f32
  L.bytes = L.red + 2 * (SPLIT_THREADS / 32) * SPLIT_ROWS * 4;
  return L;
}

// The keys no packed row of (b) sees at or past: kv_end, or the causal
// frontier of the last query.
__device__ __forceinline__ int split_key_end(const Args& a, int b,
                                             int* kv_end_out, int* q_off_out) {
  const int kv_req = a.kv_len != nullptr ? a.kv_len[b] : a.Skv;
  const int kv_end = max(0, min(kv_req, a.Skv));
  const int q_off = kv_req - a.Sq;
  *kv_end_out = kv_end;
  *q_off_out = q_off;
  return a.causal ? min(kv_end, max(0, q_off + a.Sq)) : kv_end;
}

// Workspace (f32): acc [B][Hkv][n_split][16][dv], then m and l
// [B][Hkv][n_split][16] each.
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kernel(const Args a, float* __restrict__ ws, int n_split) {
  extern __shared__ uint4 smem_u4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_u4);
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = a.Hq / a.Hkv;
  const int rows = a.Sq * group;
  int kv_end, q_off;
  const int key_end = split_key_end(a, b, &kv_end, &q_off);
  const int c0 = split * SPLIT_KEYS;
  if (c0 >= key_end) return;          // never read by the combine
  const int c1 = min(c0 + SPLIT_KEYS, key_end);

  const int dw = round8(a.d), vw = split_vw(a.dv);
  const int ldk = dw + 8, ldv = vw + 8;
  const SplitLayout L = split_layout(rows, a.d, a.dv);
  float* q_f = reinterpret_cast<float*>(smem + L.q);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L.kr);
  float* red = reinterpret_cast<float*>(smem + L.kr);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L.v);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* red_m = reinterpret_cast<float*>(smem + L.red);
  float* red_l = red_m + (SPLIT_THREADS / 32) * SPLIT_ROWS;

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs[0];
  const bool vec = a.vec != 0;
  stage_bf16(k_s, ldk, SPLIT_KEYS, a.d, dw, vec, a.k,
             [&](int r) -> const bf16* {
               const int p = c0 + r;
               return p < c1 ? kb + p * a.ks[2] : nullptr;
             });
  cp_async_commit();
  stage_bf16(v_s, ldv, SPLIT_KEYS, a.dv, vw, vec, a.v,
             [&](int r) -> const bf16* {
               const int p = c0 + r;
               return p < c1 ? vb + p * a.vs[2] : nullptr;
             });
  cp_async_commit();
  for (int i = tid; i < rows * dw; i += SPLIT_THREADS) {
    const int r = i / dw, c = i - r * dw;
    const int qi = r / group, h = hk * group + (r - qi * group);
    q_f[i] = c < a.d ? __bfloat162float(qb[h * a.qs[1] + qi * a.qs[2] + c])
                     : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();

  // scores of this thread's key against every packed row
  const int p = c0 + tid;
  float s[SPLIT_ROWS];
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) s[r] = 0.f;
  const bf16* krow = k_s + tid * ldk;
  for (int c = 0; c < dw; c += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(krow + c);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
    float kf[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      kf[2 * e] = f.x;
      kf[2 * e + 1] = f.y;
    }
#pragma unroll
    for (int r = 0; r < SPLIT_ROWS; ++r) {
      if (r < rows) {
        const float* qr = q_f + r * dw + c;
        float x = s[r];
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(qr[e], kf[e], x);
        s[r] = x;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) {
    if (r < rows) {
      const bool ok =
          p < c1 && p < kv_end && (!a.causal || p <= q_off + r / group);
      s[r] = ok ? __fmul_rn(s[r], a.scale) : NEG_INF;
      float mx = s[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) red_m[warp * SPLIT_ROWS + r] = mx;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) {
    if (r < rows) {
      float mr = red_m[r];
#pragma unroll
      for (int w = 1; w < SPLIT_THREADS / 32; ++w)
        mr = fmaxf(mr, red_m[w * SPLIT_ROWS + r]);
      const float pv = s[r] == NEG_INF ? 0.f : expf(s[r] - mr);
      p_s[r * SPLIT_KEYS + tid] = pv;
      float sum = pv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      if (lane == 0) red_l[warp * SPLIT_ROWS + r] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // P·V: thread (column pair, key group), partials reduced in key-group
  // order (the K tile's space holds them)
  const int npairs = vw / 2, kg_n = SPLIT_THREADS / npairs;
  const int pair = tid % npairs, kg = tid / npairs;
  const int kpg = SPLIT_KEYS / kg_n;
  const int k_lo = kg * kpg, k_hi = min(k_lo + kpg, c1 - c0);
  float acc[SPLIT_ROWS][2];
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int j = k_lo; j < k_hi; ++j) {
    const float2 vv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(v_s + j * ldv + 2 * pair));
#pragma unroll
    for (int r = 0; r < SPLIT_ROWS; ++r) {
      if (r < rows) {
        const float pv = p_s[r * SPLIT_KEYS + j];
        acc[r][0] = fmaf(pv, vv.x, acc[r][0]);
        acc[r][1] = fmaf(pv, vv.y, acc[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) {
    if (r < rows) {
      red[(kg * rows + r) * vw + 2 * pair] = acc[r][0];
      red[(kg * rows + r) * vw + 2 * pair + 1] = acc[r][1];
    }
  }
  __syncthreads();

  const size_t slot = (static_cast<size_t>(b) * a.Hkv + hk) * n_split + split;
  const size_t n_slots = static_cast<size_t>(gridDim.z) * a.Hkv * n_split;
  float* ws_acc = ws + slot * SPLIT_ROWS * a.dv;
  float* ws_m = ws + n_slots * SPLIT_ROWS * a.dv + slot * SPLIT_ROWS;
  float* ws_l = ws_m + n_slots * SPLIT_ROWS;
  for (int i = tid; i < rows * a.dv; i += SPLIT_THREADS) {
    const int r = i / a.dv, c = i - r * a.dv;
    float x = red[r * vw + c];
    for (int k2 = 1; k2 < kg_n; ++k2)
      x = __fadd_rn(x, red[(k2 * rows + r) * vw + c]);
    ws_acc[r * a.dv + c] = x;
  }
  if (tid < rows) {
    float l = red_l[tid];
#pragma unroll
    for (int w = 1; w < SPLIT_THREADS / 32; ++w)
      l = __fadd_rn(l, red_l[w * SPLIT_ROWS + tid]);
    float mr = red_m[tid];
#pragma unroll
    for (int w = 1; w < SPLIT_THREADS / 32; ++w)
      mr = fmaxf(mr, red_m[w * SPLIT_ROWS + tid]);
    ws_m[tid] = mr;
    ws_l[tid] = l;
  }
}

// Combines the splits of each (b, kv head) in split order → bf16 output.
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const Args a, const float* __restrict__ ws, int n_split,
               int batch) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int group = a.Hq / a.Hkv;
  const int rows = a.Sq * group;
  int kv_end, q_off;
  const int key_end = split_key_end(a, b, &kv_end, &q_off);
  const int ns = (key_end + SPLIT_KEYS - 1) / SPLIT_KEYS;
  const size_t slot0 = (static_cast<size_t>(b) * a.Hkv + hk) * n_split;
  const size_t n_slots = static_cast<size_t>(batch) * a.Hkv * n_split;
  const float* ws_m = ws + n_slots * SPLIT_ROWS * a.dv;
  const float* ws_l = ws_m + n_slots * SPLIT_ROWS;
  bf16* ob = static_cast<bf16*>(a.o) + b * a.os[0];
  for (int i = threadIdx.x; i < rows * a.dv; i += COMBINE_THREADS) {
    const int r = i / a.dv, c = i - r * a.dv;
    float mx = NEG_INF;
    for (int sp = 0; sp < ns; ++sp)
      mx = fmaxf(mx, ws_m[(slot0 + sp) * SPLIT_ROWS + r]);
    float l = 0.f, acc = 0.f;
    for (int sp = 0; sp < ns; ++sp) {
      const size_t at = (slot0 + sp) * SPLIT_ROWS + r;
      const float ms = ws_m[at];
      const float w = ms == NEG_INF ? 0.f : expf(ms - mx);
      l = __fadd_rn(l, __fmul_rn(w, ws_l[at]));
      acc = __fadd_rn(acc, __fmul_rn(w, ws[at * a.dv + c]));
    }
    const int qi = r / group, h = hk * group + (r - qi * group);
    const float den = fmaxf(l, 1e-30f);
    ob[h * a.os[1] + qi * a.os[2] + c] =
        __float2bfloat16_rn(__fdiv_rn(acc, den));
    if (a.lse != nullptr && c == 0)
      a.lse[(static_cast<long long>(b) * a.Hq + h) * a.Sq + qi] =
          mx + logf(den);
  }
}

int split_count(int skv) {
  return skv > 0 ? (skv + SPLIT_KEYS - 1) / SPLIT_KEYS : 1;
}

int launch_split(const Args& a, int batch, float* ws, cudaStream_t stream) {
  const int n_split = split_count(a.Skv);
  const int rows = a.Sq * (a.Hq / a.Hkv);
  const int bytes = split_layout(rows, a.d, a.dv).bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  split_kernel<<<dim3(n_split, a.Hkv, batch), SPLIT_THREADS, bytes, stream>>>(
      a, ws, n_split);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  combine_kernel<<<dim3(a.Hkv, batch), COMBINE_THREADS, 0, stream>>>(
      a, ws, n_split, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of workspace the "split" route needs (the wrapper allocates it).
extern "C" long long repro_flash_split_workspace(int batch, int hkv, int skv,
                                                 int dv) {
  return static_cast<long long>(batch) * hkv * split_count(skv) *
         SPLIT_ROWS * (dv + 2);
}

// q (B, Hq, Sq, d), k (B, Hkv, Skv, d), v (B, Hkv, Skv, dv), o (B, Hq, Sq,
// dv), each with unit stride on its last axis; strides[12] (host array)
// holds the (batch, head, row) element strides of q, k, v and o in that
// order.  lse: (B, Hq, Sq) contiguous f32 on the device, or nullptr; when
// set, every route writes each row's m + log(max(l, 1e-30)) (m the row's
// max scaled score, NEG_INF on a row with no visible key, l its sum of
// exp(s − m)) from the m and l its epilogue holds, for the backward.
// kv_len: (B,) int32 on the device, or nullptr.  dtype 0 = f32,
// 1 = bf16 (q, k, v and o alike); 1 ≤ d, dv ≤ 256.  route 0 = "simt"
// (f32), 1 = "mma" (bf16, Sq·Hq/Hkv > 16), 2 = "split" (bf16, Sq·Hq/Hkv ≤
// 16; workspace of repro_flash_split_workspace floats).  A route that does
// not take the dtype or shape returns cudaErrorInvalidValue unlaunched.
// Otherwise returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     const void* kv_len,
                                     const long long* strides, int batch,
                                     int hq, int hkv, int sq, int skv, int d,
                                     int dv, float scale, int causal,
                                     int dtype, int route, void* workspace,
                                     void* stream) {
  const int rows = hkv > 0 ? sq * (hq / hkv) : 0;
  const bool ok_shape = d >= 1 && d <= 256 && dv >= 1 && dv <= 256;
  const bool ok = ok_shape &&
      ((route == 0 && dtype == 0) || (route == 1 && dtype == 1 && rows > 16) ||
       (route == 2 && dtype == 1 && rows <= 16 && workspace != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.lse = static_cast<float*>(lse);
  a.kv_len = static_cast<const int*>(kv_len);
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.Hq = hq; a.Hkv = hkv; a.Sq = sq; a.Skv = skv; a.d = d; a.dv = dv;
  a.scale = scale;
  a.causal = causal;
  const int vw = dtype == 1 ? 8 : 4;
  bool vec = d % vw == 0 && dv % vw == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % vw == 0;
  vec = vec && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(v) % 16 == 0;
  a.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) return launch_mma_all(a, batch, s);
  if (route == 2)
    return launch_split(a, batch, static_cast<float*>(workspace), s);
  return launch_t<float>(a, batch, s);
}
