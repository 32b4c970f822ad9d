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
// Design.  The TPU kernel walks a (B, Hq, Sq/bq, Skv/bk) grid with the KV
// axis innermost, carrying m / l / acc in VMEM scratch from one grid step
// to the next, and reads each K/V block once per query head.  Here one
// thread block owns (batch row, kv head, tile of BR packed query rows),
// where the packed rows are (query position, head of the group) pairs,
// query-major: the group's Hq/Hkv heads share every K/V tile the block
// stages, so Llama's group of 4 reads K/V once per kv head, and a decode
// step (Sq = 1) still puts the whole group in one tile (BR = 16).  The KV
// loop runs inside the block: each 64-key K and V tile is staged in shared
// memory as f32 (16-byte loads where strides allow), scores for a BR × 64
// tile come from 4×4 register tiles per thread (float4 shared loads along
// the head dim), the row max and sum are reduced across the 16 threads of
// a row with warp shuffles, p goes to shared memory, and each thread
// accumulates its 4 rows × DVT output columns in registers.  Tiles past
// the causal frontier of the block's last row, or past kv_end, are never
// loaded (a decode launch reads no key at or past kv_len).  Sq and Skv
// need not divide the tile sizes: ragged rows and keys are masked.
//
// Guards, as in the TPU kernel: NEG_INF is finfo(f32).min, not -inf;
// p = exp(s − m_new) but 0 where s == NEG_INF; alpha = exp(m_prev − m_new)
// but 0 where m_prev == NEG_INF; the output divides by max(l, 1e-30), so a
// fully masked row is 0.  Exponentials are expf (not __expf), the final
// division is IEEE (__fdiv_rn), and l is updated with separately rounded
// products and sums; the dot products use fused multiply-adds in a fixed
// order, so the kernel agrees with repro_torch.kernels.flash_attention.
// flash_attention_plain to rounding (atol 1e-5 in f32), not bit for bit.
//
// Bound.  At the prefill launch of Llama-3.2-1B (B = 4, Hq = 32, Hkv = 8,
// S = 2048, d = 64, bf16, causal) the function needs 4·B·Hq·S²·d/2 ≈ 6.9e10
// operations (0.07 ms at the 989 TFLOP/s bf16 tensor-core peak) against
// ~84 MB of q/k/v/o (0.025 ms at 3.35 TB/s): bound by operations.  This
// kernel does them as f32 FMAs on the CUDA cores (67 TFLOP/s peak), so it
// cannot come within 15× of that bound; mma/wgmma QKᵀ and PV with p in
// bf16 are the next design.  A decode launch (Sq = 1, kv_len ≈ 2049) must
// read 2·B·Hkv·L·d·2 B ≈ 16.8 MB of cache (5.0 µs at 3.35 TB/s): bound by
// bytes, and with one block per (b, kv head) — 32 blocks on 132 SMs — by
// the latency of each block's serial tile loop; split-K over the cache is
// the next design there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BC = 64;              // keys per K/V tile
constexpr float NEG_INF = -FLT_MAX;  // finfo(f32).min, as the TPU kernel

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_len;  // nullptr: kv_end = Skv, q_off = Skv − Sq
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, row) strides
  int Hq, Hkv, Sq, Skv, d, dv;
  float scale;
  int causal;
  int vec;  // 16-byte loads of q/k/v rows allowed
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// one 16-byte chunk of a row → f32 in shared memory
__device__ __forceinline__ void chunk_to_f32(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void chunk_to_f32(float* dst,
                                             const __nv_bfloat16* src) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, e.x, e.y);
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

}  // namespace

// q (B, Hq, Sq, d), k (B, Hkv, Skv, d), v (B, Hkv, Skv, dv), o (B, Hq, Sq,
// dv), each with unit stride on its last axis; strides[12] (host array)
// holds the (batch, head, row) element strides of q, k, v and o in that
// order.  kv_len: (B,) int32 on the device, or nullptr.  dtype 0 = f32,
// 1 = bf16 (q, k, v and o alike).  d, dv ≤ 256 (the wrapper checks).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const void* kv_len,
                                     const long long* strides, int batch,
                                     int hq, int hkv, int sq, int skv, int d,
                                     int dv, float scale, int causal,
                                     int dtype, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
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
  if (dtype == 1) return launch_t<__nv_bfloat16>(a, batch, s);
  return launch_t<float>(a, batch, s);
}
