// Fused centroid distances for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/cluster.py
// (fused_centroid_distances, body _dist_kernel): for (m, D) f32 rows x and
// (C, D) f32 centroids c it writes the (m, C) squared distances
//   out[i, j] = max((‖x_i‖² − 2·x_i·c_j) + ‖c_j‖², 0).
//
// Order of sums.  Every sum — ‖x‖², ‖c‖² and x·c — runs in order
// d = 0..D−1 with separately rounded products and sums (__fmul_rn /
// __fadd_rn, no multiply-add contraction), so the tensor cores and FMA
// stay out.  That fixed order per output is the point: the index compares
// spill distances of a refolded subset of rows with a cold pass over all
// rows bit for bit, so a row's distances must not depend on the batch, and
// the plain version (repro_torch.kernels.ref.centroid_distances_ref, the
// same ordered loop in torch) must agree with the kernel bit for bit.
//
// Design.  One block owns a slab of R rows and a tile of the centroids
// (all of them up to 96; past that, balanced tiles of at most 96), so a
// row's ‖x‖² is computed once a launch (once a centroid tile) and a
// centroid's ‖c‖² once a row slab — not once an output, as before.  Each
// thread owns TM × TN outputs (rows g + i·RG, centroids cg + j·NCG: the
// strides put the rows and centroids a warp reads on distinct banks) in
// registers.  The block streams D through shared memory in BK-wide stages,
// double-buffered and filled with 16-byte cp.async copies (rows whose
// width is not a multiple of 4 take plain loads), and reads each stage
// back as float4s, a full stage unrolled: TM + TN loads feed 2·TM·TN·4
// instructions.  One thread
// per row and per centroid adds the stage's squares to its norm, kept in
// shared memory across stages.  Column tiles are sized in steps of TN, so
// 78 centroids take 80 slots (not 96 as with 32 × 32 tiles).  Features
// past D are zero in both operands: their products are +0, and a sum that
// starts at +0 is never −0 (round to nearest gives −0 only for two −0
// addends), so adding them leaves its bits as they are.
//
// Bound.  One multiply and one add per (row, centroid, feature) for the
// cross term, pinned (no FMA): 2·m·C·D instructions against (m + C)·D·4 +
// m·C·4 bytes.  At the index's shapes (6040 × 78 centroids × 256 proxy
// dims) that is 2.4e8 instructions (~0.007 ms at half the f32 peak, the
// no-FMA floor) and 6.3 MB (~0.002 ms at 3.35 TB/s): bound by
// operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using repro_cp::cp_async16;
using repro_cp::cp_async_commit;
using repro_cp::cp_async_wait;

constexpr int TM = 4, TN = 4;   // outputs a thread: rows × centroids
constexpr int BK = 32;          // features a stage
constexpr int LD = BK + 4;      // shared row stride: 144 bytes
constexpr int MAX_THREADS = 128;
constexpr int MAX_ROWS = 64;    // R = RG · TM
constexpr int MAX_COLS = 96;    // centroids a tile

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
dist_kernel(const float* __restrict__ x, const float* __restrict__ c,
            float* __restrict__ out, int m, int n, int d, int ncg, int rg,
            int ct) {
  __shared__ __align__(16) float Xs[2][MAX_ROWS][LD];
  __shared__ __align__(16) float Cs[2][MAX_COLS][LD];
  __shared__ float s_norm[MAX_ROWS + MAX_COLS];

  const int tid = threadIdx.x;
  const int nthreads = ncg * rg;
  const int cg = tid % ncg;
  const int g = tid / ncg;
  const int R = rg * TM;
  const int row0 = blockIdx.x * R;
  const int col0 = blockIdx.y * ct;
  const int nrows = min(R, m - row0);
  const int ncols = min(ct, n - col0);
  const int n_norm = R + ct;

  // stage s of the rows and centroids into buffer b; zeros past m, C, D
  auto load = [&](int s, int b) {
    const int k0 = s * BK;
    if (VEC) {
      for (int q = tid; q < n_norm * (BK / 4); q += nthreads) {
        const int r = q / (BK / 4), f = (q % (BK / 4)) * 4;
        const bool in_x = r < R;
        const int rr = in_x ? r : r - R;
        const bool ok = (in_x ? rr < nrows : rr < ncols) && k0 + f < d;
        const float* src = in_x ? x + static_cast<size_t>(row0 + rr) * d
                                : c + static_cast<size_t>(col0 + rr) * d;
        float* dst = in_x ? &Xs[b][rr][f] : &Cs[b][rr][f];
        cp_async16(dst, ok ? src + k0 + f : x, ok ? 16 : 0);
      }
      cp_async_commit();
    } else {
      for (int q = tid; q < n_norm * BK; q += nthreads) {
        const int r = q / BK, f = q % BK;
        const bool in_x = r < R;
        const int rr = in_x ? r : r - R;
        const bool ok = (in_x ? rr < nrows : rr < ncols) && k0 + f < d;
        const float* src = in_x ? x + static_cast<size_t>(row0 + rr) * d
                                : c + static_cast<size_t>(col0 + rr) * d;
        (in_x ? Xs[b][rr] : Cs[b][rr])[f] = ok ? src[k0 + f] : 0.f;
      }
    }
  };

  for (int e = tid; e < n_norm; e += nthreads) s_norm[e] = 0.f;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_stages = (d + BK - 1) / BK;
  if (n_stages) load(0, 0);
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      load(s + 1, (s + 1) & 1);
      if (VEC) cp_async_wait<1>();
    } else if (VEC) {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int b = s & 1;
    const int kend = min(BK, d - s * BK);   // rounded up below: zeros
    for (int e = tid; e < n_norm; e += nthreads) {
      const float* p = e < R ? Xs[b][e] : Cs[b][e - R];
      float a = s_norm[e];
      for (int f = 0; f < kend; f += 4) {
        const float4 v = *reinterpret_cast<const float4*>(p + f);
        a = __fadd_rn(a, __fmul_rn(v.x, v.x));
        a = __fadd_rn(a, __fmul_rn(v.y, v.y));
        a = __fadd_rn(a, __fmul_rn(v.z, v.z));
        a = __fadd_rn(a, __fmul_rn(v.w, v.w));
      }
      s_norm[e] = a;
    }
    // four features of the cross term, feature by feature: TM · TN
    // independent sums a step
    auto step = [&](int f) {
      float4 av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(&Xs[b][g + i * rg][f]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        bv[j] = *reinterpret_cast<const float4*>(&Cs[b][cg + j * ncg][f]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(comp(av[i], e),
                                                       comp(bv[j], e)));
    };
    if (kend == BK) {   // a full stage, unrolled: loads hoisted ahead
#pragma unroll
      for (int f = 0; f < BK; f += 4) step(f);
    } else {
      for (int f = 0; f < kend; f += 4) step(f);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = g + i * rg;
    if (r >= nrows) continue;
    const float xx = s_norm[r];
    float* o = out + static_cast<size_t>(row0 + r) * n + col0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cj = cg + j * ncg;
      if (cj >= ncols) continue;
      const float t = __fsub_rn(xx, __fmul_rn(2.f, acc[i][j]));
      o[cj] = fmaxf(__fadd_rn(t, s_norm[R + cj]), 0.f);
    }
  }
}

}  // namespace

// x: (m, d) f32; c: (n, d) f32; out: (m, n).  Returns cudaGetLastError()
// after the launch (0 = launched); the caller raises on anything else.
extern "C" int repro_centroid_distances(const void* x, const void* c,
                                        void* out, int m, int n, int d,
                                        void* stream) {
  const int n_tiles = (n + MAX_COLS - 1) / MAX_COLS;
  const int per_tile = (n + n_tiles - 1) / n_tiles;
  const int ncg = (per_tile + TN - 1) / TN;
  const int rg = min(MAX_ROWS / TM, max(1, MAX_THREADS / ncg));
  const dim3 grid((m + rg * TM - 1) / (rg * TM), n_tiles);
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(c);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(xf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cf) % 16 == 0;
  if (vec) {
    dist_kernel<true><<<grid, ncg * rg, 0, s>>>(xf, cf, o, m, n, d, ncg, rg,
                                                ncg * TN);
  } else {
    dist_kernel<false><<<grid, ncg * rg, 0, s>>>(xf, cf, o, m, n, d, ncg, rg,
                                                 ncg * TN);
  }
  return static_cast<int>(cudaGetLastError());
}
