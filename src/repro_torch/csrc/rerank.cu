// Fused co-rated Gram rerank for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/rerank.py
// (fused_rerank_scores, body _rerank_kernel): the exact rerank of the
// clustered index scores a block of G query rows (f32) against the union
// of their shortlisted candidates, Kc rows gathered once (int8 or f32),
// with the candidates' full-row norms and rated counts passed in:
//   cosine : dot / max(‖q‖·norm_c, ε)                  (one product)
//   jaccard: n / max((count_q + count_c) − n, ε)       (one product)
//   pcc    : the six co-rated products, mapped to [0, 1]; pcc_sig scales
//            by min(n, β)/β
// with n = Σ 1[q>0]·1[c>0], dot = Σ q·c and the pcc terms as in
// similarity.cu.  Every product carries a query-side factor, so full-width
// candidate rows give exactly the co-rated sums.
//
// Design.  The tiling of similarity.cu: one thread block per 64×64
// output tile, 32-item shared-memory tiles of both operands (the loop
// takes the place of the TPU grid's sequential K axis), a 4×4 register
// sub-tile per thread.  The measure is a template parameter, so cosine
// and jaccard keep one accumulator set and pcc six.  The first 64
// threads fold the query rows' rated count and squared norm over the
// item axis.  Candidate tiles are read as int8 where the gather source is
// int8 (4× fewer bytes) and widened in registers.
//
// Exactness.  On integer ratings every Gram sum is an integer below 2^24
// (25·3952), exact in any order, and the epilogue keeps the reference's
// operation order with explicitly rounded intrinsics (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn): the kernel, the plain
// torch.matmul version and the reference's oracle agree bit for bit.
//
// Bound.  2·G·Kc·J f32 operations per product (1 for cosine and jaccard,
// 6 for pcc).  One 2048-query block at 6040 users, pcc, unions padded to
// Kc = 8192, J = 3952: 6·2·2048·8192·3952 ≈ 7.96e11 operations, ~11.9 ms
// at 67 TFLOP/s; the bytes (2048·3952·4 + 8192·3952 + 2048·8192·4 ≈
// 133 MB, ~0.04 ms) do not bind.  Bound by operations.
//
// Next design (not in this file): int8 wgmma (the ratings, masks and
// squares are exact in int8 with an int32 accumulator), and scoring only
// the real union columns instead of the power-of-two padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // candidate rows per block
constexpr int BK = 32;        // items per shared-memory tile
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int NT = 256;       // 16 × 16 threads
constexpr int PAD = 4;
constexpr float EPS = 1e-8f;

enum Measure { JACCARD = 0, COSINE = 1, PCC = 2, PCC_SIG = 3 };

template <typename T>
__device__ __forceinline__ float widen(const T* p) {
  return static_cast<float>(*p);
}

template <typename TC, int KIND>   // KIND: JACCARD, COSINE or PCC
__global__ void __launch_bounds__(NT)
rerank_kernel(const float* __restrict__ qv, const TC* __restrict__ cr,
              const float* __restrict__ cnorm,
              const float* __restrict__ ccount, float* __restrict__ out,
              int g, int kc, int j, int pcc_sig, float beta) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ float stat[2][BM];   // query rated count, squared norm

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  constexpr int NACC = (KIND == PCC) ? 6 : 1;
  float acc[NACC][TM][TN];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) acc[a][i][jj] = 0.f;
  float row_cnt = 0.f, row_sq = 0.f;

  for (int k0 = 0; k0 < j; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < g && gc < j) ? qv[static_cast<size_t>(gr) * j + gc]
                                    : 0.f;
    }
    for (int e = tid; e < BN * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int gr = col0 + r, gc = k0 + c;
      Bs[c][r] = (gr < kc && gc < j)
                     ? widen(cr + static_cast<size_t>(gr) * j + gc)
                     : 0.f;
    }
    __syncthreads();

    if (tid < BM) {
#pragma unroll 8
      for (int c = 0; c < BK; ++c) {
        const float a = As[c][tid];
        row_cnt += (a > 0.f) ? 1.f : 0.f;
        row_sq = __fadd_rn(row_sq, __fmul_rn(a, a));
      }
    }

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 av = *reinterpret_cast<const float4*>(&As[c][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[c][tx * TN]);
      const float a[TM] = {av.x, av.y, av.z, av.w};
      const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
      float ma[TM], mb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ma[i] = (a[i] > 0.f) ? 1.f : 0.f;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) mb[jj] = (b[jj] > 0.f) ? 1.f : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) {
          if constexpr (KIND == COSINE) {
            acc[0][i][jj] = fmaf(a[i], b[jj], acc[0][i][jj]);
          } else if constexpr (KIND == JACCARD) {
            acc[0][i][jj] = fmaf(ma[i], mb[jj], acc[0][i][jj]);
          } else {
            acc[0][i][jj] = fmaf(ma[i], mb[jj], acc[0][i][jj]);
            acc[1][i][jj] = fmaf(a[i], b[jj], acc[1][i][jj]);
            acc[2][i][jj] = fmaf(a[i], mb[jj], acc[2][i][jj]);
            acc[3][i][jj] = fmaf(ma[i], b[jj], acc[3][i][jj]);
            acc[4][i][jj] = fmaf(a[i] * a[i], mb[jj], acc[4][i][jj]);
            acc[5][i][jj] = fmaf(ma[i], b[jj] * b[jj], acc[5][i][jj]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (tid < BM) {
    stat[0][tid] = row_cnt;
    stat[1][tid] = row_sq;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int lr = ty * TM + i;
    const int gr = row0 + lr;
    if (gr >= g) continue;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int gc = col0 + tx * TN + jj;
      if (gc >= kc) continue;
      float v;
      if constexpr (KIND == COSINE) {
        const float den = __fmul_rn(__fsqrt_rn(stat[1][lr]), cnorm[gc]);
        v = __fdiv_rn(acc[0][i][jj], fmaxf(den, EPS));
      } else if constexpr (KIND == JACCARD) {
        const float n = acc[0][i][jj];
        const float uni = __fsub_rn(__fadd_rn(stat[0][lr], ccount[gc]), n);
        v = __fdiv_rn(n, fmaxf(uni, EPS));
      } else {
        const float n = acc[0][i][jj], dot = acc[1][i][jj];
        const float sa = acc[2][i][jj], sb = acc[3][i][jj];
        const float qa = acc[4][i][jj], qb = acc[5][i][jj];
        const float cov = __fsub_rn(__fmul_rn(n, dot), __fmul_rn(sa, sb));
        const float va = __fsub_rn(__fmul_rn(n, qa), __fmul_rn(sa, sa));
        const float vb = __fsub_rn(__fmul_rn(n, qb), __fmul_rn(sb, sb));
        const float den =
            __fsqrt_rn(__fmul_rn(fmaxf(va, 0.f), fmaxf(vb, 0.f)));
        const bool valid = (n >= 2.f) && (den > EPS);
        float p = __fdiv_rn(cov, fmaxf(den, EPS));
        p = fminf(fmaxf(p, -1.f), 1.f);
        v = valid ? __fmul_rn(__fadd_rn(p, 1.f), 0.5f) : 0.f;
        if (pcc_sig) v = __fmul_rn(v, __fdiv_rn(fminf(n, beta), beta));
      }
      out[static_cast<size_t>(gr) * kc + gc] = v;
    }
  }
}

template <typename TC>
void launch(const float* qv, const void* cr, const float* cn,
            const float* cc, float* out, int g, int kc, int j, int measure,
            float beta, cudaStream_t s) {
  const dim3 grid((kc + BN - 1) / BN, (g + BM - 1) / BM);
  const TC* c = static_cast<const TC*>(cr);
  if (measure == COSINE) {
    rerank_kernel<TC, COSINE><<<grid, NT, 0, s>>>(qv, c, cn, cc, out, g, kc,
                                                  j, 0, beta);
  } else if (measure == JACCARD) {
    rerank_kernel<TC, JACCARD><<<grid, NT, 0, s>>>(qv, c, cn, cc, out, g,
                                                   kc, j, 0, beta);
  } else {
    rerank_kernel<TC, PCC><<<grid, NT, 0, s>>>(
        qv, c, cn, cc, out, g, kc, j, measure == PCC_SIG ? 1 : 0, beta);
  }
}

}  // namespace

// cand_dtype: 0 = float32, 1 = int8; measure: 0 jaccard, 1 cosine, 2 pcc,
// 3 pcc_sig.  Returns cudaGetLastError() after the launch (0 = launched);
// the caller raises on anything else.
extern "C" int repro_rerank_scores(const void* q_vals, const void* cand_rows,
                                   const void* cand_norms,
                                   const void* cand_counts, void* out, int g,
                                   int kc, int j, int cand_dtype,
                                   int measure, float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qv = static_cast<const float*>(q_vals);
  const float* cn = static_cast<const float*>(cand_norms);
  const float* cc = static_cast<const float*>(cand_counts);
  float* o = static_cast<float*>(out);
  if (measure < JACCARD || measure > PCC_SIG) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cand_dtype == 0) {
    launch<float>(qv, cand_rows, cn, cc, o, g, kc, j, measure, beta, s);
  } else if (cand_dtype == 1) {
    launch<int8_t>(qv, cand_rows, cn, cc, o, g, kc, j, measure, beta, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
