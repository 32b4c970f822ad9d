// Fused pairwise user similarity for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/similarity.py
// (fused_similarity, body _sim_kernel): for a (query block, candidate
// block) pair of rating rows it accumulates the six masked Gram products
//   n_common = Σ ma·mb   dot = Σ a·b    sum_a = Σ a·mb
//   sum_b    = Σ ma·b    sq_a = Σ a²·mb sq_b  = Σ ma·b²      (m = r > 0)
// plus the per-row rated counts and squared norms of both sides, and
// writes the requested measure(s) in f32: jaccard, cosine, pcc (mapped
// to [0, 1]), pcc_sig (pcc01 · min(n, β)/β), or the (jaccard, cosine,
// pcc) triple for "all".
//
// Design.  One thread block owns a 64×64 output tile and loops over the
// item axis D through 32-wide shared-memory tiles (this loop takes the
// place of the TPU grid's sequential "arbitrary" K axis).  Each of the
// 256 threads keeps a 4×4 sub-tile of all six accumulators in registers
// (96 floats); the first 128 threads also fold the tile's rows into the
// four row statistics.  Ragged edges of m, n and D are masked at load
// time: an out-of-range element loads as 0, which adds nothing to any
// sum.  All arithmetic is f32 on the CUDA cores.
//
// Exactness.  For integer ratings 0..5 every Gram sum is an integer below
// 2^24 (25·3952 < 2^24), so the sums are exact in any order and equal the
// plain torch.matmul version bit for bit.  The epilogue follows the
// reference's operation order with explicitly rounded intrinsics
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn), so no
// multiply-add is contracted and division and sqrt are IEEE — the kernel
// then agrees with the plain version bit for bit.
//
// Bound.  6 products × 2 ops × m·n·D.  At the fit's launch shape
// (6040 × 1024 candidates × 3952 items) that is 2.9e11 f32 operations
// against 0.14 GB of unique bytes, far past the H100's ridge point: the
// kernel is bound by operations.  On the CUDA cores (67 TFLOP/s f32) the
// least time is ~4.4 ms per launch.
//
// Next design (not in this file): int8 (or bf16) wgmma with an int32
// (f32) accumulator.  The ratings, masks and squares (≤ 25) fit int8
// exactly and the integer sums stay exact, so the route keeps bit parity
// while moving the bound to the tensor cores (1979 int8 TOP/s, ~0.15 ms
// per launch), with TMA-fed shared-memory rings and the running top-k
// merge fused into the epilogue.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // candidate rows per block
constexpr int BK = 32;        // items per shared-memory tile
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int NT = 256;       // threads per block (16 × 16)
constexpr int PAD = 4;        // keeps float4 alignment, eases bank conflicts
constexpr float EPS = 1e-8f;

enum Measure { JACCARD = 0, COSINE = 1, PCC = 2, PCC_SIG = 3, ALL = 4 };

template <typename T>
__device__ __forceinline__ float load_rating(const T* p) {
  return static_cast<float>(*p);
}

__device__ __forceinline__ float jaccard(float n, float ca, float cb) {
  const float uni = __fsub_rn(__fadd_rn(ca, cb), n);
  return __fdiv_rn(n, fmaxf(uni, EPS));
}

__device__ __forceinline__ float cosine(float dot, float na, float nb) {
  const float den = __fmul_rn(na, nb);
  return __fdiv_rn(dot, fmaxf(den, EPS));
}

__device__ __forceinline__ float pcc01(float n, float dot, float sa,
                                       float sb, float qa, float qb) {
  const float cov = __fsub_rn(__fmul_rn(n, dot), __fmul_rn(sa, sb));
  const float va = __fsub_rn(__fmul_rn(n, qa), __fmul_rn(sa, sa));
  const float vb = __fsub_rn(__fmul_rn(n, qb), __fmul_rn(sb, sb));
  const float den = __fsqrt_rn(__fmul_rn(fmaxf(va, 0.f), fmaxf(vb, 0.f)));
  const bool valid = (n >= 2.f) && (den > EPS);
  float p = __fdiv_rn(cov, fmaxf(den, EPS));
  p = fminf(fmaxf(p, -1.f), 1.f);
  return valid ? __fmul_rn(__fadd_rn(p, 1.f), 0.5f) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(NT)
similarity_kernel(const T* __restrict__ ra, const T* __restrict__ rb,
                  float* __restrict__ out0, float* __restrict__ out1,
                  float* __restrict__ out2, int m, int n, int d,
                  int measure, float beta) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ float stat[4][BM];   // count_a, sq_a (full row), count_b, sq_b

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc_n[TM][TN], acc_dot[TM][TN], acc_sa[TM][TN], acc_sb[TM][TN],
      acc_qa[TM][TN], acc_qb[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_n[i][j] = 0.f; acc_dot[i][j] = 0.f; acc_sa[i][j] = 0.f;
      acc_sb[i][j] = 0.f; acc_qa[i][j] = 0.f; acc_qb[i][j] = 0.f;
    }
  }
  float row_cnt = 0.f;   // threads 0..63: query row tid; 64..127: cand row
  float row_sq = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // consecutive threads read consecutive items of one row (coalesced)
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < m && gc < d)
                     ? load_rating(ra + static_cast<size_t>(gr) * d + gc)
                     : 0.f;
    }
    for (int e = tid; e < BN * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int gr = col0 + r, gc = k0 + c;
      Bs[c][r] = (gr < n && gc < d)
                     ? load_rating(rb + static_cast<size_t>(gr) * d + gc)
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
    } else if (tid < BM + BN) {
#pragma unroll 8
      for (int c = 0; c < BK; ++c) {
        const float b = Bs[c][tid - BM];
        row_cnt += (b > 0.f) ? 1.f : 0.f;
        row_sq = __fadd_rn(row_sq, __fmul_rn(b, b));
      }
    }

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 av = *reinterpret_cast<const float4*>(&As[c][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[c][tx * TN]);
      const float a[TM] = {av.x, av.y, av.z, av.w};
      const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
      float ma[TM], a2[TM], mb[TN], b2[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ma[i] = (a[i] > 0.f) ? 1.f : 0.f;
        a2[i] = a[i] * a[i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        mb[j] = (b[j] > 0.f) ? 1.f : 0.f;
        b2[j] = b[j] * b[j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_n[i][j] = fmaf(ma[i], mb[j], acc_n[i][j]);
          acc_dot[i][j] = fmaf(a[i], b[j], acc_dot[i][j]);
          acc_sa[i][j] = fmaf(a[i], mb[j], acc_sa[i][j]);
          acc_sb[i][j] = fmaf(ma[i], b[j], acc_sb[i][j]);
          acc_qa[i][j] = fmaf(a2[i], mb[j], acc_qa[i][j]);
          acc_qb[i][j] = fmaf(ma[i], b2[j], acc_qb[i][j]);
        }
      }
    }
    __syncthreads();
  }

  if (tid < BM) {
    stat[0][tid] = row_cnt;
    stat[1][tid] = row_sq;
  } else if (tid < BM + BN) {
    stat[2][tid - BM] = row_cnt;
    stat[3][tid - BM] = row_sq;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int lr = ty * TM + i;
    const int gr = row0 + lr;
    if (gr >= m) continue;
    const float ca = stat[0][lr];
    const float na = __fsqrt_rn(stat[1][lr]);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int lc = tx * TN + j;
      const int gc = col0 + lc;
      if (gc >= n) continue;
      const size_t o = static_cast<size_t>(gr) * n + gc;
      const float nn = acc_n[i][j];
      if (measure == JACCARD || measure == ALL) {
        out0[o] = jaccard(nn, ca, stat[2][lc]);
      }
      if (measure == COSINE || measure == ALL) {
        const float v = cosine(acc_dot[i][j], na, __fsqrt_rn(stat[3][lc]));
        (measure == ALL ? out1 : out0)[o] = v;
      }
      if (measure == PCC || measure == PCC_SIG || measure == ALL) {
        float v = pcc01(nn, acc_dot[i][j], acc_sa[i][j], acc_sb[i][j],
                        acc_qa[i][j], acc_qb[i][j]);
        if (measure == PCC_SIG) {
          v = __fmul_rn(v, __fdiv_rn(fminf(nn, beta), beta));
        }
        (measure == ALL ? out2 : out0)[o] = v;
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = int8.  Returns cudaGetLastError() after the
// launch (0 = launched); the caller raises on anything else.
extern "C" int repro_similarity(const void* ra, const void* rb, void* out0,
                                void* out1, void* out2, int m, int n, int d,
                                int dtype, int measure, float beta,
                                void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 block(NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  float* o2 = static_cast<float*>(out2);
  if (dtype == 0) {
    similarity_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(ra), static_cast<const float*>(rb), o0, o1,
        o2, m, n, d, measure, beta);
  } else if (dtype == 1) {
    similarity_kernel<int8_t><<<grid, block, 0, s>>>(
        static_cast<const int8_t*>(ra), static_cast<const int8_t*>(rb), o0,
        o1, o2, m, n, d, measure, beta);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
