// Fused co-rated Gram rerank for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/rerank.py
// (fused_rerank_scores, body _rerank_kernel): the exact rerank of the
// clustered index scores a block of G query rows against the union of
// their shortlisted candidates, Kc rows gathered once, with the
// candidates' full-row norms and rated counts passed in:
//   cosine : dot / max(‖q‖·norm_c, ε)                  (one product)
//   jaccard: n / max((count_q + count_c) − n, ε)       (one product)
//   pcc    : the six co-rated products, mapped to [0, 1]; pcc_sig scales
//            by min(n, β)/β
// with n = Σ 1[q>0]·1[c>0], dot = Σ q·c, sum_a = Σ q·1[c>0],
// sum_b = Σ 1[q>0]·c, sq_a = Σ q²·1[c>0], sq_b = Σ 1[q>0]·c².  Every
// product carries a query-side factor, so full-width candidate rows give
// exactly the co-rated sums.
//
// Two routes, chosen by the caller from the operands' dtypes:
//
// "imma" (query and candidate rows both int8; imma_kernel).  The Gram
// sums are integer sums, so the int8 tensor cores compute them exactly
// with int32 accumulators (mma.sync m16n8k32, s8/u8 → s32).  A block owns
// a BM × BN output tile, each warp a (TM·16) × (TN·8) sub-tile: pcc, with
// six accumulator sets, 16 warps on 128 × 64 (one block an SM, 128
// registers a thread); cosine and jaccard 8 warps on 128 × 128 (two
// blocks an SM).  The item axis streams through a 3-stage cp.async ring
// of 64-byte K slices of both operands (16-byte copies, zero-filled past
// G, Kc and J: a zero adds nothing to any sum).  Operand planes: the values come straight
// from ldmatrix; the masks 1[v>0] are made in registers from them
// (__vcmpgts4, 2 instructions a word); the squares, for pcc, are written
// once a stage into shared memory by all threads, split v² = 256·hi + lo
// with lo, hi u8 (v² ≤ 16384, so hi ≤ 64): the lo products always run;
// the hi products run only for a stage whose tiles hold some |v| > 15
// (a block-uniform flag, __syncthreads_or), each into a zeroed
// accumulator that is shifted by 8 and added.  One pcc output tile is
// n, dot, sum_a, sum_b, sq_a, sq_b from the fragments (Ma, A, A²) ×
// (Mb, B, B²), each fragment loaded or built once and shared by the
// products it appears in.  The query rows' squared norm (cosine, __dp4a)
// and rated count (jaccard) are folded from the staged tiles as
// integers.  The int32 sums are converted to f32 — exact while they stay
// at or below 2^24 — and the epilogue below is the plain version's.
//
// Domain of the "imma" route: every Gram sum must be at most 2^24, where
// the plain f32 version is exact too; the caller decides on the host,
// from J and a bound on |value| it already knows (max_value in the
// Python wrapper), and raises outside it (max_value² · J > 2^24).  J must
// be a multiple of 16 and the rows 16-byte aligned (the wrapper pads).
//
// "simt" (f32 query rows; f32 or int8 candidates; simt_kernel).  The
// tiling of similarity.cu: 64×64 output tiles, 32-item shared-memory
// tiles, a 4×4 register sub-tile per thread, f32 FMAs on the CUDA cores;
// int8 candidates are widened in registers.  Non-integer ratings keep it.
//
// Exactness.  On integer ratings every Gram sum is an integer at most
// 2^24 (25·3952 for MovieLens), exact in any order and on either route,
// and the epilogue keeps the reference's operation order with explicitly
// rounded intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn): both routes, the plain torch.matmul version and the
// reference's oracle agree bit for bit.
//
// Bound.  2·G·Kc·J operations per product (1 for cosine and jaccard, 6
// for pcc).  One 2048-query block at 6040 users, pcc, over the 6040 real
// union columns, J = 3952: 6·2·2048·6040·3952 ≈ 5.87e11 operations,
// ~0.30 ms at the int8 tensor-core peak (1,979 TOP/s), ~8.8 ms at the
// f32 peak (67 TFLOP/s) for the "simt" route; the bytes (2048·3952 +
// 6040·3952 + 2048·6040·4 ≈ 81.5 MB, ~0.024 ms) do not bind.  Bound by
// operations.  mma.sync issues from registers that ldmatrix fills, so
// the "imma" route also spends issue slots on the fragment loads and the
// square planes; wgmma with TMA (operands straight from shared memory)
// is the next design.

#include <cuda_runtime.h>
#include <stdint.h>

#include "imma.cuh"

namespace {

constexpr float EPS = 1e-8f;

enum Measure { JACCARD = 0, COSINE = 1, PCC = 2, PCC_SIG = 3 };

// The plain version's epilogue for one output.  s: the Gram sums as f32
// (s[0] = dot for cosine, n for jaccard; n, dot, sum_a, sum_b, sq_a, sq_b
// for pcc); q_cnt / q_sq: the query row's rated count and squared norm.
template <int KIND>
__device__ __forceinline__ float finish(const float* s, float q_cnt,
                                        float q_sq, float cnorm,
                                        float ccount, int pcc_sig,
                                        float beta) {
  if constexpr (KIND == COSINE) {
    const float den = __fmul_rn(__fsqrt_rn(q_sq), cnorm);
    return __fdiv_rn(s[0], fmaxf(den, EPS));
  } else if constexpr (KIND == JACCARD) {
    const float n = s[0];
    const float uni = __fsub_rn(__fadd_rn(q_cnt, ccount), n);
    return __fdiv_rn(n, fmaxf(uni, EPS));
  } else {
    const float n = s[0], dot = s[1], sa = s[2], sb = s[3];
    const float qa = s[4], qb = s[5];
    const float cov = __fsub_rn(__fmul_rn(n, dot), __fmul_rn(sa, sb));
    const float va = __fsub_rn(__fmul_rn(n, qa), __fmul_rn(sa, sa));
    const float vb = __fsub_rn(__fmul_rn(n, qb), __fmul_rn(sb, sb));
    const float den = __fsqrt_rn(__fmul_rn(fmaxf(va, 0.f), fmaxf(vb, 0.f)));
    const bool valid = (n >= 2.f) && (den > EPS);
    float p = __fdiv_rn(cov, fmaxf(den, EPS));
    p = fminf(fmaxf(p, -1.f), 1.f);
    float v = valid ? __fmul_rn(__fadd_rn(p, 1.f), 0.5f) : 0.f;
    if (pcc_sig) v = __fmul_rn(v, __fdiv_rn(fminf(n, beta), beta));
    return v;
  }
}

// ---- "simt" route: f32 FMAs on the CUDA cores -----------------------------

namespace simt {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // candidate rows per block
constexpr int BK = 32;        // items per shared-memory tile
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int NT = 256;       // 16 × 16 threads
constexpr int PAD = 4;

template <typename T>
__device__ __forceinline__ float widen(const T* p) {
  return static_cast<float>(*p);
}

template <typename TC, int KIND>   // KIND: JACCARD, COSINE or PCC
__global__ void __launch_bounds__(NT)
simt_kernel(const float* __restrict__ qv, const TC* __restrict__ cr,
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
      float s[NACC];
#pragma unroll
      for (int a = 0; a < NACC; ++a) s[a] = acc[a][i][jj];
      out[static_cast<size_t>(gr) * kc + gc] =
          finish<KIND>(s, stat[0][lr], stat[1][lr], cnorm[gc], ccount[gc],
                       pcc_sig, beta);
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
    simt_kernel<TC, COSINE><<<grid, NT, 0, s>>>(qv, c, cn, cc, out, g, kc,
                                                j, 0, beta);
  } else if (measure == JACCARD) {
    simt_kernel<TC, JACCARD><<<grid, NT, 0, s>>>(qv, c, cn, cc, out, g, kc,
                                                 j, 0, beta);
  } else {
    simt_kernel<TC, PCC><<<grid, NT, 0, s>>>(
        qv, c, cn, cc, out, g, kc, j, measure == PCC_SIG ? 1 : 0, beta);
  }
}

}  // namespace simt

// ---- "imma" route: int8 tensor cores ------------------------------------

namespace imma {

using namespace repro_imma;

constexpr int BK = 64;        // items (bytes) per stage
constexpr int LDS = BK + 16;  // shared row stride: ldmatrix conflict-free
constexpr int STAGES = 3;

// Warp grid WM × WN, warp tile (TM·16) × (TN·8).  pcc holds six
// accumulator sets, so its warp tile is smaller and it takes 16 warps
// (one block an SM); cosine and jaccard take 8 (two blocks an SM).
template <int KIND>
struct Shape {
  static constexpr bool SIX = KIND == PCC;
  static constexpr int WM = SIX ? 4 : 2, WN = 4;
  static constexpr int TM = SIX ? 2 : 4, TN = SIX ? 2 : 4;
  static constexpr int NT = WM * WN * 32;
  static constexpr int MIN_BLOCKS = SIX ? 1 : 2;
  static constexpr int NACC = SIX ? 6 : 1;
  static constexpr int BM = WM * TM * 16;
  static constexpr int BN = WN * TN * 8;
  // a ring stage holds BM + BN rows; pcc adds lo / hi square planes of
  // as many rows
  static constexpr int PLANE = (BM + BN) * LDS;
  static constexpr int SQ_BYTES = SIX ? 2 * PLANE : 0;
  static constexpr int SMEM = STAGES * PLANE + SQ_BYTES + 2 * BM * 4;
};

template <int KIND>
__global__ void __launch_bounds__(Shape<KIND>::NT, Shape<KIND>::MIN_BLOCKS)
imma_kernel(const int8_t* __restrict__ qv, const int8_t* __restrict__ cr,
            const float* __restrict__ cnorm,
            const float* __restrict__ ccount, float* __restrict__ out,
            int g, int kc, int j, int pcc_sig, float beta) {
  using S = Shape<KIND>;
  constexpr int TM = S::TM, TN = S::TN, BM = S::BM, BN = S::BN, NT = S::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                          // STAGES × PLANE
  unsigned char* sq = smem + STAGES * S::PLANE;        // lo | hi planes
  float* stat = reinterpret_cast<float*>(sq + S::SQ_BYTES);   // cnt | sq

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / S::WN, wn = warp % S::WN;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = j / BK + (j % BK != 0);

  // one stage: BM query rows then BN candidate rows, 4 16-byte chunks each
  auto load = [&](int kt) {
    unsigned char* dst = ring + (kt % STAGES) * S::PLANE;
    for (int c = tid; c < (BM + BN) * 4; c += NT) {
      const int r = c >> 2, ch = c & 3;
      const int gk = kt * BK + ch * 16;
      const bool is_q = r < BM;
      const int gr = is_q ? row0 + r : col0 + r - BM;
      const bool ok = gk < j && gr < (is_q ? g : kc);
      const int8_t* base = is_q ? qv : cr;
      const int8_t* src = ok ? base + static_cast<size_t>(gr) * j + gk : base;
      cp_async16(dst + r * LDS + ch * 16, src, ok ? 16 : 0);
    }
  };

  int acc[S::NACC][TM][TN][4];
#pragma unroll
  for (int a = 0; a < S::NACC; ++a)
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][m][n][e] = 0;
  int row_stat = 0;   // this thread's share of its query row's statistic

  const int a_off = a_lane_offset<LDS>(wm * TM * 16, lane);
  const int b_off = b_lane_offset<LDS>(BM + wn * TN * 8, lane);
  unsigned char* sq_lo = sq;
  unsigned char* sq_hi = sq + S::PLANE;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = ring + (kt % STAGES) * S::PLANE;

    bool wide = false;   // pcc: some |v| > 15 in this stage
    if constexpr (KIND == PCC) {
      for (int w = tid; w < (BM + BN) * (BK / 4); w += NT) {
        const int off = (w / (BK / 4)) * LDS + (w % (BK / 4)) * 4;
        unsigned lo, hi;
        wide |= square4(*reinterpret_cast<const unsigned*>(st + off), lo,
                        hi);
        *reinterpret_cast<unsigned*>(sq_lo + off) = lo;
        *reinterpret_cast<unsigned*>(sq_hi + off) = hi;
      }
      wide = __syncthreads_or(wide);
    } else {
      // query statistic: NT / BM threads a row, BK / 4 / (NT / BM) words
      constexpr int TPR = NT / BM, WPT = BK / 4 / TPR;
      const unsigned* row = reinterpret_cast<const unsigned*>(
          st + (tid / TPR) * LDS + (tid % TPR) * WPT * 4);
#pragma unroll
      for (int w = 0; w < WPT; ++w) {
        const unsigned x = row[w];
        if constexpr (KIND == COSINE) {
          row_stat = __dp4a(static_cast<int>(x), static_cast<int>(x),
                            row_stat);
        } else {
          row_stat += __popc(mask4(x));
        }
      }
    }

#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      unsigned av[TM][4], bv[TN][2];
      load_a<TM, LDS>(av, st + a_off + ks * 32);
      load_b<TN, LDS>(bv, st + b_off + ks * 32);
      if constexpr (KIND == COSINE) {
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n)
            mma_ss(acc[0][m][n], av[m], bv[n][0], bv[n][1]);
      } else {
        unsigned am[TM][4], bm[TN][2];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) am[m][e] = mask4(av[m][e]);
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          bm[n][0] = mask4(bv[n][0]);
          bm[n][1] = mask4(bv[n][1]);
        }
        if constexpr (KIND == JACCARD) {
#pragma unroll
          for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int n = 0; n < TN; ++n)
              mma_ss(acc[0][m][n], am[m], bm[n][0], bm[n][1]);
        } else {
#pragma unroll
          for (int m = 0; m < TM; ++m) {
#pragma unroll
            for (int n = 0; n < TN; ++n) {
              mma_ss(acc[0][m][n], am[m], bm[n][0], bm[n][1]);
              mma_ss(acc[1][m][n], av[m], bv[n][0], bv[n][1]);
              mma_ss(acc[2][m][n], av[m], bm[n][0], bm[n][1]);
              mma_ss(acc[3][m][n], am[m], bv[n][0], bv[n][1]);
            }
          }
          // the squares' lo planes once the values are dead
          unsigned aq[TM][4], bq[TN][2];
          load_a<TM, LDS>(aq, sq_lo + a_off + ks * 32);
#pragma unroll
          for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int n = 0; n < TN; ++n)
              mma_us(acc[4][m][n], aq[m], bm[n][0], bm[n][1]);
          load_b<TN, LDS>(bq, sq_lo + b_off + ks * 32);
#pragma unroll
          for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int n = 0; n < TN; ++n)
              mma_su(acc[5][m][n], am[m], bq[n][0], bq[n][1]);
          if (wide) {   // block-uniform: the hi halves of the squares
            load_a<TM, LDS>(aq, sq_hi + a_off + ks * 32);
            load_b<TN, LDS>(bq, sq_hi + b_off + ks * 32);
#pragma unroll
            for (int m = 0; m < TM; ++m) {
#pragma unroll
              for (int n = 0; n < TN; ++n) {
                int ta[4] = {0, 0, 0, 0}, tb[4] = {0, 0, 0, 0};
                mma_us(ta, aq[m], bm[n][0], bm[n][1]);
                mma_su(tb, am[m], bq[n][0], bq[n][1]);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  acc[4][m][n][e] += ta[e] << 8;
                  acc[5][m][n][e] += tb[e] << 8;
                }
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (KIND != PCC) {
    constexpr int TPR = NT / BM;
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      row_stat += __shfl_xor_sync(0xffffffffu, row_stat, off);
    if (tid % TPR == 0) stat[(KIND == COSINE ? BM : 0) + tid / TPR] =
        __int2float_rn(row_stat);
    __syncthreads();
  }

  // C fragment: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = wm * TM * 16 + m * 16 + gq + half * 8;
      const int gr = row0 + lr;
      if (gr >= g) continue;
      float q_cnt = 0.f, q_sq = 0.f;
      if constexpr (KIND == JACCARD) q_cnt = stat[lr];
      if constexpr (KIND == COSINE) q_sq = stat[BM + lr];
#pragma unroll
      for (int n = 0; n < TN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gc = col0 + wn * TN * 8 + n * 8 + tq * 2 + e;
          if (gc >= kc) continue;
          float s[S::NACC];
#pragma unroll
          for (int a = 0; a < S::NACC; ++a)
            s[a] = __int2float_rn(acc[a][m][n][half * 2 + e]);
          out[static_cast<size_t>(gr) * kc + gc] = finish<KIND>(
              s, q_cnt, q_sq, cnorm[gc], ccount[gc], pcc_sig, beta);
        }
      }
    }
  }
}

template <int KIND>
int launch_kind(const int8_t* qv, const int8_t* cr, const float* cn,
                const float* cc, float* out, int g, int kc, int j,
                int pcc_sig, float beta, cudaStream_t s) {
  using S = Shape<KIND>;
  const cudaError_t err = cudaFuncSetAttribute(
      imma_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((kc + S::BN - 1) / S::BN, (g + S::BM - 1) / S::BM);
  imma_kernel<KIND><<<grid, S::NT, S::SMEM, s>>>(qv, cr, cn, cc, out, g, kc, j,
                                              pcc_sig, beta);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* c, const float* cn, const float* cc,
           float* out, int g, int kc, int j, int measure, float beta,
           cudaStream_t s) {
  const int8_t* qv = static_cast<const int8_t*>(q);
  const int8_t* cr = static_cast<const int8_t*>(c);
  if (j % 16 != 0 || reinterpret_cast<uintptr_t>(qv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cr) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (measure == COSINE)
    return launch_kind<COSINE>(qv, cr, cn, cc, out, g, kc, j, 0, beta, s);
  if (measure == JACCARD)
    return launch_kind<JACCARD>(qv, cr, cn, cc, out, g, kc, j, 0, beta, s);
  return launch_kind<PCC>(qv, cr, cn, cc, out, g, kc, j,
                          measure == PCC_SIG ? 1 : 0, beta, s);
}

}  // namespace imma

}  // namespace

// q_dtype / cand_dtype: 0 = float32, 1 = int8.  Routes: int8 × int8 →
// "imma" (J a multiple of 16, 16-byte aligned rows); f32 × f32 or
// f32 × int8 → "simt"; anything else cudaErrorInvalidValue.  measure:
// 0 jaccard, 1 cosine, 2 pcc, 3 pcc_sig.  Returns cudaGetLastError()
// after the launch (0 = launched); the caller raises on anything else.
extern "C" int repro_rerank_scores(const void* q_vals, const void* cand_rows,
                                   const void* cand_norms,
                                   const void* cand_counts, void* out, int g,
                                   int kc, int j, int q_dtype,
                                   int cand_dtype, int measure, float beta,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cn = static_cast<const float*>(cand_norms);
  const float* cc = static_cast<const float*>(cand_counts);
  float* o = static_cast<float*>(out);
  if (measure < JACCARD || measure > PCC_SIG) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q_dtype == 1 && cand_dtype == 1) {
    return imma::launch(q_vals, cand_rows, cn, cc, o, g, kc, j, measure,
                        beta, s);
  }
  if (q_dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* qv = static_cast<const float*>(q_vals);
  if (cand_dtype == 0) {
    simt::launch<float>(qv, cand_rows, cn, cc, o, g, kc, j, measure, beta,
                        s);
  } else if (cand_dtype == 1) {
    simt::launch<int8_t>(qv, cand_rows, cn, cc, o, g, kc, j, measure, beta,
                         s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
