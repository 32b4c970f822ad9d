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
// Two routes, chosen by the caller from the operands' dtypes:
//
// "imma" (both blocks int8; imma_kernel).  The Gram sums are integer
// sums, so the int8 tensor cores compute them exactly with int32
// accumulators (mma.sync m16n8k32, s8/u8 → s32; the helpers of
// imma.cuh, shared with rerank.cu).  One call runs two kernels:
//   row_prep, one warp per row of either block: the row's rated count
//     and squared norm as exact integers (__popc of the masks, __dp4a),
//     and, for the six-product measures, the row's squares as u8 planes
//     beside the operand — v² in one plane when max_value ≤ 15, else
//     split v² = 256·hi + lo into two (v² ≤ 16384, so hi ≤ 64).  The
//     squares are thus made once per operand row, not once per block
//     stage (the rerank's per-stage transform, a third of its time);
//   imma_kernel<KIND, WIDE>, one block per BM × BN output tile, each warp
//     a (TM·16) × (TN·8) sub-tile; the item axis streams through a
//     3-stage cp.async ring of 128-byte (pcc with one square plane) or
//     64-byte K slices of every plane (16-byte copies, zero-filled past
//     m, n and D: a zero adds nothing to any sum).  The masks 1[v > 0]
//     are made in registers from the value fragments (__vcmpgts4).
//     KIND: jaccard (n from the masks) and cosine (dot from the values),
//     one product each, 8 warps on 128 × 128 (two blocks an SM); the
//     six-product kind (pcc, pcc_sig, "all") 16 warps on 128 × 64 (one
//     block an SM): n, dot, sum_a,
//     sum_b, sq_a, sq_b from (Ma, A, A²) × (Mb, B, B²), with the hi
//     square products only in the WIDE instantiation (max_value > 15,
//     decided on the host, uniform for the launch).
// The int32 sums are converted to f32 — exact while they stay at or
// below 2^24 — and the epilogue below is the f32 route's.
//
// Domain of the "imma" route: every Gram sum at most 2^24, where the plain
// f32 version is exact too; the caller decides on the host from D and a
// bound on |value| (max_value in the Python wrapper) and raises outside
// it (max_value² · D > 2^24).  row_prep counts the rows that break that
// bound, so a max_value below the data raises too (after the launch)
// instead of dropping hi squares or leaving the domain.  D must be a
// multiple of 16 and the rows 16-byte aligned (the wrapper pads with
// zero items).
//
// "simt" (both blocks f32; similarity_kernel).  One thread block owns a
// 64×64 output tile and loops over the item axis D through 32-wide
// shared-memory tiles (this loop takes the place of the TPU grid's
// sequential "arbitrary" K axis).  Each of the 256 threads keeps a 4×4
// sub-tile of all six accumulators in registers (96 floats); the first
// 128 threads also fold the tile's rows into the four row statistics.
// Ragged edges of m, n and D are masked at load time.  All arithmetic is
// f32 on the CUDA cores; non-integer ratings keep this route.
//
// Exactness.  For integer ratings every Gram sum is an integer at most
// 2^24 (25·3952 for MovieLens), so the sums are exact in any order, on
// either route, and equal the plain torch.matmul version bit for bit.
// The epilogue follows the reference's operation order with explicitly
// rounded intrinsics (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn /
// __fsqrt_rn), so no multiply-add is contracted and division and sqrt
// are IEEE — the kernel then agrees with the plain version bit for bit.
//
// Bound.  6 products × 2 ops × m·n·D (one product for jaccard and
// cosine).  At the fit's launch shape (6040 × 1024 candidates × 3952
// items, pcc) that is 2.9e11 operations against 0.14 GB of unique bytes:
// bound by operations — ~0.15 ms at the int8 tensor-core peak (1,979
// TOP/s) on the "imma" route, ~4.4 ms at the f32 peak (67 TFLOP/s) on
// the "simt" route.  mma.sync issues from registers that ldmatrix fills,
// so the "imma" route also spends issue slots on fragment loads and the
// in-register masks; wgmma with TMA (operands straight from shared
// memory) is the next design.

#include <cuda_runtime.h>
#include <stdint.h>

#include "imma.cuh"

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


// ---- "imma" route: int8 tensor cores ------------------------------------

namespace imma {

using namespace repro_imma;

constexpr int STAGES = 3;
constexpr int PREP_NT = 256;  // row_prep: 8 rows (warps) a block

enum Kind { K_JACCARD = 0, K_COSINE = 1, K_SIX = 2 };

// Warp grid WM × WN, warp tile (TM·16) × (TN·8).  The six-product kind
// holds six accumulator sets, so its warp tile is smaller and it takes 16
// warps (one block an SM); jaccard and cosine take 8 (two blocks an SM).
// A ring stage holds a BK-byte K slice of BM + BN rows of each plane: the
// values, and for the six-product kind the squares' lo plane (and the hi
// plane when WIDE).  BK is 128 for the six-product kind with one square
// plane (4 % faster than 64 at the fit's shape, tools/exact_variants.py);
// the WIDE ring would not fit in shared memory at 128.
template <int KIND>
struct Tiles {
  static constexpr bool SIX = KIND == K_SIX;
  static constexpr int WM = SIX ? 4 : 2, WN = 4;
  static constexpr int TM = SIX ? 2 : 4, TN = SIX ? 2 : 4;
  static constexpr int NT = WM * WN * 32;
  static constexpr int MIN_BLOCKS = SIX ? 1 : 2;
  static constexpr int NACC = SIX ? 6 : 1;
  static constexpr int BM = WM * TM * 16;
  static constexpr int BN = WN * TN * 8;
};

template <int KIND, bool WIDE>
struct Shape : Tiles<KIND> {
  static constexpr int PLANES = Tiles<KIND>::SIX ? (WIDE ? 3 : 2) : 1;
  static constexpr int BK = PLANES == 2 ? 128 : 64;   // bytes a stage
  static constexpr int LDS = BK + 16;   // row stride: ldmatrix conflict-free
  static constexpr int PLANE = (Tiles<KIND>::BM + Tiles<KIND>::BN) * LDS;
  static constexpr int SMEM = STAGES * PLANES * PLANE;
};

// One warp per row of x (rows × d int8, d a multiple of 16): the row's
// rated count and squared norm as exact integers, converted to f32 into
// stats[row] and stats[rows + row]; with planes ≥ 1 the row's squares'
// lo bytes into sq[row], with planes = 2 their hi bytes into
// sq[rows + row] (u8 planes of the operand's shape).  With bound < 128
// a row holding some |v| > bound adds one to *n_bad: the caller's
// max_value is checked here, so a wrong one raises instead of giving
// wrong sums.
__global__ void __launch_bounds__(PREP_NT)
row_prep(const int8_t* __restrict__ x, int rows, int d, int planes,
         int bound, unsigned char* __restrict__ sq,
         float* __restrict__ stats, int* __restrict__ n_bad) {
  const int row = (blockIdx.x * PREP_NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * d;
  const size_t plane = static_cast<size_t>(rows) * d;
  // bound and −bound in every byte (signed compares; bound ≤ 127 here)
  const unsigned hi_lim = (bound < 128 ? bound : 127) * 0x01010101u;
  const unsigned lo_lim = (bound < 128 ? (-bound) & 255 : 128) * 0x01010101u;
  int cnt = 0, ssq = 0;
  unsigned over = 0u;
  for (int off = lane * 16; off < d; off += 32 * 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + base + off);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    unsigned lo[4], hi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cnt += __popc(mask4(w[e]));
      ssq = __dp4a(static_cast<int>(w[e]), static_cast<int>(w[e]), ssq);
      square4(w[e], lo[e], hi[e]);
      over |= __vcmpgts4(w[e], hi_lim) | __vcmplts4(w[e], lo_lim);
    }
    if (planes >= 1)
      *reinterpret_cast<uint4*>(sq + base + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    if (planes == 2)
      *reinterpret_cast<uint4*>(sq + plane + base + off) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    ssq += __shfl_xor_sync(0xffffffffu, ssq, o);
  }
  const bool bad = __any_sync(0xffffffffu, over != 0u);
  if (lane == 0) {
    stats[row] = __int2float_rn(cnt);
    stats[rows + row] = __int2float_rn(ssq);
    if (bad) atomicAdd(n_bad, 1);
  }
}

// a, b: (m, d) / (n, d) int8; sq_a / sq_b: their square planes (lo, then
// hi when WIDE), unused by jaccard and cosine; st_a / st_b: (2, rows)
// rated counts then squared norms (row_prep's output).
template <int KIND, bool WIDE>
__global__ void __launch_bounds__(Tiles<KIND>::NT, Tiles<KIND>::MIN_BLOCKS)
imma_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
            const unsigned char* __restrict__ sq_a,
            const unsigned char* __restrict__ sq_b,
            const float* __restrict__ st_a, const float* __restrict__ st_b,
            float* __restrict__ out0, float* __restrict__ out1,
            float* __restrict__ out2, int m, int n, int d, int measure,
            float beta) {
  using S = Shape<KIND, WIDE>;
  constexpr int TM = S::TM, TN = S::TN, BM = S::BM, BN = S::BN, NT = S::NT;
  constexpr int BK = S::BK, LDS = S::LDS;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / S::WN, wn = warp % S::WN;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = d / BK + (d % BK != 0);
  const size_t plane_a = static_cast<size_t>(m) * d;
  const size_t plane_b = static_cast<size_t>(n) * d;

  // one stage: for each plane, BM rows of A then BN rows of B, BK / 16
  // 16-byte chunks a row
  constexpr int CH = BK / 16;
  auto load = [&](int kt) {
    unsigned char* dst = smem + (kt % STAGES) * S::PLANES * S::PLANE;
    for (int c = tid; c < S::PLANES * (BM + BN) * CH; c += NT) {
      const int p = c / ((BM + BN) * CH);
      const int r = (c / CH) % (BM + BN), ch = c % CH;
      const int gk = kt * BK + ch * 16;
      const bool is_a = r < BM;
      const int gr = is_a ? row0 + r : col0 + r - BM;
      const bool ok = gk < d && gr < (is_a ? m : n);
      const void* base;
      if (p == 0) {
        base = is_a ? static_cast<const void*>(a)
                    : static_cast<const void*>(b);
      } else {
        base = is_a ? static_cast<const void*>(sq_a + (p - 1) * plane_a)
                    : static_cast<const void*>(sq_b + (p - 1) * plane_b);
      }
      const unsigned char* src = static_cast<const unsigned char*>(base);
      if (ok) src += static_cast<size_t>(gr) * d + gk;
      cp_async16(dst + p * S::PLANE + r * LDS + ch * 16, src, ok ? 16 : 0);
    }
  };

  int acc[S::NACC][TM][TN][4];
#pragma unroll
  for (int q = 0; q < S::NACC; ++q)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][i][j][e] = 0;

  const int a_off = a_lane_offset<LDS>(wm * TM * 16, lane);
  const int b_off = b_lane_offset<LDS>(BM + wn * TN * 8, lane);

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
    const unsigned char* st = smem + (kt % STAGES) * S::PLANES * S::PLANE;

#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      unsigned av[TM][4], bv[TN][2];
      load_a<TM, LDS>(av, st + a_off + ks * 32);
      load_b<TN, LDS>(bv, st + b_off + ks * 32);
      if constexpr (KIND == K_COSINE) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            mma_ss(acc[0][i][j], av[i], bv[j][0], bv[j][1]);
      } else {
        unsigned am[TM][4], bm[TN][2];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) am[i][e] = mask4(av[i][e]);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          bm[j][0] = mask4(bv[j][0]);
          bm[j][1] = mask4(bv[j][1]);
        }
        if constexpr (KIND == K_JACCARD) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              mma_ss(acc[0][i][j], am[i], bm[j][0], bm[j][1]);
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              mma_ss(acc[0][i][j], am[i], bm[j][0], bm[j][1]);
              mma_ss(acc[1][i][j], av[i], bv[j][0], bv[j][1]);
              mma_ss(acc[2][i][j], av[i], bm[j][0], bm[j][1]);
              mma_ss(acc[3][i][j], am[i], bv[j][0], bv[j][1]);
            }
          }
          // the squares' lo planes once the values are dead
          const unsigned char* lo = st + S::PLANE;
          unsigned aq[TM][4], bq[TN][2];
          load_a<TM, LDS>(aq, lo + a_off + ks * 32);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              mma_us(acc[4][i][j], aq[i], bm[j][0], bm[j][1]);
          load_b<TN, LDS>(bq, lo + b_off + ks * 32);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              mma_su(acc[5][i][j], am[i], bq[j][0], bq[j][1]);
          if constexpr (WIDE) {   // the hi bytes, weighted 256
            const unsigned char* hi = st + 2 * S::PLANE;
            load_a<TM, LDS>(aq, hi + a_off + ks * 32);
            load_b<TN, LDS>(bq, hi + b_off + ks * 32);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
#pragma unroll
              for (int j = 0; j < TN; ++j) {
                int ta[4] = {0, 0, 0, 0}, tb[4] = {0, 0, 0, 0};
                mma_us(ta, aq[i], bm[j][0], bm[j][1]);
                mma_su(tb, am[i], bq[j][0], bq[j][1]);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  acc[4][i][j][e] += ta[e] << 8;
                  acc[5][i][j][e] += tb[e] << 8;
                }
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // C fragment: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gr = row0 + wm * TM * 16 + i * 16 + gq + half * 8;
      if (gr >= m) continue;
      const float ca = st_a[gr];
      const float na = __fsqrt_rn(st_a[m + gr]);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gc = col0 + wn * TN * 8 + j * 8 + tq * 2 + e;
          if (gc >= n) continue;
          const size_t o = static_cast<size_t>(gr) * n + gc;
          float s[S::NACC];
#pragma unroll
          for (int q = 0; q < S::NACC; ++q)
            s[q] = __int2float_rn(acc[q][i][j][half * 2 + e]);
          if constexpr (KIND == K_JACCARD) {
            out0[o] = jaccard(s[0], ca, st_b[gc]);
          } else if constexpr (KIND == K_COSINE) {
            out0[o] = cosine(s[0], na, __fsqrt_rn(st_b[n + gc]));
          } else {
            const float nn = s[0];
            if (measure == ALL) {
              out0[o] = jaccard(nn, ca, st_b[gc]);
              out1[o] = cosine(s[1], na, __fsqrt_rn(st_b[n + gc]));
            }
            float v = pcc01(nn, s[1], s[2], s[3], s[4], s[5]);
            if (measure == PCC_SIG) {
              v = __fmul_rn(v, __fdiv_rn(fminf(nn, beta), beta));
            }
            (measure == ALL ? out2 : out0)[o] = v;
          }
        }
      }
    }
  }
}

template <int KIND, bool WIDE>
int launch_kind(const int8_t* a, const int8_t* b, const unsigned char* sq_a,
                const unsigned char* sq_b, const float* st_a,
                const float* st_b, float* o0, float* o1, float* o2, int m,
                int n, int d, int measure, float beta, cudaStream_t s) {
  using S = Shape<KIND, WIDE>;
  const cudaError_t err = cudaFuncSetAttribute(
      imma_kernel<KIND, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + S::BN - 1) / S::BN, (m + S::BM - 1) / S::BM);
  imma_kernel<KIND, WIDE><<<grid, S::NT, S::SMEM, s>>>(
      a, b, sq_a, sq_b, st_a, st_b, o0, o1, o2, m, n, d, measure, beta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace imma

}  // namespace

// The "simt" route: ra, rb (m, d) / (n, d) f32.  measure: 0 jaccard,
// 1 cosine, 2 pcc, 3 pcc_sig, 4 all.  Returns cudaGetLastError() after the
// launch (0 = launched); the caller raises on anything else.
extern "C" int repro_similarity(const void* ra, const void* rb, void* out0,
                                void* out1, void* out2, int m, int n, int d,
                                int measure, float beta, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 block(NT);
  similarity_kernel<float><<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ra), static_cast<const float*>(rb),
      static_cast<float*>(out0), static_cast<float*>(out1),
      static_cast<float*>(out2), m, n, d, measure, beta);
  return static_cast<int>(cudaGetLastError());
}

// The "imma" route: ra, rb (m, d) / (n, d) int8, d a multiple of 16,
// 16-byte aligned rows.  sq_a / sq_b: scratch for the square planes,
// (1 + wide) planes of the operand's shape for pcc / pcc_sig / all,
// unused (may be null) for jaccard and cosine; st_a / st_b: (2, m) /
// (2, n) f32 scratch for the row statistics.  wide: some |value| may
// exceed 15 (squares need the hi plane).  bound: the caller's bound on
// |value| (128: none); rows of either block past it are counted into the
// int32 device counter n_bad, which the caller reads.  Returns the first
// non-zero cudaGetLastError() of the three launches (row_prep of each
// block, then the tile kernel); the caller raises on anything else.
extern "C" int repro_similarity_imma(const void* ra, const void* rb,
                                     void* sq_a, void* sq_b, void* st_a,
                                     void* st_b, void* out0, void* out1,
                                     void* out2, int m, int n, int d,
                                     int measure, int wide, int bound,
                                     void* n_bad, float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(ra);
  const int8_t* b = static_cast<const int8_t*>(rb);
  if (d % 16 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 || measure < JACCARD ||
      measure > ALL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool six = measure >= PCC;
  const int planes = six ? (wide ? 2 : 1) : 0;
  unsigned char* qa = static_cast<unsigned char*>(sq_a);
  unsigned char* qb = static_cast<unsigned char*>(sq_b);
  float* sa = static_cast<float*>(st_a);
  float* sb = static_cast<float*>(st_b);
  constexpr int RPB = imma::PREP_NT / 32;
  int* bad = static_cast<int*>(n_bad);
  imma::row_prep<<<(m + RPB - 1) / RPB, imma::PREP_NT, 0, s>>>(
      a, m, d, planes, bound, qa, sa, bad);
  imma::row_prep<<<(n + RPB - 1) / RPB, imma::PREP_NT, 0, s>>>(
      b, n, d, planes, bound, qb, sb, bad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  float* o2 = static_cast<float*>(out2);
  if (measure == JACCARD)
    return imma::launch_kind<imma::K_JACCARD, false>(
        a, b, qa, qb, sa, sb, o0, o1, o2, m, n, d, measure, beta, s);
  if (measure == COSINE)
    return imma::launch_kind<imma::K_COSINE, false>(
        a, b, qa, qb, sa, sb, o0, o1, o2, m, n, d, measure, beta, s);
  if (wide)
    return imma::launch_kind<imma::K_SIX, true>(
        a, b, qa, qb, sa, sb, o0, o1, o2, m, n, d, measure, beta, s);
  return imma::launch_kind<imma::K_SIX, false>(
      a, b, qa, qb, sa, sb, o0, o1, o2, m, n, d, measure, beta, s);
}
