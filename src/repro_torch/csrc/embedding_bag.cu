// Embedding bag (multi-hot gather + reduce) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/embedding_bag.py
// (embedding_bag, body _bag_kernel).  For bag b of a (B, L) id matrix
// over a (V, D) table:
//   acc   = Σ_{l = 0..L−1, ids[b,l] ≥ 0} f32(table[ids[b,l], :])   (in l order)
//   out_b = acc                              (sum)
//         = acc / max(count_b, 1)            (mean, IEEE division)
// cast to the table's dtype (f32 or bf16).  An id < 0 is padding.
//
// Design.  The TPU kernel walks a sequential (B, L) grid and DMAs one
// table row per step, with the (B, L) ids scalar-prefetched into SMEM so
// the BlockSpec index map can pick the row.  Here one warp owns one bag
// (4 bags per 128-thread block) and walks its L ids in order: each lane
// loads one of the next 32 ids (the warp loads its own ids, in place of
// the scalar prefetch) and __shfl_sync hands them out one by one, so the
// whole warp agrees on every branch.  The lanes cover D: 16 bytes a lane
// (4 f32 or 8 bf16) where D is a multiple of that and the table is
// 16-byte aligned, one element a lane otherwise; a wider D loops over
// column chunks of 32 lanes.  D = 1 and D = 10 (the FM / xDeepFM tables)
// leave most lanes idle: right, not fast.  Each lane accumulates its
// columns in f32 with __fadd_rn (no contraction) in l order, and the mean
// divides with __fdiv_rn: the order of the plain version
// repro_torch.kernels.embedding_bag.embedding_bag_plain, so the two agree
// bit for bit.  Row and element offsets are 64-bit: a fused table holds
// more than 2^31 elements.  An id ≥ V is never read: it is counted into
// *n_bad (once per (bag, slot)) and skipped; the wrapper reads the count
// after the launch and raises.
//
// Bound.  The function must read each distinct row it touches once, the
// ids once and write the (B, D) output once: at the multi-hot launch of
// 2048 bags × L = 100 over the 104 M × 128 f32 DLRM table that is about
// (distinct rows · 512 + 2048 · 100 · 4 + 2048 · 512) bytes ≈ 0.1 GB,
// ≈ 30 µs at 3.35 TB/s; it does one add per gathered element (2.6e7),
// far below any peak: bound by bytes.  This kernel reads a row once per
// occurrence (hot zipf rows hit in L2) and keeps only 4 loads of 16 bytes
// in flight per warp; several bags per warp for D < 32 and cp.async / TMA
// row prefetch across L are the next design, not this file's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;                 // bags per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements per lane per load: 16 / sizeof(T) on the vector path, else 1.
template <typename T, typename I, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
bag_kernel(const T* __restrict__ table, int64_t n_rows, int64_t dim,
           const I* __restrict__ ids, int64_t n_bags, int64_t bag_len,
           int mean, T* __restrict__ out, int* __restrict__ n_bad) {
  const int lane = threadIdx.x & 31;
  const int64_t bag =
      static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const I* bag_ids = ids + bag * bag_len;
  T* out_row = out + bag * dim;
  for (int64_t c0 = 0; c0 < dim; c0 += 32 * VEC) {
    const int64_t c = c0 + static_cast<int64_t>(lane) * VEC;
    const bool mine = c < dim;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    int count = 0;
    for (int64_t l0 = 0; l0 < bag_len; l0 += 32) {
      const int n = static_cast<int>(bag_len - l0 < 32 ? bag_len - l0 : 32);
      const long long my =
          lane < n ? static_cast<long long>(bag_ids[l0 + lane]) : -1;
      for (int j = 0; j < n; ++j) {
        const long long id = __shfl_sync(FULL, my, j);   // warp-uniform
        if (id < 0) continue;
        if (id >= n_rows) {
          if (lane == 0 && c0 == 0) atomicAdd(n_bad, 1);
          continue;
        }
        ++count;
        if (!mine) continue;
        const T* row = table + static_cast<int64_t>(id) * dim + c;
        if constexpr (VEC > 1) {
          const uint4 raw = *reinterpret_cast<const uint4*>(row);
          const T* val = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = __fadd_rn(acc[e], to_f32(val[e]));
        } else {
          acc[0] = __fadd_rn(acc[0], to_f32(row[0]));
        }
      }
    }
    if (!mine) continue;
    const float denom = static_cast<float>(count > 1 ? count : 1);
    if constexpr (VEC > 1) {
      alignas(16) T val[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        val[e] = from_f32<T>(mean ? __fdiv_rn(acc[e], denom) : acc[e]);
      *reinterpret_cast<uint4*>(out_row + c) =
          *reinterpret_cast<const uint4*>(val);
    } else {
      out_row[c] = from_f32<T>(mean ? __fdiv_rn(acc[0], denom) : acc[0]);
    }
  }
}

template <typename T, typename I>
int launch_typed(const void* table, long long n_rows, long long dim,
                 const void* ids, long long n_bags, long long bag_len,
                 int mean, void* out, int* n_bad, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = dim % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((n_bags + WARPS - 1) / WARPS));
  const dim3 block(WARPS * 32);
  const T* t = static_cast<const T*>(table);
  const I* i = static_cast<const I*>(ids);
  T* o = static_cast<T*>(out);
  if (vec) {
    bag_kernel<T, I, VEC><<<grid, block, 0, s>>>(t, n_rows, dim, i, n_bags,
                                                  bag_len, mean, o, n_bad);
  } else {
    bag_kernel<T, I, 1><<<grid, block, 0, s>>>(t, n_rows, dim, i, n_bags,
                                                bag_len, mean, o, n_bad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: (n_rows, dim) contiguous, dtype 0 = f32, 1 = bf16; ids: (n_bags,
// bag_len) contiguous, id_bits 32 or 64; out: (n_bags, dim) in the
// table's dtype; n_bad: one int, zeroed by the caller, counts ids ≥
// n_rows.  Returns cudaGetLastError() after the launch (0 = launched);
// 1000 for an unsupported dtype / id width (nothing launched).
extern "C" int repro_embedding_bag(const void* table, long long n_rows,
                                   long long dim, const void* ids,
                                   int id_bits, long long n_bags,
                                   long long bag_len, int mean, void* out,
                                   void* n_bad, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* bad = static_cast<int*>(n_bad);
  if (dtype == 0 && id_bits == 32)
    return launch_typed<float, int32_t>(table, n_rows, dim, ids, n_bags,
                                        bag_len, mean, out, bad, s);
  if (dtype == 0 && id_bits == 64)
    return launch_typed<float, int64_t>(table, n_rows, dim, ids, n_bags,
                                        bag_len, mean, out, bad, s);
  if (dtype == 1 && id_bits == 32)
    return launch_typed<__nv_bfloat16, int32_t>(table, n_rows, dim, ids,
                                                n_bags, bag_len, mean, out,
                                                bad, s);
  if (dtype == 1 && id_bits == 64)
    return launch_typed<__nv_bfloat16, int64_t>(table, n_rows, dim, ids,
                                                n_bags, bag_len, mean, out,
                                                bad, s);
  return 1000;
}
