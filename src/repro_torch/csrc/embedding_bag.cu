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
// Bound.  The function must read each distinct row once, the ids once and
// write the (B, D) output once; its one add per gathered element is far
// below any peak, so it is bound by bytes: at 3.35 TB/s, 0.0061 ms for the
// multi-hot launch of 2048 bags × L = 100 over the 104 M × 128 f32 DLRM
// table (36k distinct rows), 0.0014 ms for its 6656 L = 1 lookups, 0.0007
// and 0.0003 ms for the same bags over FM's D = 10 and D = 1 tables.  But
// a bag's sum is a chain in l order that cannot be split over warps
// without changing the bits, and the previous design walked each chain
// one row at a time (one load in flight a warp): 0.036 ms at every one of
// the three multi-hot shapes, latency-bound, with 22 and 31 lanes of 32
// idle at D = 10 and D = 1.
//
// Design.  Two kernels; the launch plan (kernels/embedding_bag.py plan())
// picks one and the width `Word` a row is read in (16 bytes where the row
// and both pointers allow, else 8, 4 or 2).  One warp owns one bag in
// both; a block holds MAX_WARPS warps, fewer where B would leave SMs idle.
// * bag_kernel, rows of more than SLOT_WORDS words (DLRM's D = 128): lane
//   w owns word w of every column chunk of 32 words.  Each lane keeps a
//   ring of P slots in registers (P = DEPTH for long bags, 4 or 1 for
//   bags of at most 4 or 1 slots, so short bags keep few registers and
//   many warps): the rows of slots l..l+P−1 are loaded while slot l is
//   added, the ids a window ahead of their rows; slot j of the ring holds
//   slot ≡ j (mod P), so the unrolled loop indexes registers statically.
// * slot_kernel, rows of at most SLOT_WORDS words (FM's D = 10 and
//   D = 1): lane k loads the id and row of slot c0 + k of each chunk of
//   32, the rows are staged in shared memory and lane w adds word w of
//   the 32 rows in slot order.  The per-slot id, bounds and address work
//   is spread over the lanes, and 32 rows are in flight a warp; only the
//   adds are serial.
// * Both sum each column in f32 with __fadd_rn (no contraction) in l
//   order, and the mean divides with __fdiv_rn: the order of the plain
//   version repro_torch.kernels.embedding_bag.embedding_bag_plain, so the
//   two agree bit for bit.  A padded or out-of-range slot loads nothing
//   and adds +0, which leaves a sum that starts at +0 as it is.  Row and
//   element offsets are 64-bit: a fused table holds more than 2^31
//   elements.
// * Ids ≥ V.  check_kernel counts them before the bag launch, and the
//   wrapper's one call (repro_embedding_bag_checked) copies the count to
//   pinned host memory, enqueues the bag launch and waits for the count
//   alone, not for the bags: never slower, and up to 0.030 ms less host
//   wall a call, than a torch counter zeroed before the launch and read
//   after it (tools/kernel_times.py --only bag).  The bag kernels still never read such a row: they skip
//   it and add it to the same counter.
//
// What still holds it back (H100 80GB HBM3 at 700 W, tools/kernel_times.py
// --only bag).  The multi-hot DLRM launch reads every occurrence of a row,
// 94.4 MB from L1 and L2 (15× the bound's bytes): warm 0.0125 ms, 7.5 TB/s;
// cold adds the 18.6 MB of distinct rows from HBM (0.0220 ms).  A deeper
// ring (16, 32) or a ring of 1-D bulk copies into shared memory is no
// faster, and packing several bags into a warp was slower at FM's rows
// than the slot kernel.  The narrow bags are bound by their chain of 100
// adds (0.0067 and 0.0047 ms warm) and, cold, by the first touch of each
// distinct row.  ptxas: the path's kernels 32-64 registers (the DLRM
// launch's bag_kernel<float, int, uint4, 8> the most), all 27-96, no
// spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// DEPTH and SLOT_WORDS are read from here by kernels/embedding_bag.py's
// launch plan.
constexpr int DEPTH = 8;        // slots in flight a lane, long bags
constexpr int SLOT_WORDS = 8;   // the slot kernel's widest row, in words
constexpr int MAX_WARPS = 4;    // warps a block, at most
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
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

// acc[e] += element e of the word, in f32 with no contraction
template <typename T, typename Word>
__device__ __forceinline__ void add_word(float* acc, const Word& w) {
  constexpr int E = sizeof(Word) / sizeof(T);
  const T* v = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = __fadd_rn(acc[e], to_f32(v[e]));
}

// One warp owns one bag; lane w owns word w of every column chunk of 32
// words; P slots of the bag are in flight a lane.
template <typename T, typename I, typename Word, int P>
__global__ void __launch_bounds__(MAX_WARPS * 32)
bag_kernel(const T* __restrict__ table, long long n_rows, long long row_words,
           const I* __restrict__ ids, long long n_bags, long long bag_len,
           int mean, T* __restrict__ out, int* __restrict__ n_bad) {
  constexpr int E = sizeof(Word) / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long bag = static_cast<long long>(blockIdx.x) *
                            (blockDim.x >> 5) + (threadIdx.x >> 5);
  // no lane waits for another (no shuffle, no barrier): idle lanes leave
  if (bag >= n_bags || lane >= row_words) return;
  const I* bag_ids = ids + bag * bag_len;
  const int len = static_cast<int>(bag_len);
  const int stride = static_cast<int>(row_words);
  const unsigned long long limit = static_cast<unsigned long long>(n_rows);
  Word* out_row = reinterpret_cast<Word*>(out) + bag * row_words;
  for (int w = lane; w < stride; w += 32) {              // column chunks
    const Word* col = reinterpret_cast<const Word*>(table) + w;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    int count = 0;
    Word v[P];
    I next[P];            // ids of the slots one window ahead
    auto id_at = [&](int l) -> I {
      return l < len ? bag_ids[l] : static_cast<I>(-1);
    };
    // A padded or out-of-range slot loads nothing and adds +0: a sum that
    // starts at +0 is never −0, so x + 0 == x bit for bit and the sum
    // stays the plain version's, which skips the slot.
    auto issue = [&](int j, I id) {
      const long long i = static_cast<long long>(id);
      v[j] = Word{};
      if (static_cast<unsigned long long>(i) < limit) {
        v[j] = col[i * stride];
        ++count;
      } else if (i >= n_rows && w == 0) {
        atomicAdd(n_bad, 1);                                // once a slot
      }
    };
#pragma unroll
    for (int j = 0; j < P; ++j) issue(j, id_at(j));
#pragma unroll
    for (int j = 0; j < P; ++j) next[j] = id_at(P + j);
    for (int l0 = 0; l0 < len; l0 += P) {
#pragma unroll
      for (int j = 0; j < P; ++j) {         // slot l0 + j, in l order
        add_word<T>(acc, v[j]);
        issue(j, next[j]);                  // slot l0 + P + j
        next[j] = id_at(l0 + 2 * P + j);
      }
    }
    const float denom = static_cast<float>(count > 1 ? count : 1);
    alignas(sizeof(Word)) T val[E];
#pragma unroll
    for (int e = 0; e < E; ++e)
      val[e] = from_f32<T>(mean ? __fdiv_rn(acc[e], denom) : acc[e]);
    out_row[w] = *reinterpret_cast<const Word*>(val);
  }
}

// One warp owns one bag of narrow rows (≤ SLOT_WORDS words): in each
// chunk of 32 slots lane k loads the id and the row of slot c0 + k, the
// rows are staged in shared memory, and lane w (w < row_words) adds word
// w of the 32 staged rows in slot order.  The next chunk's rows and the
// one after's ids are in flight while a chunk is added.  A padded or
// out-of-range slot stages +0 (as in bag_kernel).
template <typename T, typename I, typename Word>
__global__ void __launch_bounds__(MAX_WARPS * 32)
slot_kernel(const T* __restrict__ table, long long n_rows, long long row_words,
            const I* __restrict__ ids, long long n_bags, long long bag_len,
            int mean, T* __restrict__ out, int* __restrict__ n_bad) {
  constexpr int E = sizeof(Word) / sizeof(T);
  constexpr int PAD = SLOT_WORDS + 1;     // row stride: fewer bank conflicts
  __shared__ Word stage[MAX_WARPS][32 * PAD];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long long bag = static_cast<long long>(blockIdx.x) *
                            (blockDim.x >> 5) + wib;
  if (bag >= n_bags) return;                      // the whole warp leaves
  const I* bag_ids = ids + bag * bag_len;
  const int len = static_cast<int>(bag_len);
  const int nw = static_cast<int>(row_words);
  const unsigned long long limit = static_cast<unsigned long long>(n_rows);
  const Word* rows = reinterpret_cast<const Word*>(table);
  Word* st = stage[wib];
  int count = 0;
  auto id_at = [&](int l) -> I {
    return l < len ? bag_ids[l] : static_cast<I>(-1);
  };
  auto load = [&](Word (&v)[SLOT_WORDS], I id) {
    const long long i = static_cast<long long>(id);
    const bool ok = static_cast<unsigned long long>(i) < limit;
#pragma unroll
    for (int w = 0; w < SLOT_WORDS; ++w) {
      v[w] = Word{};
      if (ok && w < nw) v[w] = rows[i * nw + w];
    }
    count += __popc(__ballot_sync(FULL, ok));
    if (!ok && i >= n_rows) atomicAdd(n_bad, 1);          // once a slot
  };
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  Word cur[SLOT_WORDS], nxt[SLOT_WORDS];
  load(cur, id_at(lane));
  I next_id = id_at(32 + lane);
  for (int c0 = 0; c0 < len; c0 += 32) {
    load(nxt, next_id);                           // slots c0 + 32 + lane
    next_id = id_at(c0 + 64 + lane);
#pragma unroll
    for (int w = 0; w < SLOT_WORDS; ++w)
      if (w < nw) st[lane * PAD + w] = cur[w];
    __syncwarp();
    if (lane < nw) {
#pragma unroll 8
      for (int k = 0; k < 32; ++k) add_word<T>(acc, st[k * PAD + lane]);
    }
    __syncwarp();
#pragma unroll
    for (int w = 0; w < SLOT_WORDS; ++w) cur[w] = nxt[w];
  }
  if (lane < nw) {
    const float denom = static_cast<float>(count > 1 ? count : 1);
    alignas(sizeof(Word)) T val[E];
#pragma unroll
    for (int e = 0; e < E; ++e)
      val[e] = from_f32<T>(mean ? __fdiv_rn(acc[e], denom) : acc[e]);
    reinterpret_cast<Word*>(out)[bag * nw + lane] =
        *reinterpret_cast<const Word*>(val);
  }
}

// Adds the number of ids ≥ n_rows to *n_bad (one atomic a warp that found
// any).
template <typename I>
__global__ void __launch_bounds__(256)
check_kernel(const I* __restrict__ ids, long long n, long long n_rows,
             int* __restrict__ n_bad) {
  int bad = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    bad += ids[i] >= n_rows;
  bad = __reduce_add_sync(FULL, bad);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(n_bad, bad);
}

// Warps a block: MAX_WARPS, halved while the launch has fewer blocks than
// the card has SMs (a small B spread over the card; a bag is never split,
// so its sums keep their order).
int warps_a_block(long long n_bags) {
  int dev = 0, n_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  int warps = MAX_WARPS;
  while (warps > 1 && (n_bags + warps - 1) / warps < n_sm) warps /= 2;
  return warps;
}

template <typename T, typename I, typename Word>
int launch_words(const void* table, long long n_rows, long long row_words,
                 const void* ids, long long n_bags, long long bag_len,
                 int mean, void* out, int* n_bad, int slots, int depth,
                 cudaStream_t s) {
  const int warps = warps_a_block(n_bags);
  const dim3 grid(static_cast<unsigned>((n_bags + warps - 1) / warps));
  const dim3 block(warps * 32);
  const T* t = static_cast<const T*>(table);
  const I* i = static_cast<const I*>(ids);
  T* o = static_cast<T*>(out);
  if (slots) {
    if (row_words > SLOT_WORDS) return 1000;
    slot_kernel<T, I, Word><<<grid, block, 0, s>>>(
        t, n_rows, row_words, i, n_bags, bag_len, mean, o, n_bad);
    return static_cast<int>(cudaGetLastError());
  }
#define BAG_LAUNCH(P)                                                      \
  bag_kernel<T, I, Word, P><<<grid, block, 0, s>>>(                        \
      t, n_rows, row_words, i, n_bags, bag_len, mean, o, n_bad)
  switch (depth) {
    case 1: BAG_LAUNCH(1); break;
    case 4: BAG_LAUNCH(4); break;
    case DEPTH: BAG_LAUNCH(DEPTH); break;
    default: return 1000;
  }
#undef BAG_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I>
int launch_typed(const void* table, long long n_rows, long long dim,
                 const void* ids, long long n_bags, long long bag_len,
                 int mean, void* out, int* n_bad, int word_bytes, int slots,
                 int depth, cudaStream_t s) {
  if (word_bytes < static_cast<int>(sizeof(T)) ||
      dim * static_cast<long long>(sizeof(T)) % word_bytes)
    return 1000;
  const long long row_words =
      dim * static_cast<long long>(sizeof(T)) / word_bytes;
#define WORDS(Word)                                                        \
  launch_words<T, I, Word>(table, n_rows, row_words, ids, n_bags, bag_len, \
                           mean, out, n_bad, slots, depth, s)
  switch (word_bytes) {
    case 16: return WORDS(uint4);
    case 8: return WORDS(uint2);
    case 4: return WORDS(unsigned);
    case 2:
      if constexpr (sizeof(T) == 2) return WORDS(unsigned short);
      return 1000;
    default: return 1000;
  }
#undef WORDS
}

}  // namespace

// table: (n_rows, dim) contiguous, dtype 0 = f32, 1 = bf16; ids: (n_bags,
// bag_len) contiguous, id_bits 32 or 64; out: (n_bags, dim) in the
// table's dtype; n_bad: one int that ids ≥ n_rows are added to.  The
// plan: word_bytes (16, 8, 4 or 2, at least an element; it divides the
// row's bytes, and the table and out pointers are aligned to it); slots =
// 1 for slot_kernel (a row of at most SLOT_WORDS words), else bag_kernel
// with depth slots in flight a lane (1, 4 or DEPTH).  Returns
// cudaGetLastError() after the launch (0 = launched); 1000 for an
// unsupported dtype, id width or plan (nothing launched).
extern "C" int repro_embedding_bag(const void* table, long long n_rows,
                                   long long dim, const void* ids,
                                   int id_bits, long long n_bags,
                                   long long bag_len, int mean, void* out,
                                   void* n_bad, int dtype, int word_bytes,
                                   int slots, int depth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* bad = static_cast<int*>(n_bad);
#define BAG_TYPED(T, I)                                                    \
  launch_typed<T, I>(table, n_rows, dim, ids, n_bags, bag_len, mean, out,  \
                     bad, word_bytes, slots, depth, s)
  if (dtype == 0 && id_bits == 32) return BAG_TYPED(float, int32_t);
  if (dtype == 0 && id_bits == 64) return BAG_TYPED(float, int64_t);
  if (dtype == 1 && id_bits == 32) return BAG_TYPED(__nv_bfloat16, int32_t);
  if (dtype == 1 && id_bits == 64) return BAG_TYPED(__nv_bfloat16, int64_t);
#undef BAG_TYPED
  return 1000;
}

// The wrapper's call: *n_bad set to the number of ids ≥ n_rows by a check
// launch, that count copied to host_count (pinned host memory) and the
// event `counted` recorded, the bag launch (as repro_embedding_bag, which
// adds the same ids to *n_bad again), then a wait for `counted` alone —
// not for the bags.  Returns the first non-zero status of the check, the
// copy, the launch and the wait.
extern "C" int repro_embedding_bag_checked(
    const void* table, long long n_rows, long long dim, const void* ids,
    int id_bits, long long n_bags, long long bag_len, int mean, void* out,
    void* n_bad, int dtype, int word_bytes, int slots, int depth,
    void* host_count, void* counted, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* bad = static_cast<int*>(n_bad);
  const long long n = n_bags * bag_len;
  if (id_bits != 32 && id_bits != 64) return 1000;
  cudaMemsetAsync(bad, 0, sizeof(int), s);
  if (n > 0) {
    long long blocks = (n + 4 * 256 - 1) / (4 * 256);
    if (blocks > 1024) blocks = 1024;
    const dim3 grid(static_cast<unsigned>(blocks)), block(256);
    if (id_bits == 32)
      check_kernel<int32_t><<<grid, block, 0, s>>>(
          static_cast<const int32_t*>(ids), n, n_rows, bad);
    else
      check_kernel<int64_t><<<grid, block, 0, s>>>(
          static_cast<const int64_t*>(ids), n, n_rows, bad);
  }
  int status = static_cast<int>(cudaGetLastError());
  if (status) return status;
  status = static_cast<int>(cudaMemcpyAsync(host_count, bad, sizeof(int),
                                            cudaMemcpyDeviceToHost, s));
  if (status) return status;
  cudaEvent_t ev = static_cast<cudaEvent_t>(counted);
  status = static_cast<int>(cudaEventRecord(ev, s));
  if (status) return status;
  status = repro_embedding_bag(table, n_rows, dim, ids, id_bits, n_bags,
                               bag_len, mean, out, n_bad, dtype, word_bytes,
                               slots, depth, stream);
  const int waited = static_cast<int>(cudaEventSynchronize(ev));
  return status ? status : waited;
}
