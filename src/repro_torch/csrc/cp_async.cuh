// Asynchronous global → shared copies (sm_80 and later, used here for
// sm_90a): the cp.async helpers shared by cluster.cu, flash_attention.cu,
// select.cu and, through imma.cuh, rerank.cu and similarity.cu.
//
// A copy is issued with cp_async16, the copies issued since the last
// commit form one group at cp_async_commit, and cp_async_wait<N> blocks
// until at most N groups are still in flight.  The waits carry no memory
// clobber: every caller follows a wait with __syncthreads before it reads
// what landed, which is both the compiler's and the block's barrier.

#pragma once

#include <cuda_runtime.h>

namespace repro_cp {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global → shared copy; `bytes` < 16 zero-fills the rest (0: a
// zero segment, and no byte of src is read, for rows and columns past the
// operand's edge).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace repro_cp
