// Fused centroid distances for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/cluster.py
// (fused_centroid_distances, body _dist_kernel): for (m, D) f32 rows x and
// (C, D) f32 centroids c it writes the (m, C) squared distances
//   out[i, j] = max((‖x_i‖² − 2·x_i·c_j) + ‖c_j‖², 0).
//
// Design.  One thread block owns a 32×32 output tile (256 threads, 2×2
// outputs each) and loops over D through 32-wide shared-memory tiles —
// the in-block loop takes the place of the TPU grid's sequential K axis.
// Every thread accumulates its own ‖x‖², ‖c‖² and x·c in order
// d = 0..D−1 with separately rounded products and sums (__fmul_rn /
// __fadd_rn, no multiply-add contraction).  That fixed order per output
// is the point: the index compares spill distances of a refolded subset
// of rows with a cold pass over all rows bit for bit, so a row's
// distances must not depend on the batch, and the plain version
// (repro_torch.kernels.ref.centroid_distances_ref, the same ordered loop
// in torch) must agree with the kernel bit for bit.
//
// Bound.  Three products and three sums per (row, centroid, feature):
// 6·m·C·D f32 operations against (m + C)·D·4 + m·C·4 bytes.  At the
// index's shapes (6040 × 78 centroids × 256 proxy dims) that is 7.2e8
// operations (~0.011 ms at 67 TFLOP/s) and 6.3 MB (~0.002 ms at
// 3.35 TB/s): bound by operations, and tiny next to a fit.
//
// Next design (not in this file): compute ‖x‖² and ‖c‖² once per row in
// a first pass instead of once per output, and the cross term on the
// tensor cores in a fixed k-order (still batch-invariant).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;        // rows per block
constexpr int BN = 32;        // centroids per block
constexpr int BK = 32;        // features per shared-memory tile
constexpr int NT = 256;       // threads per block (16 × 16)

__global__ void __launch_bounds__(NT)
dist_kernel(const float* __restrict__ x, const float* __restrict__ c,
            float* __restrict__ out, int m, int n, int d) {
  __shared__ float Xs[BK][BM + 1];
  __shared__ float Cs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float xx[2] = {0.f, 0.f};
  float cc[2] = {0.f, 0.f};
  float dot[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, f = e % BK;
      const int gr = row0 + r, gf = k0 + f;
      Xs[f][r] = (gr < m && gf < d) ? x[static_cast<size_t>(gr) * d + gf]
                                    : 0.f;
    }
    for (int e = tid; e < BN * BK; e += NT) {
      const int r = e / BK, f = e % BK;
      const int gr = col0 + r, gf = k0 + f;
      Cs[f][r] = (gr < n && gf < d) ? c[static_cast<size_t>(gr) * d + gf]
                                    : 0.f;
    }
    __syncthreads();
    const int kend = min(BK, d - k0);   // never add the padding zeros
    for (int f = 0; f < kend; ++f) {
      const float a0 = Xs[f][ty * 2], a1 = Xs[f][ty * 2 + 1];
      const float b0 = Cs[f][tx * 2], b1 = Cs[f][tx * 2 + 1];
      xx[0] = __fadd_rn(xx[0], __fmul_rn(a0, a0));
      xx[1] = __fadd_rn(xx[1], __fmul_rn(a1, a1));
      cc[0] = __fadd_rn(cc[0], __fmul_rn(b0, b0));
      cc[1] = __fadd_rn(cc[1], __fmul_rn(b1, b1));
      dot[0][0] = __fadd_rn(dot[0][0], __fmul_rn(a0, b0));
      dot[0][1] = __fadd_rn(dot[0][1], __fmul_rn(a0, b1));
      dot[1][0] = __fadd_rn(dot[1][0], __fmul_rn(a1, b0));
      dot[1][1] = __fadd_rn(dot[1][1], __fmul_rn(a1, b1));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = row0 + ty * 2 + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gc = col0 + tx * 2 + j;
      if (gc >= n) continue;
      const float t = __fsub_rn(xx[i], __fmul_rn(2.f, dot[i][j]));
      out[static_cast<size_t>(gr) * n + gc] = fmaxf(__fadd_rn(t, cc[j]),
                                                    0.f);
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); the caller
// raises on anything else.
extern "C" int repro_centroid_distances(const void* x, const void* c,
                                        void* out, int m, int n, int d,
                                        void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  dist_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<float*>(out), m, n, d);
  return static_cast<int>(cudaGetLastError());
}
