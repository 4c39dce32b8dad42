// Pieces the untied SAE's forward (sae_untied_fwd.cu) and backward
// (sae_untied_bwd.cu) share: the decoder's clipped row norms and the codes
// epilogue of the product x·Eᵀ on the GEMM template (sgemm_simt.cuh).
#pragma once
#include "sae_common.cuh"
#include "sgemm_simt.cuh"

namespace sae {

// One warp per dictionary row: nv = max(sqrt(sum D^2), 1e-8), NaN kept,
// written to nrm[row] and/or Wn's row as D / nv (element by element, as
// torch's D / clamp(norm) rounds); either output may be null.
static __global__ void __launch_bounds__(kThreads)
row_norms_kernel(const float* __restrict__ D, int rows, int d,
                 float* __restrict__ nrm, float* __restrict__ wn) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* p = D + (size_t)row * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s += p[j] * p[j];
  s = warp_sum(s);
  const float nv = clipped_norm(s);
  if (nrm != nullptr && lane == 0) nrm[row] = nv;
  if (wn != nullptr) {
    float* q = wn + (size_t)row * d;
    for (int j = lane; j < d; j += 32) q[j] = __fdiv_rn(p[j], nv);
  }
}

inline cudaError_t launch_row_norms(const float* D, int rows, int d,
                                    float* nrm, float* wn,
                                    cudaStream_t stream) {
  if (rows < 1 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  row_norms_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      D, rows, d, nrm, wn);
  return cudaGetLastError();
}

// The codes of member z from the finished sums of x·E_zᵀ:
// c = relu_keep_nan(acc + b[z][f]), stored at c + z*cz with row stride ld.
// FeatMajor = false: the product's rows are batch rows and its columns
// features (C [rows, n]), so the bias runs along the 4 columns.
// FeatMajor = true: its rows are features and its columns batch rows
// (Cᵀ [n, rows]), so one bias value serves the 4. vec: 16-byte bias loads
// (row-major only) and stores.
template <bool FeatMajor>
struct CodesEpi {
  const float* b;  // [Z, n]
  float* c;
  int n;           // features: the bias's member stride
  int ld;
  size_t cz;
  bool vec;
  __device__ void operator()(int z, int m, int col, int N,
                             float (&v)[4]) const {
    float bv[4];
    if constexpr (FeatMajor) {
      const float bm = b[(size_t)z * n + m];
#pragma unroll
      for (int e = 0; e < 4; ++e) bv[e] = bm;
    } else {
      sgemm::load4(b + (size_t)z * n, 0, vec, 0, col, N, bv);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = relu_keep_nan(v[e] + bv[e]);
    sgemm::store4(c + z * cz, ld, vec, m, col, N, v);
  }
};

// The chunk shapes the untied kernels take: Z members of `rows` batch rows
// (a multiple of 32), n features (a multiple of 32), 1 <= d <= 768.
inline bool untied_chunk_ok(int Z, int rows, int n, int d) {
  return Z >= 1 && Z <= 65535 && rows >= 1 && rows % kFwdBatchTile == 0 &&
         n >= 1 && n % kFeatTile == 0 && d >= 1 && d <= kMaxD;
}

}  // namespace sae
