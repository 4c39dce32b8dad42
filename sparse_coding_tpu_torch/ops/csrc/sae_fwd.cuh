// The two ensemble forwards' products (sae_tied_fwd.cu, sae_untied_fwd.cu)
// on the GEMM template, members on the grid's z. Apart from
// sae_chunked.cuh so that the libraries which launch neither product do
// not compile them.
#pragma once
#include "sae_chunked.cuh"

namespace sae {

// The two ensemble forwards' products, one chunk of Z members x `rows`
// batch rows (x points at its first row; W, b, cm at its first member):
// codes  Ct [Z, n, rows] = cm * relu(W [Z, n, d] . x [rows, d]^T + b),
//        feature-major (NT: W's rows load through 4-byte copies, as x's)
//        (cm [Z, n] 0/1, or null for all ones);
// decode r [Z, rows, d] (members B*d apart) = Ct^T . Wn [Z, n, d] - x
//        (TN: Ct and Wn contiguous along the output's rows and columns,
//        so both load through 16-byte copies where aligned).
inline cudaError_t launch_fwd_codes(const float* x, const float* W,
                                    const float* b, const float* cm,
                                    float* Ct, int Z, int rows, int n, int d,
                                    cudaStream_t stream) {
  if (!chunk_ok(Z, rows, n, d)) return cudaErrorInvalidValue;
  const size_t cz = (size_t)n * rows;
  const CodesEpi<true> epi{b, Ct, n, rows, cz,
                           sgemm::aligned16(Ct, rows, rows, cz), cm};
  return sgemm::run<true, true>(
      sgemm::Operand{W, d, false, (size_t)n * d},
      sgemm::Operand{x, d, false, 0}, n, rows, d, epi, stream, Z);
}

inline cudaError_t launch_fwd_decode(const float* Ct, const float* Wn,
                                     const float* x, float* r, int Z,
                                     int rows, int n, int d, int B,
                                     cudaStream_t stream) {
  if (!chunk_ok(Z, rows, n, d) || B < rows) return cudaErrorInvalidValue;
  const size_t cz = (size_t)n * rows, wz = (size_t)n * d,
               rz = (size_t)B * d;
  const ResidEpi epi{x, r, d, rz,
                     sgemm::aligned16(r, d, d, rz) &&
                         sgemm::aligned16(x, d, d)};
  return sgemm::run<false, false>(
      sgemm::Operand{Ct, rows, sgemm::aligned16(Ct, rows, rows, cz), cz},
      sgemm::Operand{Wn, d, sgemm::aligned16(Wn, d, d, wz), wz}, rows, d, n,
      epi, stream, Z);
}

}  // namespace sae
