// The two ensemble forwards' products (sae_tied_fwd.cu, sae_untied_fwd.cu)
// on the GEMM template, members on the grid's z. Apart from
// sae_chunked.cuh so that the libraries which launch neither product do
// not compile them.
#pragma once
#include "bgemm_wgmma.cuh"
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

// The bf16 forms of the two products (compute_dtype="bfloat16", on the
// Hopper tensor-core template bgemm_wgmma.cuh: TMA loads, wgmma, fp32
// sums): the same chunk, with x, W and Wn bf16 (the forward's batch
// rounded, or a bf16 batch as it came; the normalized dictionary rounded
// by the norm pass) and the codes rounded to bf16 by the codes epilogue
// into Ctb — the decode's operand, as the JAX package's
// x̂ = c.astype(bf16) · W. The decode's residual subtracts the batch in
// fp32: x is the fp32 batch, or the bf16 one widened (exact).
// Codes: A = W (per member), B = x (shared by every member: its map has
// z extent 1), both K-contiguous along d; the epilogue only stores 2
// bytes a code, so K = d >= kWideK takes the 128 x 256 tile. Decode: both
// operands MN-contiguous (Ctb along rows, Wn along d), K = n; the
// epilogue reads x, so K >= kWideKReads takes the 128 x 256 tile.
inline cudaError_t launch_fwd_codes_bf16(const bf16* x, const bf16* W,
                                         const float* b, const float* cm,
                                         bf16* Ctb, int Z, int rows, int n,
                                         int d, cudaStream_t stream) {
  if (!chunk_ok_bf16(Z, rows, n, d)) return cudaErrorInvalidValue;
  const size_t cz = (size_t)n * rows;
  const CodesEpi<true> epi{b, nullptr, n, rows, cz,
                           aligned8(Ctb, rows, rows, cz), cm, Ctb};
  return wgemm::run<true, true>(wgemm::Operand{W, d, (size_t)n * d},
                                wgemm::Operand{x, d, 0}, n, rows, d, epi,
                                false, stream, Z);
}

template <class TX>
inline cudaError_t launch_fwd_decode_bf16(const bf16* Ctb, const bf16* Wn,
                                          const TX* x, float* r, int Z,
                                          int rows, int n, int d, int B,
                                          cudaStream_t stream) {
  if (!chunk_ok_bf16(Z, rows, n, d) || B < rows)
    return cudaErrorInvalidValue;
  const size_t cz = (size_t)n * rows, wz = (size_t)n * d,
               rz = (size_t)B * d;
  const ResidEpiOf<TX> epi{x, r, d, rz,
                           sgemm::aligned16(r, d, d, rz) &&
                               ((uintptr_t)x & 15) == 0};
  return wgemm::run<false, false>(wgemm::Operand{Ctb, rows, cz},
                                  wgemm::Operand{Wn, d, wz}, rows, d, n, epi,
                                  true, stream, Z);
}

// Ctb, Wn and x as the C entry points take them: x fp32 or, x_bf16, bf16
inline cudaError_t launch_fwd_decode_bf16(const bf16* Ctb, const bf16* Wn,
                                          const void* x, int x_bf16,
                                          float* r, int Z, int rows, int n,
                                          int d, int B, cudaStream_t stream) {
  return x_bf16 ? launch_fwd_decode_bf16(Ctb, Wn, (const bf16*)x, r, Z, rows,
                                         n, d, B, stream)
                : launch_fwd_decode_bf16(Ctb, Wn, (const float*)x, r, Z,
                                         rows, n, d, B, stream);
}

}  // namespace sae
