// The bf16-compute forms' products of the two ensemble backwards
// (sae_tied_bwd.cu, sae_untied_bwd.cu; compute_dtype="bfloat16") on the
// Hopper tensor-core template (bgemm_wgmma.cuh: TMA loads, wgmma),
// members on the grid's z. Apart from sae_chunked.cuh so that the
// libraries which launch none of them do not compile them.
//
// The JAX package's casts (fused_sae_tiled.py _bwd_kernel; fused_sae.py
// _tied_tile_grads, _untied_kernel): x, W (the normalized tied dictionary
// or the normalized untied decoder, normalized in fp32 first), the raw
// untied encoder, r, the codes c and dpre are rounded to bf16 where they
// enter a product; the products accumulate in fp32. So the workspace of a
// chunk holds the fp32 codes C and dpre G — the per-feature sums (db, act,
// the l1 sum) and the ReLU masks stay fp32, as there — and their bf16
// roundings Cb and Gb, which the weight-grad products read: 12 bytes a
// (member, row, feature) against the fp32 forms' 8.
#pragma once
#include "bgemm_wgmma.cuh"
#include "sae_chunked.cuh"

namespace sae {

// C [Z, rows, n] = cm [Z, n] * relu(xb [rows, d] . Wb [Z, n, d]^T + b),
// fp32 into C and rounded into Cb (cm null: all ones)
inline cudaError_t launch_bwd_codes_bf16(const bf16* xb, const bf16* Wb,
                                         const float* b, const float* cm,
                                         float* C, bf16* Cb, int Z, int rows,
                                         int n, int d, cudaStream_t stream) {
  if (!chunk_ok_bf16(Z, rows, n, d)) return cudaErrorInvalidValue;
  const size_t cz = (size_t)rows * n;
  const bool vec = sgemm::aligned16(b, n, n, n) &&
                   sgemm::aligned16(C, n, n, cz) &&
                   (cm == nullptr || sgemm::aligned16(cm, n, n, n)) &&
                   aligned8(Cb, n, n, cz);
  const CodesEpi<false> epi{b, C, n, n, cz, vec, cm, Cb};
  return wgemm::run<true, true>(wgemm::Operand{xb, d, 0},
                                wgemm::Operand{Wb, d, (size_t)n * d}, rows, n,
                                d, epi, false, stream, Z);
}

// G [Z, rows, n] = (coef * (rb . Wb^T) + alphas / TB) * [C > 0], fp32
// into G and rounded into Gb, per member z: rb [rows, d] (members B*d
// apart), Wb [n, d], alphas[z]; TB >= B the global batch
inline cudaError_t launch_bwd_dpre_bf16(const bf16* rb, const bf16* Wb,
                                        const float* C, const float* alphas,
                                        float* G, bf16* Gb, int Z, int rows,
                                        int n, int d, int B, int TB,
                                        float coef, cudaStream_t stream) {
  if (!chunk_ok_bf16(Z, rows, n, d) || B < rows || TB < B)
    return cudaErrorInvalidValue;
  const size_t cz = (size_t)rows * n;
  const ScaledDpreEpi epi{C, alphas, G, Gb, n, cz,
                          sgemm::aligned16(C, n, n, cz) &&
                              sgemm::aligned16(G, n, n, cz) &&
                              aligned8(Gb, n, n, cz),
                          coef, (float)TB};
  return wgemm::run<true, true>(wgemm::Operand{rb, d, (size_t)B * d},
                                wgemm::Operand{Wb, d, (size_t)n * d}, rows, n,
                                d, epi, true, stream, Z);
}

// A weight-grad product: epi(Pb [Z, rows, n]^T . Qb [rows, d]) into
// [Z, n, d], Qb's members qz elements apart (0: one shared operand) — the
// fp32 forms' dwx / de (Gb, xb), dwr / dwn (Cb, rb) with their epilogues;
// epi_reads: the epilogue reads the grad back (a later chunk's, dwr)
template <class Epi>
inline cudaError_t launch_bwd_wgrad_bf16(const bf16* Pb, const bf16* Qb,
                                         size_t qz, const Epi& epi,
                                         bool epi_reads, int Z, int rows,
                                         int n, int d, cudaStream_t stream) {
  if (!chunk_ok_bf16(Z, rows, n, d)) return cudaErrorInvalidValue;
  return wgemm::run<false, false>(wgemm::Operand{Pb, n, (size_t)rows * n},
                                  wgemm::Operand{Qb, d, qz}, n, d, rows, epi,
                                  epi_reads, stream, Z);
}

}  // namespace sae
