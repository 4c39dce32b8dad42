// big_sae_fwd — forward of the giant single SAE: the reconstruction x-hat,
// with the [B, n] codes never stored whole.
//
// Replaces: sparse_coding_tpu/ops/fused_big_sae.py::big_sae_forward (the
// Pallas _fwd_kernel, pallas_call at :234).
//
//   x-hat[b, :] = sum_f relu(xc[b] . E[:, f] + t_f) Wn_f
//   E [d, n] raw encoder (the JAX layout, read here with row stride n),
//   Wn [n, d] the row-normalized dictionary (formed by the wrapper)
//
// Bound on an H100: operations. 4*B*n*d fp32 FLOPs dense (the encode and
// decode products) against (2*B*d + 2*n*d + n)*4 bytes; at the trainer's
// shape (B=65536, n=16384, d=1024) that is 4.4 TFLOP = 66 ms at the
// 67 TFLOP/s fp32 (non-tensor) peak vs 0.67 GB = 0.2 ms at 3.35 TB/s. The
// decode product needs only the active codes; chip_smoke.py counts those.
// Tensor cores are out: TF32 would break compute_dtype="float32".
//
// Design: why chunked products. The TPU kernel keeps a batch tile's codes
// in VMEM and walks every feature tile; one block per 32-row batch tile
// doing the same on an SM reads one shared-memory word per multiply-add
// and is bound by it. Here the codes of one batch CHUNK of Bc rows live in
// a device workspace (C^T, Bc*n floats; the wrapper caps it at 1 GiB, the
// cap K9 uses: Bc = 16,384 at the trainer's shape), and the forward
// becomes two large products on the register-tiled template
// (sgemm_simt.cuh, one product a launch). Per chunk, in order on one
// stream:
//   codes:  C^T = relu(E^T . xc_k^T + t), [n, Bc]   (E contiguous along n:
//           16-byte copies; xc_k contiguous along d: 4-byte copies)
//   decode: x-hat_k = C^T^T . Wn, [Bc, d]           (both operands
//           contiguous along the output: 16-byte copies)
// The codes are stored feature-major (C^T) so that the decode's A operand
// is contiguous along its rows (the batch); the codes epilogue is the
// ensemble forwards' (sae_chunked.cuh) with t as the per-feature bias. The
// chunks write disjoint rows of x-hat, so nothing is added across them.
// Order: one thread sums each output over k in order, with no atomics, so
// two calls give the same bits. NaN survives the ReLU.
//
// The bf16-compute form (big_sae_fwd_bf16_*, compute_dtype="bfloat16"):
// the same schedule with both products on the Hopper tensor-core template
// (bgemm_wgmma.cuh: TMA loads into an mbarrier ring, wgmma, the epilogue
// staged through shared memory; one product a launch, Z = 1) and the JAX
// package's casts (fused_big_sae.py _fwd_kernel): xc and the raw E rounded
// to bf16 once a call, Wn normalized in fp32 (by the wrapper) then
// rounded, the codes rounded by the codes epilogue into Ctb [n, rows] —
// the decode's operand, as the JAX package's c.astype(bf16) . Wn; fp32
// accumulation and ReLU. A bf16 code takes 2 bytes, so a chunk holds twice
// the rows (32,768 at the trainer's shape: 2 chunks). Layouts on the
// template: codes A = Eb [d, n] M-contiguous (row stride n, shared by the
// whole grid), B = xb K-contiguous (run<false, true>), into the
// feature-major Ctb through the ensemble forwards' codes epilogue; decode
// A = Ctb [n, rows] M-contiguous, B = Wnb [n, d] N-contiguous
// (run<false, false>), the epilogue storing fp32 x-hat. Both epilogues
// only store, and K = d = 1,024 and K = n = 16,384 are past kWideK, so
// both take the 128 x 256 tile at the trainer's shape. Bound: 4*B*n*d bf16
// FLOPs (the decode's only over the active codes) at 989 TFLOP/s, about
// 3.4 ms at the trainer's shape with half the codes active, against
// 0.67 GB of bytes = 0.2 ms.
#include "bgemm_wgmma.cuh"
#include "sae_chunked.cuh"

using sgemm::Operand;
using sgemm::aligned16;

// Every entry point takes fp32, contiguous, row-major tensors and launches
// on `stream`; it returns the launch's cudaError_t. One chunk is `rows`
// consecutive batch rows (a multiple of 32); xc and xhat point at its
// first row. Ct is the [n, rows] workspace.

// Ct [n, rows] = relu(E [d, n]^T . xc [rows, d]^T + t [n])
extern "C" int big_sae_fwd_codes(const float* xc, const float* E,
                                 const float* t, float* Ct, int rows, int n,
                                 int d, void* stream) {
  if (!sae::big_chunk_ok(rows, n, d)) return (int)cudaErrorInvalidValue;
  const sae::CodesEpi<true> epi{t, Ct, n, rows, 0,
                                aligned16(Ct, rows, rows)};
  return (int)sgemm::run<false, true>(Operand{E, n, aligned16(E, n, n)},
                                      Operand{xc, d, false}, n, rows, d, epi,
                                      (cudaStream_t)stream);
}

// xhat [rows, d] = Ct [n, rows]^T . Wn [n, d]
extern "C" int big_sae_fwd_decode(const float* Ct, const float* Wn,
                                  float* xhat, int rows, int n, int d,
                                  void* stream) {
  if (!sae::big_chunk_ok(rows, n, d)) return (int)cudaErrorInvalidValue;
  const sgemm::AccumEpi epi{xhat, d, 0, aligned16(xhat, d, d), true, false,
                            1.f};
  return (int)sgemm::run<false, false>(
      Operand{Ct, rows, aligned16(Ct, rows, rows)},
      Operand{Wn, d, aligned16(Wn, d, d)}, rows, d, n, epi,
      (cudaStream_t)stream);
}

// The bf16 form's entry points: the same launches with bf16 dot operands
// (xb, Eb [d, n], Wnb [n, d] and the codes Ctb [n, rows]); x-hat stays
// fp32. d must be a multiple of 8 (16-byte copies along it).

// dst [count] = bf16(src): the centered batch's, the raw encoder's and
// the normalized dictionary's dot operands
extern "C" int big_sae_fwd_bf16_round(const float* src, sae::bf16* dst,
                                      long long count, void* stream) {
  return (int)sae::launch_round(src, dst, count, (cudaStream_t)stream);
}

// Ctb [n, rows] = bf16(relu(Eb [d, n]^T . xb [rows, d]^T + t [n]))
extern "C" int big_sae_fwd_bf16_codes(const sae::bf16* xb,
                                      const sae::bf16* Eb, const float* t,
                                      sae::bf16* Ctb, int rows, int n, int d,
                                      void* stream) {
  if (!sae::big_chunk_ok_bf16(rows, n, d)) return (int)cudaErrorInvalidValue;
  const sae::CodesEpi<true> epi{t, nullptr, n, rows, 0,
                                sae::aligned8(Ctb, rows, rows), nullptr, Ctb};
  return (int)wgemm::run<false, true>(wgemm::Operand{Eb, n, 0},
                                      wgemm::Operand{xb, d, 0}, n, rows, d,
                                      epi, false, (cudaStream_t)stream);
}

// xhat [rows, d] = Ctb [n, rows]^T . Wnb [n, d]
extern "C" int big_sae_fwd_bf16_decode(const sae::bf16* Ctb,
                                       const sae::bf16* Wnb, float* xhat,
                                       int rows, int n, int d, void* stream) {
  if (!sae::big_chunk_ok_bf16(rows, n, d)) return (int)cudaErrorInvalidValue;
  const sgemm::AccumEpi epi{xhat, d, 0, aligned16(xhat, d, d), true, false,
                            1.f};
  return (int)wgemm::run<false, false>(wgemm::Operand{Ctb, rows, 0},
                                       wgemm::Operand{Wnb, d, 0}, rows, d, n,
                                       epi, false, (cudaStream_t)stream);
}
