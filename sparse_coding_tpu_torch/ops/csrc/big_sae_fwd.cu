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
