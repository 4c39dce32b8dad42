// sae_untied_fwd — forward of the untied SAE ensemble, with the residual as
// its epilogue.
//
// Replaces: sparse_coding_tpu/ops/fused_sae_tiled.py::_fwd_call (the Pallas
// _fwd_kernel, tied=False) AND the XLA residual pass after it
// (tiled_untied_sae_grads: resid = xhat - x); with sae_untied_bwd it also
// carries the untiled contract of fused_sae.py::fused_untied_sae_grads.
//
//   r[m, b, :] = sum_f relu(x[b] . E_f + b_f) Wn_f  -  x[b]
//   E the RAW encoder (never normalized), Wn = D / max(||D||_row, 1e-8)
//
// Bound on an H100: operations. 4*N*B*n*d fp32 FLOPs dense (encode and
// decode products) against (B*d + 2*N*n*d + N*n + N*B*d)*4 bytes; at the
// canonical shape (N=32, B=2048, n=2048, d=512) that is 275 GFLOP = 4.1 ms
// at the 67 TFLOP/s fp32 (non-tensor) peak vs 0.41 GB = 0.12 ms at
// 3.35 TB/s. The decode product needs only the active codes, so the bound
// for a given run counts those (chip_smoke.py). Tensor cores are out:
// TF32 would break compute_dtype="float32".
//
// Design: two member-batched products on the register-tiled template
// (sgemm_simt.cuh, grid z = member), as in the untied backward. A one-pass
// kernel — one block per (member, 32-row batch tile) walking every feature
// tile — reads one shared-memory word per multiply-add and is bound by it.
// Here the codes of whole members live in a device workspace (Z*rows*n
// floats for Z members of `rows` rows; the wrapper caps it at 1 GiB, which
// holds all 32 members at the canonical shape), and per call, in order on
// one stream:
//   norms:  Wn = D / max(||D||_row, 1e-8) into an [N, n, d] scratch (once)
//   per chunk of Z members x rows batch rows:
//     codes:  C^T[z] = relu(E_z . x_k^T + b_z), [n, rows]          (NT)
//     decode: r_z[rows] = C^T[z]^T . Wn_z - x_k                    (TN)
// The codes are stored feature-major (C^T) so that the decode's A operand
// is contiguous along its rows (the batch) and, like Wn, loads through
// 16-byte cp.async; stored [rows, n] it would be contiguous along k and
// load through the 4-byte transposing copies, which ran the backward's
// products at 34-36 TFLOP/s against 42-43 (H100 SXM, 700 W).
// Wn is written once (128 MiB at the canonical shape) so that the decode
// rounds as the plain version does: each element of D / ||D|| first, then
// the dot products. A chunk holds whole members while their codes fit the
// cap; a member whose codes alone exceed it runs in row chunks, which write
// disjoint rows of r, so nothing is added across chunks.
// The two products are sae_tied_fwd.cu's (sae_fwd.cuh), with the raw
// E in the codes and no mask.
// Order: one thread sums each output over k in order, with no atomics, so
// two calls give the same bits. NaN survives the ReLU and the norm clip.
//
// The bf16-compute form (sae_untied_fwd_bf16_*, compute_dtype="bfloat16"):
// the same schedule on the Hopper tensor-core template (bgemm_wgmma.cuh:
// TMA loads, wgmma), with the JAX package's casts (fused_sae_tiled.py
// _fwd_kernel, tied=False): x and the raw E rounded to bf16 (a bf16 batch
// as it comes), Wn normalized in fp32 then rounded, the codes rounded
// before the decode; fp32 accumulation, ReLU and residual. Bound as
// sae_tied_fwd.cu's bf16 form (0.28 ms of bf16 FLOPs at the canonical
// shape, against 0.12 ms of bytes).
#include "sae_fwd.cuh"

// Every entry point takes fp32, contiguous, row-major tensors and launches
// on `stream`; it returns the launch's cudaError_t. A chunk is Z
// consecutive members and `rows` consecutive batch rows (a multiple of
// 32): x and r point at its first row (of its first member), E, Wn and b
// at its first member. r's members are B*d floats apart (B is the whole
// batch). Ct is the [Z, n, rows] workspace.

// Wn [rows, d] = D / max(||D [rows, d] row||, 1e-8)
extern "C" int sae_untied_fwd_norms(const float* D, float* Wn, int rows,
                                    int d, void* stream) {
  return (int)sae::launch_row_norms(D, rows, d, nullptr, Wn,
                                    (cudaStream_t)stream);
}

// Ct [Z, n, rows] = relu(E [Z, n, d] . x [rows, d]^T + b [Z, n])
extern "C" int sae_untied_fwd_codes(const float* x, const float* E,
                                    const float* b, float* Ct, int Z,
                                    int rows, int n, int d, void* stream) {
  return (int)sae::launch_fwd_codes(x, E, b, nullptr, Ct, Z, rows, n, d,
                                    (cudaStream_t)stream);
}

// r [Z, rows, d] (members B*d apart) = Ct [Z, n, rows]^T . Wn [Z, n, d]
// - x [rows, d]
extern "C" int sae_untied_fwd_decode(const float* Ct, const float* Wn,
                                     const float* x, float* r, int Z,
                                     int rows, int n, int d, int B,
                                     void* stream) {
  return (int)sae::launch_fwd_decode(Ct, Wn, x, r, Z, rows, n, d, B,
                                     (cudaStream_t)stream);
}

// The bf16 form's entry points: the same launches with bf16 dot operands
// (x, E, Wn, the codes Ctb [Z, n, rows]); r stays fp32.

// dst [count] = bf16(src): the fp32 batch's and the raw encoder's dot
// operands
extern "C" int sae_untied_fwd_bf16_round(const float* src, sae::bf16* dst,
                                         long long count, void* stream) {
  return (int)sae::launch_round(src, dst, count, (cudaStream_t)stream);
}

// Wnb [rows, d] = bf16(D / max(||D [rows, d] row||, 1e-8))
extern "C" int sae_untied_fwd_bf16_norms(const float* D, sae::bf16* Wnb,
                                         int rows, int d, void* stream) {
  return (int)sae::launch_row_norms(D, rows, d, nullptr, nullptr,
                                    (cudaStream_t)stream, Wnb);
}

// Ctb [Z, n, rows] = bf16(relu(Eb [Z, n, d] . xb [rows, d]^T + b [Z, n]))
extern "C" int sae_untied_fwd_bf16_codes(const sae::bf16* xb,
                                         const sae::bf16* Eb, const float* b,
                                         sae::bf16* Ctb, int Z, int rows,
                                         int n, int d, void* stream) {
  return (int)sae::launch_fwd_codes_bf16(xb, Eb, b, nullptr, Ctb, Z, rows, n,
                                         d, (cudaStream_t)stream);
}

// r [Z, rows, d] (members B*d apart) = Ctb^T . Wnb - x, x [rows, d] fp32
// or (x_bf16) bf16
extern "C" int sae_untied_fwd_bf16_decode(const sae::bf16* Ctb,
                                          const sae::bf16* Wnb,
                                          const void* x, int x_bf16,
                                          float* r, int Z, int rows, int n,
                                          int d, int B, void* stream) {
  return (int)sae::launch_fwd_decode_bf16(Ctb, Wnb, x, x_bf16, r, Z, rows,
                                          n, d, B, (cudaStream_t)stream);
}
