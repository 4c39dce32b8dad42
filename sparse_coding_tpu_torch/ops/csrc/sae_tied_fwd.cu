// sae_tied_fwd — forward of the tied SAE ensemble (the masked family too),
// with the residual as its epilogue.
//
// Replaces: sparse_coding_tpu/ops/fused_sae_tiled.py::_fwd_call (the Pallas
// _fwd_kernel, tied=True, masked or not; pallas_call at :375) AND the XLA
// residual pass after it (tiled_tied_sae_grads: resid = xhat - x); with
// sae_tied_bwd it also carries the untiled contracts of fused_sae.py
// (fused_tied_sae_grads, fused_tied_sae_train_step).
//
//   r[m, b, :] = sum_f cm_f relu(x[b] . W_f + b_f) W_f  -  x[b]
//   W = E / max(||E||_row, 1e-8), on both sides
//   cm [N, n]: the masked family's coefficient mask (0/1), or nullptr for
//   all ones (the Pallas kernel's masked=True branch, c = c * mask)
//
// Bound on an H100: operations. 4*N*B*n*d fp32 FLOPs dense (two products)
// against (B*d + N*n*d + N*n + N*B*d)*4 bytes; at the canonical shape
// (N=32, B=2048, n=2048, d=512) that is 275 GFLOP = 4.1 ms at the
// 67 TFLOP/s fp32 (non-tensor) peak vs 0.14 GB = 0.04 ms at 3.35 TB/s. The
// decode product needs only the active codes; chip_smoke.py counts those.
// Tensor cores are out: TF32 would break compute_dtype="float32".
//
// Design: sae_untied_fwd.cu's, with one weight on both sides and the
// coefficient mask in the codes epilogue. A one-pass kernel — one block
// per (member, 32-row batch tile) walking every feature tile with the
// x-hat tile in registers — reads one shared-memory word per multiply-add
// and is bound by it. Here the codes of whole members live in a device
// workspace (Z*rows*n floats for Z members of `rows` rows; the wrapper caps
// it at 1 GiB, which holds all 32 members at the canonical shape), and per
// call, in order on one stream:
//   norms:  W = E / max(||E||_row, 1e-8) into an [N, n, d] scratch (once)
//   per chunk of Z members x rows batch rows:
//     codes:  C^T[z] = cm_z relu(W_z . x_k^T + b_z), [n, rows]     (NT)
//     decode: r_z[rows] = C^T[z]^T . W_z - x_k                      (TN)
// (the products and their epilogues are sae_fwd.cuh's, shared with the
// untied forward). The codes are stored feature-major so that the decode
// reads both operands through 16-byte copies. W is written once, element
// by element as the plain version rounds E / ||E|| (sae_tied_bwd's norm
// pass), so the codes' pre-activations match the plain version's to
// summation order. A chunk holds whole members while their codes fit the
// cap; a member whose codes alone exceed it runs in row chunks, which write
// disjoint rows of r, so nothing is added across chunks.
// Order: one thread sums each output over k in order, with no atomics, so
// two calls give the same bits. NaN survives the ReLU and the norm clip
// (times a 0 mask too).
//
// The bf16-compute form (sae_tied_fwd_bf16_*, compute_dtype="bfloat16"):
// the same schedule on the Hopper tensor-core template (bgemm_wgmma.cuh:
// TMA loads, wgmma), with the JAX package's casts (fused_sae_tiled.py
// _fwd_kernel): x rounded to bf16 (a bf16 batch as it comes), Ŵ
// normalized in fp32 then rounded, the codes rounded before the decode;
// fp32 accumulation, ReLU, mask and residual.
// Bound: 4*N*B*n*d bf16 FLOPs at 989 TFLOP/s = 0.28 ms at the canonical
// shape, against (B*d + N*n*d + N*n + N*B*d)*4 bytes = 0.04 ms; its
// codes take 2 bytes a code in the workspace (all 32 members in one
// chunk up to n = 8,192).
#include "sae_fwd.cuh"

// Every entry point takes fp32, contiguous, row-major tensors and launches
// on `stream`; it returns the launch's cudaError_t. A chunk is Z
// consecutive members and `rows` consecutive batch rows (a multiple of
// 32): x and r point at its first row (of its first member), W, b and cm
// at its first member. r's members are B*d floats apart (B is the whole
// batch). Ct is the [Z, n, rows] workspace.

// W [rows, d] = E / max(||E [rows, d] row||, 1e-8)
extern "C" int sae_tied_fwd_norms(const float* E, float* W, int rows, int d,
                                  void* stream) {
  return (int)sae::launch_row_norms(E, rows, d, nullptr, W,
                                    (cudaStream_t)stream);
}

// Ct [Z, n, rows] = cm [Z, n] * relu(W [Z, n, d] . x [rows, d]^T + b [Z, n])
// (cm null: all ones)
extern "C" int sae_tied_fwd_codes(const float* x, const float* W,
                                  const float* b, const float* cm, float* Ct,
                                  int Z, int rows, int n, int d,
                                  void* stream) {
  return (int)sae::launch_fwd_codes(x, W, b, cm, Ct, Z, rows, n, d,
                                    (cudaStream_t)stream);
}

// r [Z, rows, d] (members B*d apart) = Ct [Z, n, rows]^T . W [Z, n, d]
// - x [rows, d]
extern "C" int sae_tied_fwd_decode(const float* Ct, const float* W,
                                   const float* x, float* r, int Z, int rows,
                                   int n, int d, int B, void* stream) {
  return (int)sae::launch_fwd_decode(Ct, W, x, r, Z, rows, n, d, B,
                                     (cudaStream_t)stream);
}

// The bf16 form's entry points: the same launches with bf16 dot operands
// (x, W, the codes Ctb [Z, n, rows]); r stays fp32.

// dst [count] = bf16(src): the fp32 batch's dot operand
extern "C" int sae_tied_fwd_bf16_round(const float* src, sae::bf16* dst,
                                       long long count, void* stream) {
  return (int)sae::launch_round(src, dst, count, (cudaStream_t)stream);
}

// Wb [rows, d] = bf16(E / max(||E [rows, d] row||, 1e-8))
extern "C" int sae_tied_fwd_bf16_norms(const float* E, sae::bf16* Wb,
                                       int rows, int d, void* stream) {
  return (int)sae::launch_row_norms(E, rows, d, nullptr, nullptr,
                                    (cudaStream_t)stream, Wb);
}

// Ctb [Z, n, rows] = bf16(cm [Z, n] * relu(Wb [Z, n, d] . xb [rows, d]^T
// + b [Z, n])) (cm null: all ones)
extern "C" int sae_tied_fwd_bf16_codes(const sae::bf16* xb,
                                       const sae::bf16* Wb, const float* b,
                                       const float* cm, sae::bf16* Ctb, int Z,
                                       int rows, int n, int d, void* stream) {
  return (int)sae::launch_fwd_codes_bf16(xb, Wb, b, cm, Ctb, Z, rows, n, d,
                                         (cudaStream_t)stream);
}

// r [Z, rows, d] (members B*d apart) = Ctb^T . Wb - x, x [rows, d] fp32
// or (x_bf16) bf16
extern "C" int sae_tied_fwd_bf16_decode(const sae::bf16* Ctb,
                                        const sae::bf16* Wb, const void* x,
                                        int x_bf16, float* r, int Z,
                                        int rows, int n, int d, int B,
                                        void* stream) {
  return (int)sae::launch_fwd_decode_bf16(Ctb, Wb, x, x_bf16, r, Z, rows, n,
                                          d, B, (cudaStream_t)stream);
}
