// sae_tied_bwd — backward of the tied SAE ensemble (the masked family too):
// exact gradients wrt the normalized dictionary, db, feature activity, the
// loss terms and the sentinel's grad sum of squares, for every member.
//
// Replaces: sparse_coding_tpu/ops/fused_sae_tiled.py::_bwd_call (the Pallas
// _bwd_kernel, tied=True, masked or not; pallas_call at :439); with
// sae_tied_fwd it also carries the untiled contracts of fused_sae.py
// (fused_tied_sae_grads, fused_tied_sae_train_step).
//
//   W = E / max(||E||_row, 1e-8), on both sides
//   pre = x W_m^T + b_m, c = cm relu(pre), mask = cm [pre > 0]
//   (cm [N, n] the masked family's 0/1 coefficient mask, or all ones)
//   dpre = (coef * r_m W_m^T + alpha_m/B) * mask,   coef = 2/(B*d)
//   dW_m = dpre^T x + coef * c^T r_m,  db_m = sum_b dpre,
//   act_m = sum_b mask
//   loss4_m = [sum r_m^2 / (B*d), alpha_m * sum c / B, sum mask / B,
//              sum dW_m^2 + sum db_m^2]
//
// Bound on an H100: operations. 8*N*B*n*d fp32 FLOPs dense (four products)
// against (B*d + N*B*d + 2*N*n*d + 3*N*n)*4 bytes; at the canonical shape
// (N=32, B=2048, n=2048, d=512) 550 GFLOP = 8.2 ms at the 67 TFLOP/s fp32
// peak vs 0.39 GB = 0.12 ms at 3.35 TB/s. Three of the four products need
// only the active codes; chip_smoke.py counts those.
//
// Design: sae_untied_bwd.cu's, with one weight. A one-pass kernel — one
// block per (member, 32-feature tile) walking the batch with the
// weight-grad tile in registers — loads one or two shared-memory words per
// multiply-add and is bound by them. Here the codes C and dpre G of whole
// members live in a device workspace (2*Z*Bc*n floats for Z members of Bc
// rows; the wrapper caps it at 1 GiB, which holds all 32 members at the
// canonical shape), and the four products are member-batched GEMMs on the
// register-tiled template (sgemm_simt.cuh, grid z = member). Per call, in
// order on one stream:
//   norms: W = E / max(||E||_row, 1e-8) into an [N, n, d] scratch   (once)
//   per chunk of Z members x Bc rows:
//     codes: C[z] = cm_z relu(x_k W_z^T + b_z)                       (NT)
//     dpre:  G[z] = (coef * (r_z W_z^T) + alpha_z/B) * [C[z] > 0]     (NT)
//     dwx:   dW_z (+)= G[z]^T x_k                                    (TN)
//     dwr:   dW_z = dW_z + coef * (C[z]^T r_z)                       (TN)
//     sums:  db, act, csum = sum_b c per (member, feature) (+)= the
//            chunk's column sums of G, [C > 0] and C
//   loss:  loss4 per member: mse from r, l1/l0 from csum/act as double
//          sums, the sentinel's sum from the finished dW and db (once)
// A chunk holds whole members while their C and G fit the cap; a member
// whose codes alone exceed it is split into batch chunks, added in order
// (dwx then dwr per chunk), as the Pallas kernel adds batch tile by batch
// tile. A whole-member chunk rounds dW as the plain version does:
// (G^T x) + coef * (C^T r).
//
// W is written once, element by element as the plain version rounds
// E / ||E||: the codes' pre-activations then match the plain version's to
// summation order, where folding 1/||E|| into an epilogue would move them
// by a few more ulps and flip ReLU masks near 0.
// [C > 0] is exactly cm [pre > 0]: cm is 0 or 1, and a NaN pre gives a NaN
// C (times 0 too), for which both are false.
// Every sum runs in a fixed order (one thread per output element over a
// chunk, chunks in order; fixed warp and slice orders in sums and loss),
// with no atomics, so two calls give the same bits.
//
// The bf16-compute form (sae_tied_bwd_bf16_*, compute_dtype="bfloat16"): the
// same schedule with its products on the Hopper tensor-core template
// (bgemm_wgmma.cuh: TMA loads, wgmma; through sae_bwd_bf16.cuh), with the
// JAX package's casts (fused_sae_tiled.py _bwd_kernel): x and r rounded to
// bf16 once a call (a bf16 batch as it comes), Ŵ normalized in fp32 then
// rounded by the norm pass, the codes and dpre stored fp32 (for the sums and
// masks) and rounded (for dwx and dwr). Bound: 8*N*B*n*d bf16 FLOPs at 989
// TFLOP/s = 0.56 ms at the canonical shape against 0.39 GB = 0.12 ms; 12
// bytes a code in the workspace, so the canonical shape runs in chunks of 21
// and 11 members.
#include "sae_bwd_bf16.cuh"

namespace {

using sgemm::AccumEpi;
using sgemm::AddScaledEpi;
using sgemm::Operand;
using sgemm::aligned16;
using sae::chunk_ok;

}  // namespace

// Every entry point takes fp32, contiguous, row-major tensors and launches
// on `stream`; it returns the launch's cudaError_t. A chunk is Z
// consecutive members and `rows` consecutive batch rows (a multiple of
// 32): x and r point at its first row (of its first member), W, b, cm,
// alphas, dW, db, act and csum at its first member. r's members are B*d
// floats apart (B is the whole batch). C and G are the [Z, rows, n]
// workspace.

// W [rows, d] = E / max(||E [rows, d] row||, 1e-8)
extern "C" int sae_tied_bwd_norms(const float* E, float* W, int rows, int d,
                                  void* stream) {
  return (int)sae::launch_row_norms(E, rows, d, nullptr, W,
                                    (cudaStream_t)stream);
}

// C [Z, rows, n] = cm [Z, n] * relu(x [rows, d] . W [Z, n, d]^T + b [Z, n])
// (cm null: all ones)
extern "C" int sae_tied_bwd_codes(const float* x, const float* W,
                                  const float* b, const float* cm, float* C,
                                  int Z, int rows, int n, int d,
                                  void* stream) {
  if (!chunk_ok(Z, rows, n, d)) return (int)cudaErrorInvalidValue;
  const size_t cz = (size_t)rows * n;
  const bool vec = aligned16(b, n, n, n) && aligned16(C, n, n, cz) &&
                   (cm == nullptr || aligned16(cm, n, n, n));
  const sae::CodesEpi<false> epi{b, C, n, n, cz, vec, cm};
  return (int)sgemm::run<true, true>(
      Operand{x, d, false, 0}, Operand{W, d, false, (size_t)n * d}, rows, n,
      d, epi, (cudaStream_t)stream, Z);
}

// G [Z, rows, n] = (coef * (r . W^T) + alphas / TB) * [C > 0], per
// member z: r [rows, d] (members B*d apart), W [n, d], alphas[z]; TB >= B
// the global batch (B on a whole-batch call)
extern "C" int sae_tied_bwd_dpre(const float* r, const float* W,
                                 const float* C, const float* alphas,
                                 float* G, int Z, int rows, int n, int d,
                                 int B, int TB, float coef, void* stream) {
  if (!chunk_ok(Z, rows, n, d) || B < rows || TB < B)
    return (int)cudaErrorInvalidValue;
  const size_t cz = (size_t)rows * n;
  const sae::ScaledDpreEpi epi{C, alphas, G, nullptr, n, cz,
                               aligned16(C, n, n, cz) &&
                                   aligned16(G, n, n, cz),
                               coef, (float)TB};
  return (int)sgemm::run<true, true>(
      Operand{r, d, false, (size_t)B * d},
      Operand{W, d, false, (size_t)n * d}, rows, n, d, epi,
      (cudaStream_t)stream, Z);
}

// dW [Z, n, d] = (first ? 0 : dW) + G [Z, rows, n]^T . x [rows, d]
extern "C" int sae_tied_bwd_dwx(const float* x, const float* G, float* dW,
                                int Z, int rows, int n, int d, int first,
                                void* stream) {
  if (!chunk_ok(Z, rows, n, d)) return (int)cudaErrorInvalidValue;
  const size_t cz = (size_t)rows * n, wz = (size_t)n * d;
  const AccumEpi epi{dW, d, wz, aligned16(dW, d, d, wz), first != 0, false,
                     1.f};
  return (int)sgemm::run<false, false>(
      Operand{G, n, aligned16(G, n, n, cz), cz},
      Operand{x, d, aligned16(x, d, d), 0}, n, d, rows, epi,
      (cudaStream_t)stream, Z);
}

// dW [Z, n, d] = dW + coef * (C [Z, rows, n]^T . r [rows, d]) (members
// B*d apart)
extern "C" int sae_tied_bwd_dwr(const float* C, const float* r, float* dW,
                                int Z, int rows, int n, int d, int B,
                                float coef, void* stream) {
  if (!chunk_ok(Z, rows, n, d) || B < rows)
    return (int)cudaErrorInvalidValue;
  const size_t cz = (size_t)rows * n, wz = (size_t)n * d,
               rz = (size_t)B * d;
  const AddScaledEpi epi{dW, d, wz, aligned16(dW, d, d, wz), coef};
  return (int)sgemm::run<false, false>(
      Operand{C, n, aligned16(C, n, n, cz), cz},
      Operand{r, d, aligned16(r, d, d, rz), rz}, n, d, rows, epi,
      (cudaStream_t)stream, Z);
}

// db, act, csum [Z, n] (+)= the column sums of G, [C > 0] and C [Z, rows, n]
extern "C" int sae_tied_bwd_sums(const float* C, const float* G, float* db,
                                 float* act, float* csum, int Z, int rows,
                                 int n, int first, void* stream) {
  return (int)sae::launch_sums(C, G, db, act, csum, Z, rows, n, first != 0,
                               (cudaStream_t)stream);
}

// loss4 [N, 4] of every member from r [N, B, d], the finished dW [N, n, d],
// db, act, csum [N, n] and alphas [N], normalized by the global batch
// TB >= B; part is a [N, P, 2] scratch (P slices a member, summed in
// order)
extern "C" int sae_tied_bwd_loss(const float* r, const float* dW,
                                 const float* db, const float* act,
                                 const float* csum, const float* alphas,
                                 float* part, float* loss4, int N, int B,
                                 int TB, int n, int d, int P, void* stream) {
  return (int)sae::launch_loss(r, dW, nullptr, db, act, csum, alphas, part,
                               loss4, N, B, TB, n, d, P,
                               (cudaStream_t)stream);
}

// The bf16 form's entry points: the launches above with bf16 dot operands
// (xb, rb, Wb, and the workspace's Cb and Gb beside the fp32 C and G); the
// sums and the loss read the fp32 values.

// dst [count] = bf16(src): the fp32 batch's and the residual's dot operands
extern "C" int sae_tied_bwd_bf16_round(const float* src, sae::bf16* dst,
                                       long long count, void* stream) {
  return (int)sae::launch_round(src, dst, count, (cudaStream_t)stream);
}

// Wb [rows, d] = bf16(E / max(||E [rows, d] row||, 1e-8))
extern "C" int sae_tied_bwd_bf16_norms(const float* E, sae::bf16* Wb,
                                       int rows, int d, void* stream) {
  return (int)sae::launch_row_norms(E, rows, d, nullptr, nullptr,
                                    (cudaStream_t)stream, Wb);
}

// C [Z, rows, n] = cm [Z, n] * relu(xb [rows, d] . Wb [Z, n, d]^T + b),
// and Cb = bf16(C) (cm null: all ones)
extern "C" int sae_tied_bwd_bf16_codes(const sae::bf16* xb,
                                       const sae::bf16* Wb, const float* b,
                                       const float* cm, float* C,
                                       sae::bf16* Cb, int Z, int rows, int n,
                                       int d, void* stream) {
  return (int)sae::launch_bwd_codes_bf16(xb, Wb, b, cm, C, Cb, Z, rows, n, d,
                                         (cudaStream_t)stream);
}

// G [Z, rows, n] = (coef * (rb . Wb^T) + alphas / TB) * [C > 0] and
// Gb = bf16(G), per member z: rb [rows, d] (members B*d apart)
extern "C" int sae_tied_bwd_bf16_dpre(const sae::bf16* rb,
                                      const sae::bf16* Wb, const float* C,
                                      const float* alphas, float* G,
                                      sae::bf16* Gb, int Z, int rows, int n,
                                      int d, int B, int TB, float coef,
                                      void* stream) {
  return (int)sae::launch_bwd_dpre_bf16(rb, Wb, C, alphas, G, Gb, Z, rows, n,
                                        d, B, TB, coef, (cudaStream_t)stream);
}

// dW [Z, n, d] = (first ? 0 : dW) + Gb [Z, rows, n]^T . xb [rows, d]
extern "C" int sae_tied_bwd_bf16_dwx(const sae::bf16* xb,
                                     const sae::bf16* Gb, float* dW, int Z,
                                     int rows, int n, int d, int first,
                                     void* stream) {
  const size_t wz = (size_t)n * d;
  const AccumEpi epi{dW, d, wz, aligned16(dW, d, d, wz), first != 0, false,
                     1.f};
  return (int)sae::launch_bwd_wgrad_bf16(Gb, xb, 0, epi, first == 0, Z, rows,
                                         n, d, (cudaStream_t)stream);
}

// dW [Z, n, d] = dW + coef * (Cb [Z, rows, n]^T . rb [rows, d]) (members
// B*d apart)
extern "C" int sae_tied_bwd_bf16_dwr(const sae::bf16* Cb,
                                     const sae::bf16* rb, float* dW, int Z,
                                     int rows, int n, int d, int B,
                                     float coef, void* stream) {
  if (B < rows) return (int)cudaErrorInvalidValue;
  const size_t wz = (size_t)n * d;
  const AddScaledEpi epi{dW, d, wz, aligned16(dW, d, d, wz), coef};
  return (int)sae::launch_bwd_wgrad_bf16(Cb, rb, (size_t)B * d, epi, true, Z,
                                         rows, n, d, (cudaStream_t)stream);
}

// db, act, csum [Z, n] (+)= the column sums of G, [C > 0] and C (fp32)
extern "C" int sae_tied_bwd_bf16_sums(const float* C, const float* G,
                                      float* db, float* act, float* csum,
                                      int Z, int rows, int n, int first,
                                      void* stream) {
  return (int)sae::launch_sums(C, G, db, act, csum, Z, rows, n, first != 0,
                               (cudaStream_t)stream);
}

// loss4 [N, 4] as sae_tied_bwd_loss (the fp32 residual, grads and sums)
extern "C" int sae_tied_bwd_bf16_loss(const float* r, const float* dW,
                                      const float* db, const float* act,
                                      const float* csum, const float* alphas,
                                      float* part, float* loss4, int N,
                                      int B, int TB, int n, int d, int P,
                                      void* stream) {
  return (int)sae::launch_loss(r, dW, nullptr, db, act, csum, alphas, part,
                               loss4, N, B, TB, n, d, P,
                               (cudaStream_t)stream);
}
