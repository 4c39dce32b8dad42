// sae_untied_bwd — backward of the untied SAE ensemble: exact gradients wrt
// the raw encoder and the normalized decoder, feature activity, the loss
// terms and the sentinel's grad sum of squares, for every member.
//
// Replaces: sparse_coding_tpu/ops/fused_sae_tiled.py::_bwd_call (the Pallas
// _bwd_kernel, tied=False, pallas_call at :439); with sae_untied_fwd it also
// carries the untiled contract of fused_sae.py::fused_untied_sae_grads
// (_untied_kernel).
//
//   pre = x E_m^T + b_m (E RAW), c = relu(pre), mask = [pre > 0]
//   Wn = D / max(||D||_row, 1e-8)
//   dpre = (coef * r_m Wn_m^T + alpha_m/B) * mask,   coef = 2/(B*d)
//   dE_m = dpre^T x,  dWn_m = coef * c^T r_m,  db_m = sum_b dpre,
//   act_m = sum_b mask
//   loss4_m = [sum r_m^2 / (B*d), alpha_m * sum c / B, sum mask / B,
//              sum dE_m^2 + sum dWn_m^2 + sum db_m^2]
//
// Bound on an H100: operations. 8*N*B*n*d fp32 FLOPs dense (four products)
// against (B*d + N*B*d + 4*N*n*d + 3*N*n)*4 bytes; at the canonical shape
// (N=32, B=2048, n=2048, d=512) 550 GFLOP = 8.2 ms at the 67 TFLOP/s fp32
// peak vs 0.68 GB = 0.2 ms at 3.35 TB/s. Three of the four products need
// only the active codes; chip_smoke.py counts those.
//
// Design: big_sae_bwd.cu's, with the members as a batch dimension of the
// products. A one-pass kernel — one block per (member, 16-feature tile)
// walking the whole batch with the weight-grad tiles in registers — loads
// two shared-memory words per multiply-add and is bound by them. Here the
// codes C and dpre G of whole members live in a device workspace (2*Z*Bc*n
// floats for Z members of Bc rows; the wrapper caps it at 1 GiB, which
// holds all 32 members at the canonical shape), and the four products
// become member-batched GEMMs on the register-tiled template
// (sgemm_simt.cuh, grid z = member). Per call, in order on one stream:
//   norms: nrm[m, f] = max(||D_m[f]||, 1e-8)                     (once)
//   per chunk of Z members x Bc rows:
//     codes: C[z] = relu(x_k E_z^T + b_z)                        (NT)
//     dpre:  G[z] = (coef * (r_z D_z^T) / nrm_z + alpha_z/B) * [C[z] > 0]
//                                                                (NT)
//     de:    dE_z (+)= G[z]^T x_k                                (TN)
//     dwn:   dWn_z (+)= C[z]^T r_z, times coef on the last chunk (TN)
//     sums:  db, act, csum = sum_b c per (member, feature) (+)= the
//            chunk's column sums of G, [C > 0] and C
//   loss:  loss4 per member: mse from r, l1/l0 from csum/act as double
//          sums, the sentinel's sum from the finished dE, dWn and db (once)
// A chunk holds whole members while their C and G fit the cap; a member
// whose codes alone exceed it is split into batch chunks, added in order.
//
// The normalized decoder is never stored: dpre divides each finished dot
// product r . D_f by its row's clipped norm. The plain version rounds each
// element of D / ||D|| and then dots, so the two differ by a few ulps of the
// dot product; no [N, n, d] Wn is written or read.
// [C > 0] is exactly [pre > 0]: a NaN pre gives a NaN C, and both are false.
// Every sum runs in a fixed order (one thread per output element over a
// chunk, chunks in order; fixed warp and slice orders in sums and loss),
// with no atomics, so two calls give the same bits.
//
// The bf16-compute form (sae_untied_bwd_bf16_*, compute_dtype="bfloat16"):
// the same schedule with its products on the Hopper tensor-core template
// (bgemm_wgmma.cuh: TMA loads, wgmma; through sae_bwd_bf16.cuh), with the
// JAX package's casts (fused_sae_tiled.py _bwd_kernel, tied=False): x, the
// raw E and r rounded to bf16 once a call (a bf16 batch as it comes), the
// decoder normalized in fp32 and rounded by the norm pass into Wnb — dpre's
// operand, so no norm is divided out here —, the codes and dpre stored fp32
// (for the sums and masks) and rounded (for de and dwn). Bound: 0.56 ms of
// bf16 FLOPs at the canonical shape against 0.2 ms of bytes; 12 bytes a code
// in the workspace.
#include "sae_bwd_bf16.cuh"

namespace {

using sgemm::AccumEpi;
using sgemm::Operand;
using sgemm::aligned16;
using sgemm::load4;
using sgemm::store4;
using sae::CodesEpi;
using sae::chunk_ok;

// G[z] = (coef * (acc / nrm[z][f]) + alpha[z]/B) * [C[z] > 0], the plain
// version's operations in its order (no contraction into an FMA)
struct DpreEpi {
  const float* c;
  const float* nrm;
  const float* alpha;
  float* g;
  int n;
  size_t cz;
  bool vec;
  float coef;
  float total_b;
  __device__ void operator()(int z, int m, int f, int N,
                             float (&v)[4]) const {
    float cv[4], nv[4];
    load4(c + z * cz, n, vec, m, f, N, cv);
    load4(nrm + (size_t)z * n, 0, vec, 0, f, N, nv);
    const float ab = alpha[z] / total_b;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = __fmul_rn(
          __fadd_rn(__fmul_rn(coef, __fdiv_rn(v[e], nv[e])), ab),
          cv[e] > 0.f ? 1.f : 0.f);
    store4(g + z * cz, n, vec, m, f, N, v);
  }
};

}  // namespace

// Every entry point takes fp32, contiguous, row-major tensors and launches
// on `stream`; it returns the launch's cudaError_t. A chunk is Z
// consecutive members and `rows` consecutive batch rows (a multiple of
// 32): x and r point at its first row (of its first member), E, D, b, nrm,
// alphas, dE, dWn, db, act and csum at its first member. r's members are
// B*d floats apart (B is the whole batch). C and G are the [Z, rows, n]
// workspace.

// nrm [rows] = max(||D [rows, d] row||, 1e-8)
extern "C" int sae_untied_bwd_norms(const float* D, float* nrm, int rows,
                                    int d, void* stream) {
  return (int)sae::launch_row_norms(D, rows, d, nrm, nullptr,
                                    (cudaStream_t)stream);
}

// C [Z, rows, n] = relu(x [rows, d] . E [Z, n, d]^T + b [Z, n])
extern "C" int sae_untied_bwd_codes(const float* x, const float* E,
                                    const float* b, float* C, int Z,
                                    int rows, int n, int d, void* stream) {
  if (!chunk_ok(Z, rows, n, d)) return (int)cudaErrorInvalidValue;
  const size_t cz = (size_t)rows * n;
  const CodesEpi<false> epi{b, C, n, n, cz,
                            aligned16(b, n, n, n) && aligned16(C, n, n, cz)};
  return (int)sgemm::run<true, true>(
      Operand{x, d, false, 0}, Operand{E, d, false, (size_t)n * d}, rows, n,
      d, epi, (cudaStream_t)stream, Z);
}

// G [Z, rows, n] = (coef * (r . D^T) / nrm + alphas / TB) * [C > 0], per
// member z: r [rows, d] (members B*d apart), D [n, d], nrm [n], alphas[z];
// TB >= B the global batch (B on a whole-batch call)
extern "C" int sae_untied_bwd_dpre(const float* r, const float* D,
                                   const float* nrm, const float* C,
                                   const float* alphas, float* G, int Z,
                                   int rows, int n, int d, int B, int TB,
                                   float coef, void* stream) {
  if (!chunk_ok(Z, rows, n, d) || B < rows || TB < B)
    return (int)cudaErrorInvalidValue;
  const size_t cz = (size_t)rows * n;
  const DpreEpi epi{C, nrm, alphas, G, n, cz,
                    aligned16(C, n, n, cz) && aligned16(G, n, n, cz) &&
                        aligned16(nrm, n, n, n),
                    coef, (float)TB};
  return (int)sgemm::run<true, true>(
      Operand{r, d, false, (size_t)B * d},
      Operand{D, d, false, (size_t)n * d}, rows, n, d, epi,
      (cudaStream_t)stream, Z);
}

// dE [Z, n, d] = (first ? 0 : dE) + G [Z, rows, n]^T . x [rows, d]
extern "C" int sae_untied_bwd_de(const float* x, const float* G, float* dE,
                                 int Z, int rows, int n, int d, int first,
                                 void* stream) {
  if (!chunk_ok(Z, rows, n, d)) return (int)cudaErrorInvalidValue;
  const size_t cz = (size_t)rows * n, wz = (size_t)n * d;
  const AccumEpi epi{dE, d, wz, aligned16(dE, d, d, wz), first != 0, false,
                     1.f};
  return (int)sgemm::run<false, false>(
      Operand{G, n, aligned16(G, n, n, cz), cz},
      Operand{x, d, aligned16(x, d, d), 0}, n, d, rows, epi,
      (cudaStream_t)stream, Z);
}

// dWn [Z, n, d] = (first ? 0 : dWn) + C [Z, rows, n]^T . r [rows, d]
// (members B*d apart), times coef when `last`
extern "C" int sae_untied_bwd_dwn(const float* C, const float* r,
                                  float* dWn, int Z, int rows, int n, int d,
                                  int B, int first, int last, float coef,
                                  void* stream) {
  if (!chunk_ok(Z, rows, n, d) || B < rows)
    return (int)cudaErrorInvalidValue;
  const size_t cz = (size_t)rows * n, wz = (size_t)n * d,
               rz = (size_t)B * d;
  const AccumEpi epi{dWn, d, wz, aligned16(dWn, d, d, wz), first != 0,
                     last != 0, coef};
  return (int)sgemm::run<false, false>(
      Operand{C, n, aligned16(C, n, n, cz), cz},
      Operand{r, d, aligned16(r, d, d, rz), rz}, n, d, rows, epi,
      (cudaStream_t)stream, Z);
}

// db, act, csum [Z, n] (+)= the column sums of G, [C > 0] and C [Z, rows, n]
extern "C" int sae_untied_bwd_sums(const float* C, const float* G, float* db,
                                   float* act, float* csum, int Z, int rows,
                                   int n, int first, void* stream) {
  return (int)sae::launch_sums(C, G, db, act, csum, Z, rows, n, first != 0,
                               (cudaStream_t)stream);
}

// loss4 [N, 4] of every member from r [N, B, d], the finished dE, dWn
// [N, n, d], db, act, csum [N, n] and alphas [N], normalized by the global
// batch TB >= B; part is a [N, P, 2] scratch (P slices a member, summed
// in order)
extern "C" int sae_untied_bwd_loss(const float* r, const float* dE,
                                   const float* dWn, const float* db,
                                   const float* act, const float* csum,
                                   const float* alphas, float* part,
                                   float* loss4, int N, int B, int TB, int n,
                                   int d, int P, void* stream) {
  return (int)sae::launch_loss(r, dE, dWn, db, act, csum, alphas, part, loss4,
                               N, B, TB, n, d, P, (cudaStream_t)stream);
}

// The bf16 form's entry points: the launches above with bf16 dot operands
// (xb, Eb, rb, Wnb, and the workspace's Cb and Gb beside the fp32 C and
// G); the sums and the loss read the fp32 values.

// dst [count] = bf16(src): the fp32 batch's, the raw encoder's and the
// residual's dot operands
extern "C" int sae_untied_bwd_bf16_round(const float* src, sae::bf16* dst,
                                         long long count, void* stream) {
  return (int)sae::launch_round(src, dst, count, (cudaStream_t)stream);
}

// Wnb [rows, d] = bf16(D / max(||D [rows, d] row||, 1e-8))
extern "C" int sae_untied_bwd_bf16_norms(const float* D, sae::bf16* Wnb,
                                         int rows, int d, void* stream) {
  return (int)sae::launch_row_norms(D, rows, d, nullptr, nullptr,
                                    (cudaStream_t)stream, Wnb);
}

// C [Z, rows, n] = relu(xb [rows, d] . Eb [Z, n, d]^T + b [Z, n]), and
// Cb = bf16(C)
extern "C" int sae_untied_bwd_bf16_codes(const sae::bf16* xb,
                                         const sae::bf16* Eb, const float* b,
                                         float* C, sae::bf16* Cb, int Z,
                                         int rows, int n, int d,
                                         void* stream) {
  return (int)sae::launch_bwd_codes_bf16(xb, Eb, b, nullptr, C, Cb, Z, rows,
                                         n, d, (cudaStream_t)stream);
}

// G [Z, rows, n] = (coef * (rb . Wnb^T) + alphas / TB) * [C > 0] and
// Gb = bf16(G), per member z: rb [rows, d] (members B*d apart)
extern "C" int sae_untied_bwd_bf16_dpre(const sae::bf16* rb,
                                        const sae::bf16* Wnb, const float* C,
                                        const float* alphas, float* G,
                                        sae::bf16* Gb, int Z, int rows, int n,
                                        int d, int B, int TB, float coef,
                                        void* stream) {
  return (int)sae::launch_bwd_dpre_bf16(rb, Wnb, C, alphas, G, Gb, Z, rows,
                                        n, d, B, TB, coef,
                                        (cudaStream_t)stream);
}

// dE [Z, n, d] = (first ? 0 : dE) + Gb [Z, rows, n]^T . xb [rows, d]
extern "C" int sae_untied_bwd_bf16_de(const sae::bf16* xb,
                                      const sae::bf16* Gb, float* dE, int Z,
                                      int rows, int n, int d, int first,
                                      void* stream) {
  const size_t wz = (size_t)n * d;
  const AccumEpi epi{dE, d, wz, aligned16(dE, d, d, wz), first != 0, false,
                     1.f};
  return (int)sae::launch_bwd_wgrad_bf16(Gb, xb, 0, epi, first == 0, Z, rows,
                                         n, d, (cudaStream_t)stream);
}

// dWn [Z, n, d] = (first ? 0 : dWn) + Cb [Z, rows, n]^T . rb [rows, d]
// (members B*d apart), times coef when `last`
extern "C" int sae_untied_bwd_bf16_dwn(const sae::bf16* Cb,
                                       const sae::bf16* rb, float* dWn,
                                       int Z, int rows, int n, int d, int B,
                                       int first, int last, float coef,
                                       void* stream) {
  if (B < rows) return (int)cudaErrorInvalidValue;
  const size_t wz = (size_t)n * d;
  const AccumEpi epi{dWn, d, wz, aligned16(dWn, d, d, wz), first != 0,
                     last != 0, coef};
  return (int)sae::launch_bwd_wgrad_bf16(Cb, rb, (size_t)B * d, epi,
                                         first == 0, Z, rows, n, d,
                                         (cudaStream_t)stream);
}

// db, act, csum [Z, n] (+)= the column sums of G, [C > 0] and C (fp32)
extern "C" int sae_untied_bwd_bf16_sums(const float* C, const float* G,
                                        float* db, float* act, float* csum,
                                        int Z, int rows, int n, int first,
                                        void* stream) {
  return (int)sae::launch_sums(C, G, db, act, csum, Z, rows, n, first != 0,
                               (cudaStream_t)stream);
}

// loss4 [N, 4] as sae_untied_bwd_loss (the fp32 residual, grads and sums)
extern "C" int sae_untied_bwd_bf16_loss(const float* r, const float* dE,
                                        const float* dWn, const float* db,
                                        const float* act, const float* csum,
                                        const float* alphas, float* part,
                                        float* loss4, int N, int B, int TB,
                                        int n, int d, int P, void* stream) {
  return (int)sae::launch_loss(r, dE, dWn, db, act, csum, alphas, part, loss4,
                               N, B, TB, n, d, P, (cudaStream_t)stream);
}
