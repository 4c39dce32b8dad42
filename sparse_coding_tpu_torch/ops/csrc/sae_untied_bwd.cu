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
#include "sae_untied_common.cuh"

namespace {

using sgemm::AccumEpi;
using sgemm::Operand;
using sgemm::aligned16;
using sgemm::load4;
using sgemm::store4;
using sae::CodesEpi;
using sae::untied_chunk_ok;

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

// Block (32 features, member z): warp w sums rows w, w+8, ... of the
// chunk in order, then warps 0..7 are added in order; the first chunk of
// a member writes, later ones add.
__global__ void __launch_bounds__(sae::kThreads)
sums_kernel(const float* __restrict__ C, const float* __restrict__ G,
            int rows, int n, bool first, float* __restrict__ db,
            float* __restrict__ act, float* __restrict__ csum) {
  __shared__ float part[3][sae::kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int f = blockIdx.x * 32 + lane;
  const size_t off = (size_t)blockIdx.y * rows * n;
  float sg = 0.f, sc = 0.f, cnt = 0.f;
#pragma unroll 4
  for (int b = w; b < rows; b += sae::kWarps) {
    const float cv = C[off + (size_t)b * n + f];
    sg += G[off + (size_t)b * n + f];
    sc += cv;
    cnt += cv > 0.f ? 1.f : 0.f;
  }
  part[0][w][lane] = sg;
  part[1][w][lane] = sc;
  part[2][w][lane] = cnt;
  __syncthreads();
  if (w == 0) {
    float a = 0.f, c = 0.f, k = 0.f;
    for (int i = 0; i < sae::kWarps; ++i) {
      a += part[0][i][lane];
      c += part[1][i][lane];
      k += part[2][i][lane];
    }
    const size_t o = (size_t)blockIdx.y * n + f;
    if (!first) {
      a = db[o] + a;
      c = csum[o] + c;
      k = act[o] + k;
    }
    db[o] = a;
    csum[o] = c;
    act[o] = k;
  }
}

// Block (slice p of P, member m): part[m][p] = (sum r^2, sum dE^2 + dWn^2
// + db^2) over the slice's share of each array.
__global__ void __launch_bounds__(sae::kThreads)
loss_part_kernel(const float* __restrict__ r, const float* __restrict__ dE,
                 const float* __restrict__ dWn, const float* __restrict__ db,
                 int B, int n, int d, float* __restrict__ part) {
  __shared__ float red[sae::kWarps];
  const int p = blockIdx.x, P = gridDim.x, m = blockIdx.y;
  const size_t len_r = (size_t)B * d, len_w = (size_t)n * d;
  const float* rm = r + m * len_r;
  const float* em = dE + m * len_w;
  const float* wm = dWn + m * len_w;
  const float* bm = db + (size_t)m * n;
  float sr = 0.f, sg = 0.f;
  for (size_t i = len_r * p / P + threadIdx.x; i < len_r * (p + 1) / P;
       i += sae::kThreads)
    sr += rm[i] * rm[i];
  for (size_t i = len_w * p / P + threadIdx.x; i < len_w * (p + 1) / P;
       i += sae::kThreads)
    sg += em[i] * em[i] + wm[i] * wm[i];
  for (int i = n * p / P + threadIdx.x; i < n * (p + 1) / P;
       i += sae::kThreads)
    sg += bm[i] * bm[i];
  sr = sae::block_sum(sr, red);
  sg = sae::block_sum(sg, red);
  if (threadIdx.x == 0) {
    part[((size_t)m * P + p) * 2] = sr;
    part[((size_t)m * P + p) * 2 + 1] = sg;
  }
}

// Block m: the member's loss4 from its P slices (in order) and its
// per-feature c sums and counts (double sums).
__global__ void __launch_bounds__(sae::kThreads)
loss_final_kernel(const float* __restrict__ part,
                  const float* __restrict__ csum,
                  const float* __restrict__ act,
                  const float* __restrict__ alphas, int P, int B, int n,
                  int d, float* __restrict__ loss4) {
  __shared__ double red[2][sae::kWarps];
  const int m = blockIdx.x;
  double l1 = 0.0, l0 = 0.0;
  for (int f = threadIdx.x; f < n; f += sae::kThreads) {
    l1 += csum[(size_t)m * n + f];
    l0 += act[(size_t)m * n + f];
  }
  l1 = sae::block_sum(l1, red[0]);
  l0 = sae::block_sum(l0, red[1]);
  if (threadIdx.x == 0) {
    float sr = 0.f, sg = 0.f;
    for (int p = 0; p < P; ++p) {
      sr += part[((size_t)m * P + p) * 2];
      sg += part[((size_t)m * P + p) * 2 + 1];
    }
    const float batch_f = (float)B;
    loss4[m * 4] = sr / (float)((long long)B * d);
    loss4[m * 4 + 1] = alphas[m] * (float)l1 / batch_f;
    loss4[m * 4 + 2] = (float)l0 / batch_f;
    loss4[m * 4 + 3] = sg;
  }
}

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
  if (!untied_chunk_ok(Z, rows, n, d)) return (int)cudaErrorInvalidValue;
  const size_t cz = (size_t)rows * n;
  const CodesEpi<false> epi{b, C, n, n, cz,
                            aligned16(b, n, n, n) && aligned16(C, n, n, cz)};
  return (int)sgemm::run<true, true>(
      Operand{x, d, false, 0}, Operand{E, d, false, (size_t)n * d}, rows, n,
      d, epi, (cudaStream_t)stream, Z);
}

// G [Z, rows, n] = (coef * (r . D^T) / nrm + alphas / B) * [C > 0], per
// member z: r [rows, d] (members B*d apart), D [n, d], nrm [n], alphas[z]
extern "C" int sae_untied_bwd_dpre(const float* r, const float* D,
                                   const float* nrm, const float* C,
                                   const float* alphas, float* G, int Z,
                                   int rows, int n, int d, int B, float coef,
                                   void* stream) {
  if (!untied_chunk_ok(Z, rows, n, d) || B < rows)
    return (int)cudaErrorInvalidValue;
  const size_t cz = (size_t)rows * n;
  const DpreEpi epi{C, nrm, alphas, G, n, cz,
                    aligned16(C, n, n, cz) && aligned16(G, n, n, cz) &&
                        aligned16(nrm, n, n, n),
                    coef, (float)B};
  return (int)sgemm::run<true, true>(
      Operand{r, d, false, (size_t)B * d},
      Operand{D, d, false, (size_t)n * d}, rows, n, d, epi,
      (cudaStream_t)stream, Z);
}

// dE [Z, n, d] = (first ? 0 : dE) + G [Z, rows, n]^T . x [rows, d]
extern "C" int sae_untied_bwd_de(const float* x, const float* G, float* dE,
                                 int Z, int rows, int n, int d, int first,
                                 void* stream) {
  if (!untied_chunk_ok(Z, rows, n, d)) return (int)cudaErrorInvalidValue;
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
  if (!untied_chunk_ok(Z, rows, n, d) || B < rows)
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
  if (!untied_chunk_ok(Z, rows, n, 1)) return (int)cudaErrorInvalidValue;
  sums_kernel<<<dim3(n / 32, Z), sae::kThreads, 0, (cudaStream_t)stream>>>(
      C, G, rows, n, first != 0, db, act, csum);
  return (int)cudaGetLastError();
}

// loss4 [N, 4] of every member from r [N, B, d], the finished dE, dWn
// [N, n, d], db, act, csum [N, n] and alphas [N]; part is a [N, P, 2]
// scratch (P slices a member, summed in order)
extern "C" int sae_untied_bwd_loss(const float* r, const float* dE,
                                   const float* dWn, const float* db,
                                   const float* act, const float* csum,
                                   const float* alphas, float* part,
                                   float* loss4, int N, int B, int n, int d,
                                   int P, void* stream) {
  if (!untied_chunk_ok(N, B, n, d) || P < 1 || P > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  loss_part_kernel<<<dim3(P, N), sae::kThreads, 0, s>>>(r, dE, dWn, db, B, n,
                                                        d, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  loss_final_kernel<<<N, sae::kThreads, 0, s>>>(part, csum, act, alphas, P, B,
                                                n, d, loss4);
  return (int)cudaGetLastError();
}
