// big_sae_bwd — backward of the giant single SAE: every parameter grad,
// the dead-feature tracker's activation mass and the l1/l0 sums, with the
// [B, n] codes never stored whole.
//
// Replaces: sparse_coding_tpu/ops/fused_big_sae.py:253 big_sae_backward
// (the Pallas _bwd_kernel, pallas_call at :298).
//
//   pre = xc E + t (E [d, n] RAW), c = relu(pre), mask = [pre > 0]
//   dpre = (coef * r Wn^T + alpha/B) * mask,   coef = 2/(B*d)
//   dE = xc^T dpre,  dWn = coef * c^T r,  dt = sum_b dpre,
//   c_totals = sum_b c,  l1 = sum c,  l0 = sum mask
//   dctr_enc = -sum_b sum_f dpre[b, f] E[:, f] = -E dt
//
// The last line is the TPU kernel's fifth product (a [Bt, Ft] x [Ft, d]
// product per grid step, summed over the batch) reordered: since
// sum_b dpre[b, f] = dt_f, it is one matvec after the last chunk. Same
// function, summed in another order, and B*n*d fewer multiply-adds.
//
// Bound on an H100: operations. 8*B*n*d fp32 FLOPs dense (pre, r Wn^T and
// the two weight-grad products) against (2*B*d + 4*n*d + 3*n + d)*4 bytes;
// at the trainer's shape (B=65536, n=16384, d=1024) that is 8.8 TFLOP =
// 131 ms at the 67 TFLOP/s fp32 peak vs about 0.8 GB = 0.25 ms at 3.35 TB/s.
// Two of the four products need only the active codes (about half);
// chip_smoke.py counts those, which puts the bound at about 82 ms.
//
// Design: why chunked products. The TPU kernel keeps one batch tile's
// codes in VMEM and accumulates dE and dWn over batch tiles. An SM has
// 227 KB, not VMEM's megabytes, and holding dE[:, tile] and dWn[tile] in
// registers across the whole batch capped a feature tile at 16 at d=1024
// and sent the whole batch through every block (7 TFLOP/s on an H100).
// Here the codes of one batch CHUNK of Bc rows live in a bounded
// device-memory workspace (C and G = dpre, 2*Bc*n*4 bytes; the wrapper caps
// it at 1 GiB, Bc = 8192 at the trainer's shape), and the four products
// become large ordinary GEMMs that a register-tiled kernel (sgemm_simt.cuh)
// runs near the fp32 FMA rate. Per chunk, in order on one stream:
//   codes: C = relu(xc_k E + t)                       (NN, [Bc,d] x [d,n])
//   dpre:  G = (coef * r_k Wn^T + alpha/B) * [C > 0]   (NT, [Bc,d] x [n,d]^T)
//   de:    dE (+)= xc_k^T G                           (TN, [d,Bc] x [Bc,n])
//   dwn:   dWn (+)= C^T r_k, times coef on the last chunk (TN)
//   sums:  dt (+)= sum_b G, c_totals (+)= sum_b C, l0 per feature (+)=
//          count(C > 0)
// and after the last chunk, dctr: -E dt as a matvec, with l1 = sum c_totals
// and l0 = sum of the per-feature counts (in double, fixed order).
// [C > 0] is exactly [pre > 0]: a NaN pre gives a NaN C, and both are false.
// Every sum runs in a fixed order (one thread per output element over a
// chunk, chunks in order; fixed warp orders in sums and dctr), with no
// atomics, so two calls give the same bits.
//
// The bf16-compute form (big_sae_bwd_bf16_*, compute_dtype="bfloat16"):
// the same schedule with the four products on the Hopper tensor-core
// template (bgemm_wgmma.cuh: TMA loads into an mbarrier ring, wgmma, the
// epilogue staged through shared memory; one product a launch, Z = 1) and
// the JAX package's casts (fused_big_sae.py _bwd_kernel): xc, the raw E and
// r rounded to bf16 once a call, Wn normalized in fp32 (by the wrapper)
// then rounded; the codes C and dpre G
// stored fp32 — dt, c_totals, l1, l0 and the masks are fp32 sums and tests
// of fp32 values, as there — beside their bf16 roundings Cb and Gb, which
// de and dwn read (12 bytes a code: 5,440 rows a chunk at the trainer's
// shape, 13 chunks). The reordering of dctr above no longer holds: the JAX
// kernel sums the ROUNDED dpre against the rounded E, so the sums pass also
// forms dtb = sum_b bf16(G) and dctr = -bf16(E) dtb. Bound: 8*B*n*d bf16
// FLOPs, three of the products only over the active codes, at 989 TFLOP/s
// plus the sums, about 5.7 ms at the trainer's shape, against 0.8 GB of
// bytes = 0.25 ms. Layouts on the template: codes A = xb K-contiguous, B =
// Eb [d, n] N-contiguous (run<true, false>); dpre both K-contiguous; de and
// dwn both M/N-contiguous (K = the chunk's rows: at 5,440 the 128 x 256
// tile also where they add to the grads, kWideKReads). The tile a product
// takes depends only on its K and on whether its epilogue reads (the
// codes' K = d and store-only epilogue fix theirs), so each code has the
// same bits whatever the chunk's row count.
#include "bgemm_wgmma.cuh"
#include "sae_chunked.cuh"

namespace {

using sgemm::AccumEpi;
using sgemm::Operand;
using sgemm::aligned16;
using sgemm::load4;
using sgemm::store4;
using sae::big_chunk_ok;

// C = relu_keep_nan(acc + t[n])
struct CodesEpi {
  const float* t;
  float* c;
  int ld;
  bool vec;
  __device__ void operator()(int, int m, int n, int N, float (&v)[4]) const {
    float tv[4];
    load4(t, 0, vec, 0, n, N, tv);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = sae::relu_keep_nan(v[e] + tv[e]);
    store4(c, ld, vec, m, n, N, v);
  }
};

// G = (coef * acc + alpha/B) * [C > 0], the operations of the plain version
// in its order (no contraction into an FMA)
struct DpreEpi {
  const float* c;
  const float* alpha;
  float* g;
  int ld;
  bool vec;
  float coef;
  float total_b;
  __device__ void operator()(int, int m, int n, int N, float (&v)[4]) const {
    float cv[4];
    load4(c, ld, vec, m, n, N, cv);
    const float ab = alpha[0] / total_b;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = __fmul_rn(__fadd_rn(__fmul_rn(coef, v[e]), ab),
                       cv[e] > 0.f ? 1.f : 0.f);
    store4(g, ld, vec, m, n, N, v);
  }
};

constexpr int kSumWarps = sae::kWarps;

// One block per 32 features: warp w sums rows w, w+8, ... of the chunk in
// order, then warps 0..7 are added in order. Rounded (the bf16 form): also
// dtb (+)= the column sums of the chunk's bf16 dpre Gb, widened exactly.
template <bool Rounded>
__global__ void __launch_bounds__(sae::kThreads)
sums_kernel(const float* __restrict__ C, const float* __restrict__ G,
            const sae::bf16* __restrict__ Gb, int rows, int n, bool first,
            float* __restrict__ dt, float* __restrict__ dtb,
            float* __restrict__ c_totals, float* __restrict__ l0f) {
  __shared__ float part[Rounded ? 4 : 3][kSumWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int f = blockIdx.x * 32 + lane;
  float sg = 0.f, sc = 0.f, cnt = 0.f, sgb = 0.f;
#pragma unroll 4
  for (int b = w; b < rows; b += kSumWarps) {
    const float cv = C[(size_t)b * n + f];
    sg += G[(size_t)b * n + f];
    sc += cv;
    cnt += cv > 0.f ? 1.f : 0.f;
    if constexpr (Rounded) sgb += __bfloat162float(Gb[(size_t)b * n + f]);
  }
  part[0][w][lane] = sg;
  part[1][w][lane] = sc;
  part[2][w][lane] = cnt;
  if constexpr (Rounded) part[3][w][lane] = sgb;
  __syncthreads();
  if (w == 0) {
    float a = 0.f, c = 0.f, k = 0.f, ab = 0.f;
    for (int i = 0; i < kSumWarps; ++i) {
      a += part[0][i][lane];
      c += part[1][i][lane];
      k += part[2][i][lane];
      if constexpr (Rounded) ab += part[3][i][lane];
    }
    if (!first) {
      a = dt[f] + a;
      c = c_totals[f] + c;
      k = l0f[f] + k;
      if constexpr (Rounded) ab = dtb[f] + ab;
    }
    dt[f] = a;
    c_totals[f] = c;
    l0f[f] = k;
    if constexpr (Rounded) dtb[f] = ab;
  }
}

// Blocks 0..d-1: dctr[j] = -sum_f E[j, f] dt[f] (E fp32, or bf16 widened
// exactly). Block d: l1 = sum_f c_totals[f] and l0 = sum_f l0f[f], in
// double.
template <class TE>
__global__ void __launch_bounds__(sae::kThreads)
dctr_kernel(const TE* __restrict__ E, const float* __restrict__ dt,
            const float* __restrict__ c_totals, const float* __restrict__ l0f,
            int n, int d, float* __restrict__ dctr, float* __restrict__ scal) {
  __shared__ float fs[sae::kWarps];
  __shared__ double ds[2][sae::kWarps];
  const int j = blockIdx.x;
  if (j < d) {
    const TE* row = E + (size_t)j * n;
    float s = 0.f;
    for (int f = threadIdx.x; f < n; f += sae::kThreads)
      s += sae::widen(row[f]) * dt[f];
    s = sae::block_sum(s, fs);
    if (threadIdx.x == 0) dctr[j] = -s;
  } else {
    double l1 = 0.0, l0 = 0.0;
    for (int f = threadIdx.x; f < n; f += sae::kThreads) {
      l1 += c_totals[f];
      l0 += l0f[f];
    }
    l1 = sae::block_sum(l1, ds[0]);
    l0 = sae::block_sum(l0, ds[1]);
    if (threadIdx.x == 0) {
      scal[0] = (float)l1;
      scal[1] = (float)l0;
    }
  }
}

}  // namespace

// Every entry point takes fp32, contiguous, row-major tensors and launches
// on `stream`; it returns the launch's cudaError_t. One chunk is `rows`
// consecutive batch rows (a multiple of 32); xc and r point at its first
// row. C and G are the [rows, n] workspace. B is the whole batch.

// C [rows, n] = relu(xc [rows, d] . E [d, n] + t [n])
extern "C" int big_sae_bwd_codes(const float* xc, const float* E,
                                 const float* t, float* C, int rows, int n,
                                 int d, void* stream) {
  if (!big_chunk_ok(rows, n, d)) return (int)cudaErrorInvalidValue;
  const CodesEpi epi{t, C, n, aligned16(t, 0, n) && aligned16(C, n, n)};
  return (int)sgemm::run<true, false>(Operand{xc, d, false},
                                      Operand{E, n, aligned16(E, n, n)},
                                      rows, n, d, epi, (cudaStream_t)stream);
}

// G [rows, n] = (coef * r [rows, d] . Wn [n, d]^T + alpha[0] / B) * [C > 0]
extern "C" int big_sae_bwd_dpre(const float* r, const float* Wn,
                                const float* C, const float* alpha, float* G,
                                int rows, int n, int d, int B, float coef,
                                void* stream) {
  if (!big_chunk_ok(rows, n, d) || B < rows) return (int)cudaErrorInvalidValue;
  const DpreEpi epi{C, alpha, G, n,
                    aligned16(C, n, n) && aligned16(G, n, n), coef, (float)B};
  return (int)sgemm::run<true, true>(Operand{r, d, false},
                                     Operand{Wn, d, false}, rows, n, d, epi,
                                     (cudaStream_t)stream);
}

// dE [d, n] = (first ? 0 : dE) + xc [rows, d]^T . G [rows, n]
extern "C" int big_sae_bwd_de(const float* xc, const float* G, float* dE,
                              int rows, int n, int d, int first,
                              void* stream) {
  if (!big_chunk_ok(rows, n, d)) return (int)cudaErrorInvalidValue;
  const AccumEpi epi{dE, n, 0, aligned16(dE, n, n), first != 0, false, 1.f};
  return (int)sgemm::run<false, false>(Operand{xc, d, aligned16(xc, d, d)},
                                       Operand{G, n, aligned16(G, n, n)}, d,
                                       n, rows, epi, (cudaStream_t)stream);
}

// dWn [n, d] = (first ? 0 : dWn) + C [rows, n]^T . r [rows, d], times coef
// when `last`
extern "C" int big_sae_bwd_dwn(const float* C, const float* r, float* dWn,
                               int rows, int n, int d, int first, int last,
                               float coef, void* stream) {
  if (!big_chunk_ok(rows, n, d)) return (int)cudaErrorInvalidValue;
  const AccumEpi epi{dWn, d, 0, aligned16(dWn, d, d), first != 0, last != 0,
                     coef};
  return (int)sgemm::run<false, false>(Operand{C, n, aligned16(C, n, n)},
                                       Operand{r, d, aligned16(r, d, d)}, n,
                                       d, rows, epi, (cudaStream_t)stream);
}

// dt [n] (+)= sum_b G, c_totals [n] (+)= sum_b C, l0f [n] (+)= count(C > 0)
extern "C" int big_sae_bwd_sums(const float* C, const float* G, float* dt,
                                float* c_totals, float* l0f, int rows, int n,
                                int first, void* stream) {
  if (!big_chunk_ok(rows, n, 1)) return (int)cudaErrorInvalidValue;
  sums_kernel<false><<<n / 32, sae::kThreads, 0, (cudaStream_t)stream>>>(
      C, G, nullptr, rows, n, first != 0, dt, nullptr, c_totals, l0f);
  return (int)cudaGetLastError();
}

// dctr [d] = -E [d, n] . dt [n]; scal [2] = (sum c_totals, sum l0f)
extern "C" int big_sae_bwd_dctr(const float* E, const float* dt,
                                const float* c_totals, const float* l0f,
                                float* dctr, float* scal, int n, int d,
                                void* stream) {
  if (!big_chunk_ok(sae::kBatchTile, n, d)) return (int)cudaErrorInvalidValue;
  dctr_kernel<<<d + 1, sae::kThreads, 0, (cudaStream_t)stream>>>(
      E, dt, c_totals, l0f, n, d, dctr, scal);
  return (int)cudaGetLastError();
}

// The bf16 form's entry points: the launches above with bf16 dot operands
// (xb, Eb [d, n], rb, Wnb [n, d], and the workspace's Cb and Gb beside the
// fp32 C and G); the sums read the fp32 values and Gb. d must be a
// multiple of 8 (16-byte copies along it).

// dst [count] = bf16(src): the centered batch's, the raw encoder's, the
// normalized dictionary's and the residual's dot operands
extern "C" int big_sae_bwd_bf16_round(const float* src, sae::bf16* dst,
                                      long long count, void* stream) {
  return (int)sae::launch_round(src, dst, count, (cudaStream_t)stream);
}

// C [rows, n] = relu(xb [rows, d] . Eb [d, n] + t [n]), and Cb = bf16(C)
extern "C" int big_sae_bwd_bf16_codes(const sae::bf16* xb,
                                      const sae::bf16* Eb, const float* t,
                                      float* C, sae::bf16* Cb, int rows,
                                      int n, int d, void* stream) {
  if (!sae::big_chunk_ok_bf16(rows, n, d)) return (int)cudaErrorInvalidValue;
  const sae::CodesEpi<false> epi{
      t, C, n, n, 0,
      aligned16(t, 0, n) && aligned16(C, n, n) && sae::aligned8(Cb, n, n),
      nullptr, Cb};
  return (int)wgemm::run<true, false>(wgemm::Operand{xb, d, 0},
                                      wgemm::Operand{Eb, n, 0}, rows, n, d,
                                      epi, false, (cudaStream_t)stream);
}

// G [rows, n] = (coef * rb [rows, d] . Wnb [n, d]^T + alpha[0] / B)
// * [C > 0], and Gb = bf16(G)
extern "C" int big_sae_bwd_bf16_dpre(const sae::bf16* rb,
                                     const sae::bf16* Wnb, const float* C,
                                     const float* alpha, float* G,
                                     sae::bf16* Gb, int rows, int n, int d,
                                     int B, float coef, void* stream) {
  if (!sae::big_chunk_ok_bf16(rows, n, d) || B < rows)
    return (int)cudaErrorInvalidValue;
  const sae::ScaledDpreEpi epi{
      C, alpha, G, Gb, n, 0,
      aligned16(C, n, n) && aligned16(G, n, n) && sae::aligned8(Gb, n, n),
      coef, (float)B};
  return (int)wgemm::run<true, true>(wgemm::Operand{rb, d, 0},
                                     wgemm::Operand{Wnb, d, 0}, rows, n, d,
                                     epi, true, (cudaStream_t)stream);
}

// dE [d, n] = (first ? 0 : dE) + xb [rows, d]^T . Gb [rows, n]
extern "C" int big_sae_bwd_bf16_de(const sae::bf16* xb, const sae::bf16* Gb,
                                   float* dE, int rows, int n, int d,
                                   int first, void* stream) {
  if (!sae::big_chunk_ok_bf16(rows, n, d)) return (int)cudaErrorInvalidValue;
  const AccumEpi epi{dE, n, 0, aligned16(dE, n, n), first != 0, false, 1.f};
  return (int)wgemm::run<false, false>(wgemm::Operand{xb, d, 0},
                                       wgemm::Operand{Gb, n, 0}, d, n, rows,
                                       epi, first == 0, (cudaStream_t)stream);
}

// dWn [n, d] = (first ? 0 : dWn) + Cb [rows, n]^T . rb [rows, d], times
// coef when `last`
extern "C" int big_sae_bwd_bf16_dwn(const sae::bf16* Cb, const sae::bf16* rb,
                                    float* dWn, int rows, int n, int d,
                                    int first, int last, float coef,
                                    void* stream) {
  if (!sae::big_chunk_ok_bf16(rows, n, d)) return (int)cudaErrorInvalidValue;
  const AccumEpi epi{dWn, d, 0, aligned16(dWn, d, d), first != 0, last != 0,
                     coef};
  return (int)wgemm::run<false, false>(wgemm::Operand{Cb, n, 0},
                                       wgemm::Operand{rb, d, 0}, n, d, rows,
                                       epi, first == 0, (cudaStream_t)stream);
}

// dt [n] (+)= sum_b G, dtb [n] (+)= sum_b Gb, c_totals [n] (+)= sum_b C,
// l0f [n] (+)= count(C > 0)
extern "C" int big_sae_bwd_bf16_sums(const float* C, const float* G,
                                     const sae::bf16* Gb, float* dt,
                                     float* dtb, float* c_totals, float* l0f,
                                     int rows, int n, int first,
                                     void* stream) {
  if (!big_chunk_ok(rows, n, 1)) return (int)cudaErrorInvalidValue;
  sums_kernel<true><<<n / 32, sae::kThreads, 0, (cudaStream_t)stream>>>(
      C, G, Gb, rows, n, first != 0, dt, dtb, c_totals, l0f);
  return (int)cudaGetLastError();
}

// dctr [d] = -Eb [d, n] . dtb [n]; scal [2] = (sum c_totals, sum l0f)
extern "C" int big_sae_bwd_bf16_dctr(const sae::bf16* Eb, const float* dtb,
                                     const float* c_totals, const float* l0f,
                                     float* dctr, float* scal, int n, int d,
                                     void* stream) {
  if (!sae::big_chunk_ok_bf16(sae::kBatchTile, n, d))
    return (int)cudaErrorInvalidValue;
  dctr_kernel<<<d + 1, sae::kThreads, 0, (cudaStream_t)stream>>>(
      Eb, dtb, c_totals, l0f, n, d, dctr, scal);
  return (int)cudaGetLastError();
}
