// Pieces the chunked kernels share — the two ensemble forwards
// (sae_tied_fwd.cu, sae_untied_fwd.cu, through sae_fwd.cuh), the two
// ensemble backwards (sae_tied_bwd.cu, sae_untied_bwd.cu) and the big
// SAE's forward (big_sae_fwd.cu), whose products run on the GEMM template
// (sgemm_simt.cuh), the ensembles' with the members on the grid's z: the
// row-norm pass, the codes and residual epilogues, the per-feature sums of
// a chunk's codes and dpre, and the loss terms. The bf16-compute forms of
// the six chunked kernels (their products on bgemm_wgmma.cuh) take
// the same pieces with their bf16 stores: the norm pass's bf16
// dictionary, the codes epilogue's bf16 codes, the dpre epilogue's bf16
// copy of dpre, the residual epilogue's bf16 batch, and a rounding pass
// (x, E, r; the big SAE's normalized dictionary).
#pragma once
#include <cuda_bf16.h>

#include "sae_common.cuh"
#include "sgemm_simt.cuh"

namespace sae {

using bf16 = __nv_bfloat16;

// 4 values at (m, n..n+3) of a row-major bf16 matrix, widened to fp32
// (exact); columns at or past N read as 0. vec: one aligned 8-byte load.
__device__ __forceinline__ void load4(const bf16* p, int ld, bool vec, int m,
                                      int n, int N, float (&v)[4]) {
  const bf16* q = p + (size_t)m * ld + n;
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(q);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    v[0] = __low2float(lo), v[1] = __high2float(lo);
    v[2] = __low2float(hi), v[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = n + e < N ? __bfloat162float(q[e]) : 0.f;
  }
}

__device__ __forceinline__ void load4(const float* p, int ld, bool vec, int m,
                                      int n, int N, float (&v)[4]) {
  sgemm::load4(p, ld, vec, m, n, N, v);
}

// 4 values stored at (m, n..n+3) of a row-major bf16 matrix, each rounded
// to nearest even (__float2bfloat16_rn, as torch's and jnp's casts round;
// NaN stays NaN); columns at or past N are not written. vec: one aligned
// 8-byte store.
__device__ __forceinline__ void store4(bf16* p, int ld, bool vec, int m,
                                       int n, int N, const float (&v)[4]) {
  bf16* q = p + (size_t)m * ld + n;
  if (vec) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&lo);
    u.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(q) = u;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < N) q[e] = __float2bfloat16_rn(v[e]);
  }
}

__device__ __forceinline__ void store4(float* p, int ld, bool vec, int m,
                                       int n, int N, const float (&v)[4]) {
  sgemm::store4(p, ld, vec, m, n, N, v);
}

// 8-byte alignment of a bf16 matrix's 4-element groups (base, row stride
// and member stride)
inline bool aligned8(const void* p, int ld, int extent, size_t zs = 0) {
  return ((uintptr_t)p & 7) == 0 && ld % 4 == 0 && extent % 4 == 0 &&
         zs % 4 == 0;
}

// dst[i] = bf16(src[i]), rounded to nearest even: the JAX package's
// .astype(bfloat16) of a dot operand (the batch, the raw untied encoder,
// the residual)
static __global__ void __launch_bounds__(kThreads)
round_bf16_kernel(const float* __restrict__ src, bf16* __restrict__ dst,
                  long long count) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < count; i += (long long)gridDim.x * kThreads)
    dst[i] = __float2bfloat16_rn(src[i]);
}

inline cudaError_t launch_round(const float* src, bf16* dst, long long count,
                                cudaStream_t stream) {
  if (count < 1) return cudaErrorInvalidValue;
  const long long blocks = (count + kThreads - 1) / kThreads;
  round_bf16_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), kThreads, 0,
                      stream>>>(src, dst, count);
  return cudaGetLastError();
}

// One warp per dictionary row: nv = max(sqrt(sum D^2), 1e-8), NaN kept,
// written to nrm[row] and/or Wn's row as D / nv (element by element, as
// torch's D / clamp(norm) rounds) and/or that row rounded to bf16 (the
// bf16 forms' dot operand); any output may be null.
static __global__ void __launch_bounds__(kThreads)
row_norms_kernel(const float* __restrict__ D, int rows, int d,
                 float* __restrict__ nrm, float* __restrict__ wn,
                 bf16* __restrict__ wnb) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* p = D + (size_t)row * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s += p[j] * p[j];
  s = warp_sum(s);
  const float nv = clipped_norm(s);
  if (nrm != nullptr && lane == 0) nrm[row] = nv;
  if (wn != nullptr) {
    float* q = wn + (size_t)row * d;
    for (int j = lane; j < d; j += 32) q[j] = __fdiv_rn(p[j], nv);
  }
  if (wnb != nullptr) {
    bf16* q = wnb + (size_t)row * d;
    for (int j = lane; j < d; j += 32)
      q[j] = __float2bfloat16_rn(__fdiv_rn(p[j], nv));
  }
}

inline cudaError_t launch_row_norms(const float* D, int rows, int d,
                                    float* nrm, float* wn,
                                    cudaStream_t stream,
                                    bf16* wnb = nullptr) {
  if (rows < 1 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  row_norms_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      D, rows, d, nrm, wn, wnb);
  return cudaGetLastError();
}

// The codes of member z from the finished sums of x·E_zᵀ:
// c = relu_keep_nan(acc + b[z][f]) (times cm[z][f] where a coefficient
// mask is given: the masked tied family's), stored at c + z*cz with row
// stride ld.
// FeatMajor = false: the product's rows are batch rows and its columns
// features (C [rows, n]), so the bias and mask run along the 4 columns.
// FeatMajor = true: its rows are features and its columns batch rows
// (Cᵀ [n, rows]), so one bias and one mask value serve the 4. vec:
// 16-byte bias and mask loads (row-major only) and stores (8-byte for the
// bf16 copy). Either store may be null: c the fp32 codes, cb their bf16
// rounding (the bf16 forms' dot operand), at the same offsets.
template <bool FeatMajor>
struct CodesEpi {
  const float* b;  // [Z, n]
  float* c;
  int n;           // features: the bias's and the mask's member stride
  int ld;
  size_t cz;
  bool vec;
  const float* cm = nullptr;  // [Z, n] 0/1, or null for all ones
  bf16* cb = nullptr;
  // the 4 outputs' values of a per-feature [Z, n] vector p
  __device__ void feat4(const float* p, int z, int m, int col, int N,
                        float (&v)[4]) const {
    if constexpr (FeatMajor) {
      const float pm = p[(size_t)z * n + m];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = pm;
    } else {
      sgemm::load4(p + (size_t)z * n, 0, vec, 0, col, N, v);
    }
  }
  __device__ void operator()(int z, int m, int col, int N,
                             float (&v)[4]) const {
    float bv[4];
    feat4(b, z, m, col, N, bv);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = relu_keep_nan(v[e] + bv[e]);
    if (cm != nullptr) {
      float mv[4];
      feat4(cm, z, m, col, N, mv);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __fmul_rn(v[e], mv[e]);
    }
    if (c != nullptr) store4(c + z * cz, ld, vec, m, col, N, v);
    if (cb != nullptr) store4(cb + z * cz, ld, vec, m, col, N, v);
  }
};

// r[z] = acc - x: x [rows, d] shared by every member (fp32, or a bf16
// batch widened exactly), r's members rz elements apart, both with row
// stride ld
template <class TX>
struct ResidEpiOf {
  const TX* x;
  float* r;
  int ld;
  size_t rz;
  bool vec;
  __device__ void operator()(int z, int m, int n, int N,
                             float (&v)[4]) const {
    float xv[4];
    load4(x, ld, vec, m, n, N, xv);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __fsub_rn(v[e], xv[e]);
    sgemm::store4(r + z * rz, ld, vec, m, n, N, v);
  }
};
using ResidEpi = ResidEpiOf<float>;

// dpre from the scaled dot products r . W^T of the tied backward and of
// the bf16 forms of both backwards: G[z] = (coef * acc + alpha[z]/TB) *
// [C[z] > 0], the plain version's operations in its order (no
// contraction into an FMA), stored fp32 (for db) and, where gb is set,
// rounded to bf16 (the bf16 weight-grad products' operand); C is the fp32
// codes, [C > 0] exactly cm [pre > 0].
struct ScaledDpreEpi {
  const float* c;
  const float* alpha;
  float* g;
  bf16* gb;
  int n;
  size_t cz;
  bool vec;
  float coef;
  float total_b;
  __device__ void operator()(int z, int m, int f, int N,
                             float (&v)[4]) const {
    float cv[4];
    load4(c + z * cz, n, vec, m, f, N, cv);
    const float ab = alpha[z] / total_b;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = __fmul_rn(__fadd_rn(__fmul_rn(coef, v[e]), ab),
                       cv[e] > 0.f ? 1.f : 0.f);
    store4(g + z * cz, n, vec, m, f, N, v);
    if (gb != nullptr) store4(gb + z * cz, n, vec, m, f, N, v);
  }
};

// The chunk shapes the chunked ensemble kernels take: Z members of `rows`
// batch rows (a multiple of 32), n features (a multiple of 32),
// 1 <= d <= kMaxD (4096).
inline bool chunk_ok(int Z, int rows, int n, int d) {
  return Z >= 1 && Z <= 65535 && rows >= 1 && rows % kBatchTile == 0 &&
         n >= 1 && n % kFeatTile == 0 && d >= 1 && d <= kMaxD;
}

// The bf16 forms' chunk shapes: chunk_ok's, and d a multiple of 8 (the
// tensor-core product copies 8 bf16 values at a time along every
// operand's contiguous dimension, d among them).
inline bool chunk_ok_bf16(int Z, int rows, int n, int d) {
  return chunk_ok(Z, rows, n, d) && d % kBf16DMultiple == 0;
}

// Block (32 features, member z): warp w sums rows w, w+8, ... of the
// chunk's C and G [Z, rows, n] in order, then warps 0..7 are added in
// order; the first chunk of a member writes db, act, csum [Z, n], later
// ones add. act counts [C > 0], which is the ReLU mask (times the
// coefficient mask, where there is one) and false for a NaN code.
static __global__ void __launch_bounds__(kThreads)
sums_kernel(const float* __restrict__ C, const float* __restrict__ G,
            int rows, int n, bool first, float* __restrict__ db,
            float* __restrict__ act, float* __restrict__ csum) {
  __shared__ float part[3][kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int f = blockIdx.x * 32 + lane;
  const size_t off = (size_t)blockIdx.y * rows * n;
  float sg = 0.f, sc = 0.f, cnt = 0.f;
#pragma unroll 4
  for (int b = w; b < rows; b += kWarps) {
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
    for (int i = 0; i < kWarps; ++i) {
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

inline cudaError_t launch_sums(const float* C, const float* G, float* db,
                               float* act, float* csum, int Z, int rows,
                               int n, bool first, cudaStream_t stream) {
  if (!chunk_ok(Z, rows, n, 1)) return cudaErrorInvalidValue;
  sums_kernel<<<dim3(n / 32, Z), kThreads, 0, stream>>>(C, G, rows, n, first,
                                                        db, act, csum);
  return cudaGetLastError();
}

// Block (slice p of P, member m): part[m][p] = (sum r^2, sum dW1^2 [+
// dW2^2] + db^2) over the slice's share of each array; dW2 may be null
// (the tied backward has one weight grad, the untied one two).
static __global__ void __launch_bounds__(kThreads)
loss_part_kernel(const float* __restrict__ r, const float* __restrict__ dW1,
                 const float* __restrict__ dW2, const float* __restrict__ db,
                 int B, int n, int d, float* __restrict__ part) {
  __shared__ float red[kWarps];
  const int p = blockIdx.x, P = gridDim.x, m = blockIdx.y;
  const size_t len_r = (size_t)B * d, len_w = (size_t)n * d;
  const float* rm = r + m * len_r;
  const float* em = dW1 + m * len_w;
  const float* bm = db + (size_t)m * n;
  float sr = 0.f, sg = 0.f;
  for (size_t i = len_r * p / P + threadIdx.x; i < len_r * (p + 1) / P;
       i += kThreads)
    sr += rm[i] * rm[i];
  if (dW2 != nullptr) {
    const float* wm = dW2 + m * len_w;
    for (size_t i = len_w * p / P + threadIdx.x; i < len_w * (p + 1) / P;
         i += kThreads)
      sg += em[i] * em[i] + wm[i] * wm[i];
  } else {
    for (size_t i = len_w * p / P + threadIdx.x; i < len_w * (p + 1) / P;
         i += kThreads)
      sg += em[i] * em[i];
  }
  for (int i = n * p / P + threadIdx.x; i < n * (p + 1) / P; i += kThreads)
    sg += bm[i] * bm[i];
  sr = block_sum(sr, red);
  sg = block_sum(sg, red);
  if (threadIdx.x == 0) {
    part[((size_t)m * P + p) * 2] = sr;
    part[((size_t)m * P + p) * 2 + 1] = sg;
  }
}

// Block m: the member's loss4 from its P slices (in order) and its
// per-feature c sums and counts (double sums), normalized by the global
// batch TB (the whole batch, or on a data-sharded call the batch of every
// shard together: this call's terms are then partial sums).
static __global__ void __launch_bounds__(kThreads)
loss_final_kernel(const float* __restrict__ part,
                  const float* __restrict__ csum,
                  const float* __restrict__ act,
                  const float* __restrict__ alphas, int P, int TB, int n,
                  int d, float* __restrict__ loss4) {
  __shared__ double red[2][kWarps];
  const int m = blockIdx.x;
  double l1 = 0.0, l0 = 0.0;
  for (int f = threadIdx.x; f < n; f += kThreads) {
    l1 += csum[(size_t)m * n + f];
    l0 += act[(size_t)m * n + f];
  }
  l1 = block_sum(l1, red[0]);
  l0 = block_sum(l0, red[1]);
  if (threadIdx.x == 0) {
    float sr = 0.f, sg = 0.f;
    for (int p = 0; p < P; ++p) {
      sr += part[((size_t)m * P + p) * 2];
      sg += part[((size_t)m * P + p) * 2 + 1];
    }
    const float batch_f = (float)TB;
    loss4[m * 4] = sr / (float)((long long)TB * d);
    loss4[m * 4 + 1] = alphas[m] * (float)l1 / batch_f;
    loss4[m * 4 + 2] = (float)l0 / batch_f;
    loss4[m * 4 + 3] = sg;
  }
}

// loss4 [N, 4] = [sum r^2 / (TB*d), alpha * sum c / TB, sum act / TB,
// sum dW1^2 (+ sum dW2^2) + sum db^2] per member, from r [N, B, d]
// (TB >= B the global batch), the
// finished dW1 (and dW2, or null) [N, n, d], db, act, csum [N, n] and
// alphas [N]; part is an [N, P, 2] scratch (P slices a member, summed in
// order).
inline cudaError_t launch_loss(const float* r, const float* dW1,
                               const float* dW2, const float* db,
                               const float* act, const float* csum,
                               const float* alphas, float* part,
                               float* loss4, int N, int B, int TB, int n,
                               int d, int P, cudaStream_t stream) {
  if (!chunk_ok(N, B, n, d) || TB < B || P < 1 || P > 65535)
    return cudaErrorInvalidValue;
  loss_part_kernel<<<dim3(P, N), kThreads, 0, stream>>>(r, dW1, dW2, db, B,
                                                        n, d, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  loss_final_kernel<<<N, kThreads, 0, stream>>>(part, csum, act, alphas, P,
                                                TB, n, d, loss4);
  return cudaGetLastError();
}

}  // namespace sae
