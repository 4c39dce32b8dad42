// sae_tied_adam_vjp — normalization VJP + exact optax Adam on the tied
// dictionary, the per-member update sum of squares, and (optionally) the
// bias rows' Adam step.
//
// Replaces: sparse_coding_tpu/ops/fused_sae.py::fused_tied_adam_vjp_update
// (the Pallas _tied_adam_vjp_kernel), and the update epilogue of
// fused_tied_sae_train_step (_tied_train_kernel's _update, which also
// steps the bias; pass the bias pointers for that).
//
//   n = max(||E_row||, 1e-8), w = E/n, dE = (dW - w <dW, w>) / n
//   mu' = b1 mu + (1-b1) dE,  nu' = b2 nu + (1-b2) dE^2
//   u = -lr (mu'/bc1) / (sqrt(nu'/bc2) + eps),  E' = E + u
//   un_part[m, row] = sum over the row of u^2
//
// bc1/bc2 arrive precomputed per member (1 - beta^count), as the engine
// computes them for optax's scale_by_adam with eps_root=0.
//
// Bound on an H100: bytes. 7*N*n*d*4 bytes (E, dW, mu, nu read; E', mu',
// nu' written) against ~20 FLOPs per element; at the canonical shape
// 0.94 GB = 0.28 ms at 3.35 TB/s vs 0.67 GFLOP = 0.01 ms.
//
// Design: one pass, vector loads. A row of E is spread over row_threads =
// 32, 64, 128 or 256 threads (one to eight warps: the fewest that leave a
// thread at most kHeld = 16 of the row's elements, 256 at d = kMaxD =
// 4096); a block of 256 threads takes 256 / row_threads rows of one
// member. Each thread holds its elements of E and dW in registers from the
// first read to the element pass: the row's two reductions (the clipped
// norm, then <dW, w>) are warp shuffles and, across the row's warps, a
// fixed-order sum through shared memory; the element pass then reads only
// mu and nu. So device memory sees E, dW, mu and nu read once and E', mu'
// and nu' written once. (Re-reading E and dW in each pass counts on L1,
// which 8 rows of 2-16 KB a block, several blocks an SM, overflow: the
// re-reads then go to L2, and the time per byte grows with d.)
// A thread's elements come in units of 4 consecutive elements, unit k of
// thread t at element (t + k * row_threads) * 4, so a warp's loads cover
// contiguous bytes: one 16-byte float4 of each fp32 tensor, 8 bytes of
// bf16 moments. (Units of 8 — a 16-byte uint4 of bf16 moments, two float4
// of E, dW and E' 32 bytes apart, streaming loads — took 0.281 ms against
// 0.268 at the canonical shape and 2.25 against 2.02 at 16 x 8192 x 2048
// on an H100 SXM; scripts/time_kernel_parts.py --only adam.) Where a row
// does not start on its load's width in every tensor (d % 4 != 0, or a
// base pointer off it) the same layout loads and stores one element at a
// time.
// A d past kMaxD (the wrapper takes any d) keeps the first kHeld elements
// a thread in registers and reads the rest of the row again in each pass.
// The per-member update sum of squares lands as one fixed-order partial a
// row ([N, n]) that the wrapper sums in a fixed order, so two calls give
// the same bits.
//
// bf16 moments (sae_tied_adam_vjp_bf16, fused_moments_dtype="bfloat16"):
// mu and nu are read as bf16 and widened, updated in fp32, and stored
// rounded; the update uses this step's fp32 moments, not the rounded ones
// (sparse_coding_tpu/ops/fused_sae.py _tied_train_kernel, _update). The
// bias moments stay fp32. Bound: (3*4 + 4*2)*N*n*d bytes = 0.67 GB =
// 0.20 ms at the canonical shape.
#include <cstdint>

#include "sae_common.cuh"

namespace {

using namespace sae;
using bf16 = __nv_bfloat16;

constexpr int kHeld = 16;  // elements of E (and of dW) a thread holds

// a thread's unit: 4 consecutive elements, one float4 of each fp32 tensor
// and 8 bytes of bf16 moments
constexpr int kUnit = 4;

// the threads of a row: the fewest warps (1, 2, 4 or 8) that leave each
// thread at most kHeld of its elements
inline int row_threads_for(int d) {
  int t = 32;
  while (t < kThreads && t * kHeld < d) t *= 2;
  return t;
}

// v = p[j0 .. j0 + U), j0 < d: U / 4 float4 loads where Vec (the unit lies
// within the row), else one element at a time, reading 0 past d
template <bool Vec, int U>
__device__ __forceinline__ void load_unit(const float* __restrict__ p,
                                          int j0, int d, float (&v)[U]) {
  if constexpr (Vec) {
#pragma unroll
    for (int h = 0; h < U / 4; ++h) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + j0) + h);
      v[4 * h] = f.x;
      v[4 * h + 1] = f.y;
      v[4 * h + 2] = f.z;
      v[4 * h + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < U; ++i) v[i] = j0 + i < d ? p[j0 + i] : 0.f;
  }
}

// the same for 4 bf16 moments, widened (exact: a bf16 is the top 16 bits
// of its fp32 value); Vec: one 8-byte load
template <bool Vec, int U>
__device__ __forceinline__ void load_unit(const bf16* __restrict__ p, int j0,
                                          int d, float (&v)[U]) {
  if constexpr (Vec) {
    static_assert(U == 4, "4 bf16 a unit");
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p + j0));
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < U; ++i)
      v[i] = j0 + i < d ? __bfloat162float(p[j0 + i]) : 0.f;
  }
}

template <bool Vec, int U>
__device__ __forceinline__ void store_unit(float* __restrict__ p, int j0,
                                           int d, const float (&v)[U]) {
  if constexpr (Vec) {
#pragma unroll
    for (int h = 0; h < U / 4; ++h)
      __stcs(reinterpret_cast<float4*>(p + j0) + h,
             make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2],
                         v[4 * h + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (j0 + i < d) p[j0 + i] = v[i];
  }
}

// 4 bf16 moments, each rounded to nearest even; Vec: one 8-byte store
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
}

template <bool Vec, int U>
__device__ __forceinline__ void store_unit(bf16* __restrict__ p, int j0,
                                           int d, const float (&v)[U]) {
  if constexpr (Vec) {
    static_assert(U == 4, "4 bf16 a unit");
    __stcs(reinterpret_cast<uint2*>(p + j0),
           make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])));
  } else {
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (j0 + i < d) p[j0 + i] = __float2bfloat16_rn(v[i]);
  }
}

// A row's sum of v over its threads: each warp's shuffle sum, then the
// row's warps in order through `part` (a slot a warp of the block). Every
// thread of the row gets the same bits. The whole block calls it at once.
__device__ __forceinline__ float row_sum(float v, float* part,
                                         int row_warps) {
  v = warp_sum(v);
  if (row_warps == 1) return v;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  __syncthreads();
  const int w0 = warp - warp % row_warps;
  float s = 0.f;
  for (int w = 0; w < row_warps; ++w) s += part[w0 + w];
  return s;
}

struct Hypers {
  float lr, bc1, bc2, b1, omb1, b2, omb2, eps, norm, rad;
};

// The element pass over one unit at j0 < d of a row whose E and dW values
// are e and g: the normalization VJP, Adam on this step's fp32 moments,
// E', mu' and nu' stored; returns the unit's sum of u^2.
template <bool Vec, class TM, int U>
__device__ __forceinline__ float step_unit(
    const float (&e)[U], const float (&g)[U], int j0, int d,
    const TM* __restrict__ mu, const TM* __restrict__ nu,
    float* __restrict__ E2, TM* __restrict__ mu2, TM* __restrict__ nu2,
    const Hypers& h) {
  float m1[U], v1[U], e2[U];
  load_unit<Vec>(mu, j0, d, m1);
  load_unit<Vec>(nu, j0, d, v1);
  float u_sq = 0.f;
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const float w = e[i] / h.norm;
    const float gv = (g[i] - w * h.rad) / h.norm;
    m1[i] = h.b1 * m1[i] + h.omb1 * gv;
    v1[i] = h.b2 * v1[i] + h.omb2 * gv * gv;
    const float u = -h.lr * (m1[i] / h.bc1) / (sqrtf(v1[i] / h.bc2) + h.eps);
    e2[i] = e[i] + u;
    if (Vec || j0 + i < d) u_sq += u * u;
  }
  store_unit<Vec>(E2, j0, d, e2);
  store_unit<Vec>(mu2, j0, d, m1);
  store_unit<Vec>(nu2, j0, d, v1);
  return u_sq;
}

template <class TM, bool Vec>
__global__ void __launch_bounds__(kThreads)
adam_vjp_kernel(const float* __restrict__ E, const float* __restrict__ dW,
                const TM* __restrict__ mu, const TM* __restrict__ nu,
                const float* __restrict__ lrs, const float* __restrict__ bc1s,
                const float* __restrict__ bc2s, float* __restrict__ E2,
                TM* __restrict__ mu2, TM* __restrict__ nu2,
                float* __restrict__ un_part,
                const float* __restrict__ bias, const float* __restrict__ db,
                const float* __restrict__ mub, const float* __restrict__ nub,
                float* __restrict__ bias2, float* __restrict__ mub2,
                float* __restrict__ nub2, int n, int d, int row_threads,
                float b1, float omb1, float b2, float omb2, float eps) {
  constexpr int U = kUnit, kHeldUnits = kHeld / U;
  __shared__ float red[3][kWarps];
  const int t = threadIdx.x % row_threads, row_warps = row_threads >> 5;
  const int m = blockIdx.y;
  const int row = blockIdx.x * (kThreads / row_threads) +
                  threadIdx.x / row_threads;
  const size_t off = ((size_t)m * n + row) * d;
  E += off, dW += off, mu += off, nu += off, E2 += off, mu2 += off,
      nu2 += off;
  const int stride = row_threads * U;  // from a thread's unit to its next
  const int beyond = t * U + kHeldUnits * stride;  // its first unit not held
  Hypers h{lrs[m], bc1s[m], bc2s[m], b1, omb1, b2, omb2, eps, 0.f, 0.f};

  float e[kHeldUnits][U], g[kHeldUnits][U];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kHeldUnits; ++k) {
    const int j0 = t * U + k * stride;
    if (j0 < d) {
      load_unit<Vec>(E, j0, d, e[k]);
      load_unit<Vec>(dW, j0, d, g[k]);
    } else {
#pragma unroll
      for (int i = 0; i < U; ++i) e[k][i] = g[k][i] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kHeldUnits; ++k)
#pragma unroll
    for (int i = 0; i < U; ++i) s += e[k][i] * e[k][i];
  for (int j0 = beyond; j0 < d; j0 += stride) {
    float ev[U];
    load_unit<Vec>(E, j0, d, ev);
#pragma unroll
    for (int i = 0; i < U; ++i) s += ev[i] * ev[i];
  }
  h.norm = clipped_norm(row_sum(s, red[0], row_warps));

  float rad = 0.f;
#pragma unroll
  for (int k = 0; k < kHeldUnits; ++k)
#pragma unroll
    for (int i = 0; i < U; ++i) rad += g[k][i] * (e[k][i] / h.norm);
  for (int j0 = beyond; j0 < d; j0 += stride) {
    float ev[U], gv[U];
    load_unit<Vec>(E, j0, d, ev);
    load_unit<Vec>(dW, j0, d, gv);
#pragma unroll
    for (int i = 0; i < U; ++i) rad += gv[i] * (ev[i] / h.norm);
  }
  h.rad = row_sum(rad, red[1], row_warps);

  float u_sq = 0.f;
#pragma unroll
  for (int k = 0; k < kHeldUnits; ++k) {
    const int j0 = t * U + k * stride;
    if (j0 < d) u_sq += step_unit<Vec>(e[k], g[k], j0, d, mu, nu, E2, mu2,
                                       nu2, h);
  }
  for (int j0 = beyond; j0 < d; j0 += stride) {
    float ev[U], gv[U];
    load_unit<Vec>(E, j0, d, ev);
    load_unit<Vec>(dW, j0, d, gv);
    u_sq += step_unit<Vec>(ev, gv, j0, d, mu, nu, E2, mu2, nu2, h);
  }

  if (bias != nullptr && t == 0) {
    const size_t i = (size_t)m * n + row;
    const float gb = db[i];
    const float mb = b1 * mub[i] + omb1 * gb;
    const float vb = b2 * nub[i] + omb2 * gb * gb;
    bias2[i] = bias[i] - h.lr * (mb / h.bc1) / (sqrtf(vb / h.bc2) + eps);
    mub2[i] = mb;
    nub2[i] = vb;
  }

  const float us = row_sum(u_sq, red[2], row_warps);
  if (t == 0) un_part[(size_t)m * n + row] = us;
}

// a unit of an operand starts on its load's width: 16 bytes for fp32, 8 for
// bf16 (with d % 4 == 0 every row then does too)
template <class T>
inline bool aligned(const T* p) {
  return ((uintptr_t)p & (kUnit * sizeof(T) - 1)) == 0;
}

}  // namespace

// E, dW, mu, nu [N, n, d]; lrs, bc1, bc2 [N] -> E2, mu2, nu2 [N, n, d],
// un_part [N, n]. The bias group (bias, db, mub, nub -> bias2, mub2, nub2,
// all [N, n]) is all null or all set. All fp32, contiguous; n % 8 == 0.
// omb1/omb2 are (1 - b1)/(1 - b2) rounded to fp32 by the caller, as the
// Pallas kernels' weak-typed Python constants are. Returns cudaError_t.
template <class TM>
static int launch(const float* E, const float* dW, const TM* mu,
                  const TM* nu, const float* lrs, const float* bc1,
                  const float* bc2, float* E2, TM* mu2, TM* nu2,
                  float* un_part, const float* bias, const float* db,
                  const float* mub, const float* nub, float* bias2,
                  float* mub2, float* nub2, int N, int n, int d, float b1,
                  float omb1, float b2, float omb2, float eps,
                  void* stream) {
  if (n % kAdamRows || d < 1 || N < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const int row_threads = row_threads_for(d);
  const dim3 grid(n / (kThreads / row_threads), N);
  const bool vec = d % kUnit == 0 && aligned(E) && aligned(dW) &&
                   aligned(mu) && aligned(nu) && aligned(E2) &&
                   aligned(mu2) && aligned(nu2);
  auto kernel =
      vec ? &adam_vjp_kernel<TM, true> : &adam_vjp_kernel<TM, false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      E, dW, mu, nu, lrs, bc1, bc2, E2, mu2, nu2, un_part, bias, db, mub, nub,
      bias2, mub2, nub2, n, d, row_threads, b1, omb1, b2, omb2, eps);
  return (int)cudaGetLastError();
}

extern "C" int sae_tied_adam_vjp(
    const float* E, const float* dW, const float* mu, const float* nu,
    const float* lrs, const float* bc1, const float* bc2, float* E2,
    float* mu2, float* nu2, float* un_part, const float* bias,
    const float* db, const float* mub, const float* nub, float* bias2,
    float* mub2, float* nub2, int N, int n, int d, float b1, float omb1,
    float b2, float omb2, float eps, void* stream) {
  return launch(E, dW, mu, nu, lrs, bc1, bc2, E2, mu2, nu2, un_part, bias,
                db, mub, nub, bias2, mub2, nub2, N, n, d, b1, omb1, b2, omb2,
                eps, stream);
}

// The same with mu, nu, mu2 and nu2 bf16 (the bias group stays fp32).
extern "C" int sae_tied_adam_vjp_bf16(
    const float* E, const float* dW, const __nv_bfloat16* mu,
    const __nv_bfloat16* nu, const float* lrs, const float* bc1,
    const float* bc2, float* E2, __nv_bfloat16* mu2, __nv_bfloat16* nu2,
    float* un_part, const float* bias, const float* db, const float* mub,
    const float* nub, float* bias2, float* mub2, float* nub2, int N, int n,
    int d, float b1, float omb1, float b2, float omb2, float eps,
    void* stream) {
  return launch(E, dW, mu, nu, lrs, bc1, bc2, E2, mu2, nu2, un_part, bias,
                db, mub, nub, bias2, mub2, nub2, N, n, d, b1, omb1, b2, omb2,
                eps, stream);
}
