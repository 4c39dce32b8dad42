// sae_untied_adam_vjp — the untied whole-step epilogue: exact optax Adam on
// the raw encoder, the normalization VJP then Adam on the raw decoder, and
// the per-member update sum of squares.
//
// Replaces: sparse_coding_tpu/ops/fused_sae.py::fused_adam_vjp_update (the
// Pallas _adam_vjp_kernel).
//
//   encoder:  mu' = b1 mu + (1-b1) dE,  nu' = b2 nu + (1-b2) dE^2
//             u = -lr (mu'/bc1) / (sqrt(nu'/bc2) + eps),  E' = E + u
//   decoder:  n = max(||D_row||, 1e-8), w = D/n, dD = (dWn - w <dWn, w>) / n
//             then the same Adam step on D with dD
//   un_part[m, blk] = sum over the block's rows of u_E^2 + u_D^2
//
// bc1/bc2 arrive precomputed per member (1 - beta^count), as the engine
// computes them for optax's scale_by_adam with eps_root=0. The bias rows
// stay outside, in torch (ensemble._bias_adam_update).
//
// Bound on an H100: bytes. 14*N*n*d*4 bytes (E, dE, mu_E, nu_E, D, dWn,
// mu_D, nu_D read; E', mu_E', nu_E', D', mu_D', nu_D' written) against
// ~36 FLOPs per element pair; at the canonical shape 1.88 GB = 0.56 ms at
// 3.35 TB/s vs 1.2 GFLOP = 0.02 ms.
//
// Design: sae_tied_adam_vjp's. One block per (member, 8-row tile), one warp
// per row. The decoder row's reductions (norm, radial term) are warp
// shuffles; the element pass re-reads D and dWn from L1, so device memory
// sees each tensor once. The per-member update sum of squares lands as
// fixed-order per-block partials ([N, n/8]) that the wrapper sums in a
// fixed order.
//
// bf16 moments (sae_untied_adam_vjp_bf16, fused_moments_dtype="bfloat16"):
// the encoder's and decoder's mu and nu are read as bf16 and widened,
// updated in fp32, and stored rounded; each update uses this step's fp32
// moments (sparse_coding_tpu/ops/fused_sae.py _adam_vjp_kernel). Bound:
// (6*4 + 8*2)*N*n*d bytes = 1.34 GB = 0.40 ms at the canonical shape.
#include "sae_common.cuh"

namespace {

using namespace sae;

struct AdamHypers {
  float lr, bc1, bc2, b1, omb1, b2, omb2, eps;
};

// One row of Adam over d elements for this lane's columns; returns the
// lane's sum of u^2. With `vjp` the gradient is the normalization VJP of g
// against the row p (clipped row norm `norm`, radial term `rad`).
template <class TM>
__device__ __forceinline__ float adam_row(
    const float* __restrict__ p, const float* __restrict__ g,
    const TM* __restrict__ mu, const TM* __restrict__ nu,
    float* __restrict__ p2, TM* __restrict__ mu2, TM* __restrict__ nu2,
    int d, const AdamHypers& h, bool vjp, float norm, float rad) {
  const int lane = threadIdx.x & 31;
  float u_sq = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float pv = p[j];
    float gv = g[j];
    if (vjp) gv = (gv - (pv / norm) * rad) / norm;
    const float m1 = h.b1 * widen(mu[j]) + h.omb1 * gv;
    const float v1 = h.b2 * widen(nu[j]) + h.omb2 * gv * gv;
    const float u = -h.lr * (m1 / h.bc1) / (sqrtf(v1 / h.bc2) + h.eps);
    p2[j] = pv + u;
    mu2[j] = narrow<TM>(m1);
    nu2[j] = narrow<TM>(v1);
    u_sq += u * u;
  }
  return u_sq;
}

template <class TM>
__global__ void __launch_bounds__(kThreads)
adam_vjp_kernel(const float* __restrict__ E, const float* __restrict__ dE,
                const TM* __restrict__ muE, const TM* __restrict__ nuE,
                const float* __restrict__ D, const float* __restrict__ dWn,
                const TM* __restrict__ muD, const TM* __restrict__ nuD,
                const float* __restrict__ lrs, const float* __restrict__ bc1s,
                const float* __restrict__ bc2s, float* __restrict__ E2,
                TM* __restrict__ muE2, TM* __restrict__ nuE2,
                float* __restrict__ D2, TM* __restrict__ muD2,
                TM* __restrict__ nuD2, float* __restrict__ un_part, int n,
                int d, float b1, float omb1, float b2, float omb2, float eps) {
  __shared__ float red[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.y;
  const int row = blockIdx.x * kAdamRows + warp;
  const size_t off = ((size_t)m * n + row) * d;
  const AdamHypers h{lrs[m], bc1s[m], bc2s[m], b1, omb1, b2, omb2, eps};

  // encoder: plain Adam on the raw rows
  float u_sq = adam_row(E + off, dE + off, muE + off, nuE + off, E2 + off,
                        muE2 + off, nuE2 + off, d, h, false, 1.f, 0.f);

  // decoder: dL/dWn -> dL/dD through the row normalization, then Adam
  float s = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = D[off + j];
    s += v * v;
  }
  const float norm = clipped_norm(warp_sum(s));
  float rad = 0.f;
  for (int j = lane; j < d; j += 32) rad += dWn[off + j] * (D[off + j] / norm);
  rad = warp_sum(rad);
  u_sq += adam_row(D + off, dWn + off, muD + off, nuD + off, D2 + off,
                   muD2 + off, nuD2 + off, d, h, true, norm, rad);

  const float t = block_sum(u_sq, red);
  if (threadIdx.x == 0) un_part[(size_t)m * gridDim.x + blockIdx.x] = t;
}

}  // namespace

// E, dE, muE, nuE, D, dWn, muD, nuD [N, n, d]; lrs, bc1, bc2 [N] ->
// E2, muE2, nuE2, D2, muD2, nuD2 [N, n, d], un_part [N, n/8]. All fp32,
// contiguous; n % 8 == 0. omb1/omb2 are (1 - b1)/(1 - b2) rounded to fp32
// by the caller, as the Pallas kernel's weak-typed Python constants are.
// Returns the launch's cudaError_t.
template <class TM>
static int launch(const float* E, const float* dE, const TM* muE,
                  const TM* nuE, const float* D, const float* dWn,
                  const TM* muD, const TM* nuD, const float* lrs,
                  const float* bc1, const float* bc2, float* E2, TM* muE2,
                  TM* nuE2, float* D2, TM* muD2, TM* nuD2, float* un_part,
                  int N, int n, int d, float b1, float omb1, float b2,
                  float omb2, float eps, void* stream) {
  if (n % kAdamRows || d < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / kAdamRows, N);
  adam_vjp_kernel<TM><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      E, dE, muE, nuE, D, dWn, muD, nuD, lrs, bc1, bc2, E2, muE2, nuE2, D2,
      muD2, nuD2, un_part, n, d, b1, omb1, b2, omb2, eps);
  return (int)cudaGetLastError();
}

extern "C" int sae_untied_adam_vjp(
    const float* E, const float* dE, const float* muE, const float* nuE,
    const float* D, const float* dWn, const float* muD, const float* nuD,
    const float* lrs, const float* bc1, const float* bc2, float* E2,
    float* muE2, float* nuE2, float* D2, float* muD2, float* nuD2,
    float* un_part, int N, int n, int d, float b1, float omb1, float b2,
    float omb2, float eps, void* stream) {
  return launch(E, dE, muE, nuE, D, dWn, muD, nuD, lrs, bc1, bc2, E2, muE2,
                nuE2, D2, muD2, nuD2, un_part, N, n, d, b1, omb1, b2, omb2,
                eps, stream);
}

// The same with the four moments in and out bf16.
extern "C" int sae_untied_adam_vjp_bf16(
    const float* E, const float* dE, const __nv_bfloat16* muE,
    const __nv_bfloat16* nuE, const float* D, const float* dWn,
    const __nv_bfloat16* muD, const __nv_bfloat16* nuD, const float* lrs,
    const float* bc1, const float* bc2, float* E2, __nv_bfloat16* muE2,
    __nv_bfloat16* nuE2, float* D2, __nv_bfloat16* muD2,
    __nv_bfloat16* nuD2, float* un_part, int N, int n, int d, float b1,
    float omb1, float b2, float omb2, float eps, void* stream) {
  return launch(E, dE, muE, nuE, D, dWn, muD, nuD, lrs, bc1, bc2, E2, muE2,
                nuE2, D2, muD2, nuD2, un_part, N, n, d, b1, omb1, b2, omb2,
                eps, stream);
}
