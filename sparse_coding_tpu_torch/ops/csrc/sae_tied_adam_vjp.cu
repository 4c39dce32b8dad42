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
//   un_part[m, blk] = sum over the block's rows of u^2
//
// bc1/bc2 arrive precomputed per member (1 - beta^count), as the engine
// computes them for optax's scale_by_adam with eps_root=0.
//
// Bound on an H100: bytes. 7*N*n*d*4 bytes (E, dW, mu, nu read; E', mu',
// nu' written) against ~20 FLOPs per element; at the canonical shape
// 0.94 GB = 0.28 ms at 3.35 TB/s vs 0.67 GFLOP = 0.01 ms.
//
// Design: one block per (member, 8-row tile), one warp per row. The row
// reductions (norm, radial term) are warp shuffles; the element pass
// re-reads E and dW from L1, so device memory sees each tensor once.
// The per-member update sum of squares lands as fixed-order per-block
// partials ([N, n/8]) that the wrapper sums in a fixed order.
#include "sae_common.cuh"

namespace {

using namespace sae;

__global__ void __launch_bounds__(kThreads)
adam_vjp_kernel(const float* __restrict__ E, const float* __restrict__ dW,
                const float* __restrict__ mu, const float* __restrict__ nu,
                const float* __restrict__ lrs, const float* __restrict__ bc1s,
                const float* __restrict__ bc2s, float* __restrict__ E2,
                float* __restrict__ mu2, float* __restrict__ nu2,
                float* __restrict__ un_part,
                const float* __restrict__ bias, const float* __restrict__ db,
                const float* __restrict__ mub, const float* __restrict__ nub,
                float* __restrict__ bias2, float* __restrict__ mub2,
                float* __restrict__ nub2, int n, int d, float b1, float omb1,
                float b2, float omb2, float eps) {
  __shared__ float red[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.y;
  const int row = blockIdx.x * kAdamRows + warp;
  const size_t off = ((size_t)m * n + row) * d;
  const float lr = lrs[m], bc1 = bc1s[m], bc2 = bc2s[m];

  float s = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float e = E[off + j];
    s += e * e;
  }
  const float norm = clipped_norm(warp_sum(s));
  float rad = 0.f;
  for (int j = lane; j < d; j += 32) rad += dW[off + j] * (E[off + j] / norm);
  rad = warp_sum(rad);

  float u_sq = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float e = E[off + j];
    const float w = e / norm;
    const float g = (dW[off + j] - w * rad) / norm;
    const float m1 = b1 * mu[off + j] + omb1 * g;
    const float v1 = b2 * nu[off + j] + omb2 * g * g;
    const float u = -lr * (m1 / bc1) / (sqrtf(v1 / bc2) + eps);
    E2[off + j] = e + u;
    mu2[off + j] = m1;
    nu2[off + j] = v1;
    u_sq += u * u;
  }

  if (bias != nullptr && lane == 0) {
    const size_t i = (size_t)m * n + row;
    const float g = db[i];
    const float mb = b1 * mub[i] + omb1 * g;
    const float vb = b2 * nub[i] + omb2 * g * g;
    bias2[i] = bias[i] - lr * (mb / bc1) / (sqrtf(vb / bc2) + eps);
    mub2[i] = mb;
    nub2[i] = vb;
  }

  const float t = block_sum(u_sq, red);
  if (threadIdx.x == 0) un_part[(size_t)m * gridDim.x + blockIdx.x] = t;
}

}  // namespace

// E, dW, mu, nu [N, n, d]; lrs, bc1, bc2 [N] -> E2, mu2, nu2 [N, n, d],
// un_part [N, n/8]. The bias group (bias, db, mub, nub -> bias2, mub2, nub2,
// all [N, n]) is all null or all set. All fp32, contiguous; n % 8 == 0.
// omb1/omb2 are (1 - b1)/(1 - b2) rounded to fp32 by the caller, as the
// Pallas kernels' weak-typed Python constants are. Returns cudaError_t.
extern "C" int sae_tied_adam_vjp(
    const float* E, const float* dW, const float* mu, const float* nu,
    const float* lrs, const float* bc1, const float* bc2, float* E2,
    float* mu2, float* nu2, float* un_part, const float* bias,
    const float* db, const float* mub, const float* nub, float* bias2,
    float* mub2, float* nub2, int N, int n, int d, float b1, float omb1,
    float b2, float omb2, float eps, void* stream) {
  if (n % kAdamRows || d < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / kAdamRows, N);
  adam_vjp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      E, dW, mu, nu, lrs, bc1, bc2, E2, mu2, nu2, un_part, bias, db, mub, nub,
      bias2, mub2, nub2, n, d, b1, omb1, b2, omb2, eps);
  return (int)cudaGetLastError();
}
