// sae_tied_bwd — backward of the feature-tiled tied SAE: exact parameter
// gradients, feature activity, loss partials and the sentinel's grad sum of
// squares.
//
// Replaces: sparse_coding_tpu/ops/fused_sae_tiled.py::_bwd_call (the Pallas
// _bwd_kernel, tied=True).
//
//   pre = x W_f^T + b_f, c = cm_f relu(pre), mask = cm_f [pre > 0]
//   (cm [N, n] the masked family's 0/1 coefficient mask, or nullptr for
//   all ones: the Pallas kernel's masked=True branch)
//   dpre = (coef * r W_f^T + alpha/B) * mask,   coef = 2/(B*d)
//   dW_f = dpre^T x + coef * c^T r,  db_f = sum_b dpre,  act_f = sum_b mask
//   partials per (member, feature tile): [mse (feature tile 0 only), l1, l0,
//   sum dW_f^2 + sum db_f^2]
//
// Bound on an H100: operations. 8*N*B*n*d fp32 FLOPs (the code tile is
// recomputed, then three more products) against (B*d + N*B*d + N*n*d + N*n
// + N*n*d + 2*N*n)*4 bytes; at the canonical shape 550 GFLOP = 8.2 ms at
// the 67 TFLOP/s fp32 peak vs 0.3 GB = 0.09 ms at 3.35 TB/s.
//
// Design: one block owns one (member, 32-row feature tile) and loops over
// the batch in 16-row steps in a fixed order, so dW/db/activity accumulate
// in registers with no atomics — bitwise-resumable runs need fixed-order
// sums, not float atomics. The normalized feature tile stays in shared
// memory for the whole loop; each step loads the x and r rows, forms pre
// and r.W^T (2 rows x 2 features per thread), then adds the step's rank-16
// update to the thread's dW columns. Per-block loss partials go to an
// [N, n/32, 4] buffer the wrapper reduces in a fixed order.
#include "sae_common.cuh"

namespace {

using namespace sae;

template <int NC>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const float* __restrict__ x, const float* __restrict__ r,
           const float* __restrict__ E, const float* __restrict__ bias,
           const float* __restrict__ cmask,
           const float* __restrict__ alphas, float* __restrict__ dw,
           float* __restrict__ db, float* __restrict__ act,
           float* __restrict__ part, int B, int n, int d, int ld, float coef) {
  extern __shared__ float smem[];
  float* ws = smem;                                  // [kFeatTile][ld]
  float* xs = ws + kFeatTile * ld;                   // [kBwdBatchTile][ld]
  float* rs = xs + kBwdBatchTile * ld;               // [kBwdBatchTile][ld]
  float* cs = rs + kBwdBatchTile * ld;               // [kBwdBatchTile][kFeatTile]
  float* ps = cs + kBwdBatchTile * kFeatTile;        // [kBwdBatchTile][kFeatTile]
  float* nrm = ps + kBwdBatchTile * kFeatTile;       // [kFeatTile]
  float* red = nrm + kFeatTile;                      // [kWarps]

  const int tid = threadIdx.x;
  const int m = blockIdx.y;
  const int ft = blockIdx.x;
  const int f0 = ft * kFeatTile;
  const float alpha = alphas[m];
  const float batch_f = (float)B;
  const float alpha_over_b = alpha / batch_f;
  const float* rm = r + (size_t)m * B * d;

  load_normalized_tile(ws, nrm, E + ((size_t)m * n + f0) * d, kFeatTile, d,
                       ld);

  float g[kFeatTile][NC];
#pragma unroll
  for (int f = 0; f < kFeatTile; ++f)
#pragma unroll
    for (int k = 0; k < NC; ++k) g[f][k] = 0.f;
  float db_acc = 0.f, act_acc = 0.f, c_acc = 0.f, r_sq = 0.f;

  // pre / r.W^T ownership: row `row` x features 2cp, 2cp+1
  const int row = tid >> 4, cp = tid & 15;
  const float bb0 = bias[(size_t)m * n + f0 + 2 * cp];
  const float bb1 = bias[(size_t)m * n + f0 + 2 * cp + 1];
  // times 1 is exact (NaN stays NaN), so the unmasked case needs no branch
  const float cm0 = cmask == nullptr ? 1.f : cmask[(size_t)m * n + f0 + 2 * cp];
  const float cm1 =
      cmask == nullptr ? 1.f : cmask[(size_t)m * n + f0 + 2 * cp + 1];
  const float* wa = ws + (2 * cp) * ld;
  const float* wb = wa + ld;

  for (int b0 = 0; b0 < B; b0 += kBwdBatchTile) {
    __syncthreads();  // the previous step's reads of xs/rs/cs/ps are done
    load_tile(xs, x + (size_t)b0 * d, kBwdBatchTile, d, ld);
    const float* rsrc = rm + (size_t)b0 * d;
    for (int i = tid; i < kBwdBatchTile * d; i += kThreads) {
      const int rr = i / d;
      const float v = rsrc[i];
      rs[rr * ld + (i - rr * d)] = v;
      r_sq += v * v;
    }
    __syncthreads();

    const float* xr = xs + row * ld;
    const float* rr_ = rs + row * ld;
    float p0 = 0.f, p1 = 0.f, q0 = 0.f, q1 = 0.f;
    for (int j = 0; j < d; ++j) {
      const float xv = xr[j], rv = rr_[j], w0 = wa[j], w1 = wb[j];
      p0 += xv * w0;
      p1 += xv * w1;
      q0 += rv * w0;
      q1 += rv * w1;
    }
    p0 += bb0;
    p1 += bb1;
    const float m0 = (p0 > 0.f ? 1.f : 0.f) * cm0;
    const float m1 = (p1 > 0.f ? 1.f : 0.f) * cm1;
    float* c0 = cs + row * kFeatTile + 2 * cp;
    float* d0 = ps + row * kFeatTile + 2 * cp;
    c0[0] = relu_keep_nan(p0) * cm0;
    c0[1] = relu_keep_nan(p1) * cm1;
    d0[0] = (coef * q0 + alpha_over_b) * m0;
    d0[1] = (coef * q1 + alpha_over_b) * m1;
    __syncthreads();

    if (tid < kFeatTile) {
      for (int i = 0; i < kBwdBatchTile; ++i) {
        const float cv = cs[i * kFeatTile + tid];
        db_acc += ps[i * kFeatTile + tid];
        c_acc += cv;
        // c > 0 exactly where mask = 1 (pre > 0 and, masked, cm = 1)
        act_acc += cv > 0.f ? 1.f : 0.f;
      }
    }

    for (int i = 0; i < kBwdBatchTile; ++i) {
      float xv[NC], rv[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int col = tid + k * kThreads;
        xv[k] = col < d ? xs[i * ld + col] : 0.f;
        rv[k] = col < d ? rs[i * ld + col] : 0.f;
      }
#pragma unroll
      for (int f = 0; f < kFeatTile; ++f) {
        const float dp = ps[i * kFeatTile + f];
        const float cc = coef * cs[i * kFeatTile + f];
#pragma unroll
        for (int k = 0; k < NC; ++k) g[f][k] += dp * xv[k] + cc * rv[k];
      }
    }
  }

  // epilogue: the finished gradient tile, its sum of squares (the
  // sentinel's grad norm, folded in here as _bwd_kernel's _gnorm does)
  float g_sq = 0.f;
  float* dwm = dw + ((size_t)m * n + f0) * d;
#pragma unroll
  for (int f = 0; f < kFeatTile; ++f)
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int col = tid + k * kThreads;
      if (col < d) {
        dwm[(size_t)f * d + col] = g[f][k];
        g_sq += g[f][k] * g[f][k];
      }
    }
  if (tid < kFeatTile) {
    db[(size_t)m * n + f0 + tid] = db_acc;
    act[(size_t)m * n + f0 + tid] = act_acc;
    g_sq += db_acc * db_acc;
  } else {
    c_acc = 0.f;
    act_acc = 0.f;
  }
  // mse counts once per batch row: only the feature-tile-0 blocks add it
  const float t_mse = block_sum(ft == 0 ? r_sq : 0.f, red);
  const float t_c = block_sum(c_acc, red);
  const float t_l0 = block_sum(act_acc, red);
  const float t_g = block_sum(g_sq, red);
  if (tid == 0) {
    float* p = part + ((size_t)m * gridDim.x + ft) * 4;
    p[0] = t_mse / (float)((long long)B * d);
    p[1] = alpha * t_c / batch_f;
    p[2] = t_l0 / batch_f;
    p[3] = t_g;
  }
}

template <int NC>
cudaError_t launch(const float* x, const float* r, const float* E,
                   const float* b, const float* cm, const float* alphas,
                   float* dw, float* db,
                   float* act, float* part, int N, int B, int n, int d,
                   float coef, cudaStream_t stream) {
  const int ld = padded_ld(d);
  const size_t smem = sizeof(float) *
      ((size_t)(kFeatTile + 2 * kBwdBatchTile) * ld +
       2 * kBwdBatchTile * kFeatTile + kFeatTile + kWarps);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kFeatTile, N);
  bwd_kernel<NC><<<grid, kThreads, smem, stream>>>(
      x, r, E, b, cm, alphas, dw, db, act, part, B, n, d, ld, coef);
  return cudaGetLastError();
}

}  // namespace

// x [B, d], r [N, B, d], E [N, n, d], b [N, n], cm [N, n] or nullptr,
// alphas [N] ->
// dw [N, n, d], db [N, n], act [N, n], part [N, n/32, 4]; all fp32,
// contiguous. coef = 2/(B*d) as fp32. Needs B % 32 == 0, n % 32 == 0,
// 1 <= d <= 768. Returns the launch's cudaError_t.
extern "C" int sae_tied_bwd(const float* x, const float* r, const float* E,
                            const float* b, const float* cm,
                            const float* alphas, float* dw,
                            float* db, float* act, float* part, int N, int B,
                            int n, int d, float coef, void* stream) {
  if (B % kFwdBatchTile || n % kFeatTile || d < 1 || d > kMaxD || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + kThreads - 1) / kThreads) {
    case 1:
      return (int)launch<1>(x, r, E, b, cm, alphas, dw, db, act, part, N, B,
                            n, d, coef, s);
    case 2:
      return (int)launch<2>(x, r, E, b, cm, alphas, dw, db, act, part, N, B,
                            n, d, coef, s);
    default:
      return (int)launch<3>(x, r, E, b, cm, alphas, dw, db, act, part, N, B,
                            n, d, coef, s);
  }
}
