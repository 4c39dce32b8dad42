// sae_untied_bwd — backward of the feature-tiled untied SAE: exact
// gradients wrt the raw encoder and the normalized decoder, feature
// activity, loss partials and the sentinel's grad sum of squares.
//
// Replaces: sparse_coding_tpu/ops/fused_sae_tiled.py::_bwd_call (the Pallas
// _bwd_kernel, tied=False); with sae_untied_fwd it also carries the untiled
// contract of fused_sae.py::fused_untied_sae_grads (_untied_kernel).
//
//   pre = x E_f^T + b_f (E RAW), c = relu(pre), mask = [pre > 0]
//   Wn = D / max(||D||_row, 1e-8)
//   dpre = (coef * r Wn_f^T + alpha/B) * mask,   coef = 2/(B*d)
//   dE_f = dpre^T x,  dWn_f = coef * c^T r,  db_f = sum_b dpre,
//   act_f = sum_b mask
//   partials per (member, feature tile): [mse (feature tile 0 only), l1, l0,
//   sum dE_f^2 + sum dWn_f^2 + sum db_f^2]
//
// Bound on an H100: operations. 8*N*B*n*d fp32 FLOPs dense (the code tile
// is recomputed, then three more products) against (B*d + N*B*d + 4*N*n*d
// + 3*N*n)*4 bytes; at the canonical shape 550 GFLOP = 8.2 ms at the
// 67 TFLOP/s fp32 peak vs 0.68 GB = 0.2 ms at 3.35 TB/s. Three of the four
// products need only the active codes; chip_smoke.py counts those.
//
// Design: the tied backward's, with two weight tiles. One block owns one
// (member, 16-row feature tile) and loops over the batch in 16-row steps in
// a fixed order, so dE/dWn/db/activity accumulate in registers with no
// atomics. The raw encoder tile (for pre) and the normalized decoder tile
// (for r.Wn^T) both stay in shared memory for the whole loop; the feature
// tile is 16 rows, half the tied kernel's, so the two tiles plus the x and
// r rows fit (~199 KB at d=768) and the two register accumulators (2 x 16
// rows x NC columns per thread) cost what the tied kernel's one 32-row
// accumulator does. Each step loads the x and r rows, forms pre and r.Wn^T
// (one (row, feature) pair per thread), then adds the step's rank-16
// updates to the thread's dE and dWn columns. Per-block loss partials go
// to an [N, n/16, 4] buffer the wrapper reduces in a fixed order.
#include "sae_common.cuh"

namespace {

using namespace sae;

constexpr int kFt = kUntiedFeatTile;
static_assert(kFt * kBwdBatchTile == kThreads,
              "one (batch row, feature) pair per thread");

template <int NC>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const float* __restrict__ x, const float* __restrict__ r,
           const float* __restrict__ E, const float* __restrict__ D,
           const float* __restrict__ bias, const float* __restrict__ alphas,
           float* __restrict__ dE, float* __restrict__ dWn,
           float* __restrict__ db, float* __restrict__ act,
           float* __restrict__ part, int B, int n, int d, int ld, float coef) {
  extern __shared__ float smem[];
  float* es = smem;                                  // [kFt][ld] raw E
  float* ws = es + kFt * ld;                         // [kFt][ld] Wn
  float* xs = ws + kFt * ld;                         // [kBwdBatchTile][ld]
  float* rs = xs + kBwdBatchTile * ld;               // [kBwdBatchTile][ld]
  float* cs = rs + kBwdBatchTile * ld;               // [kBwdBatchTile][kFt]
  float* ps = cs + kBwdBatchTile * kFt;              // [kBwdBatchTile][kFt]
  float* nrm = ps + kBwdBatchTile * kFt;             // [kFt]
  float* red = nrm + kFt;                            // [kWarps]

  const int tid = threadIdx.x;
  const int m = blockIdx.y;
  const int ft = blockIdx.x;
  const int f0 = ft * kFt;
  const float alpha = alphas[m];
  const float batch_f = (float)B;
  const float alpha_over_b = alpha / batch_f;
  const float* rm = r + (size_t)m * B * d;
  const size_t tile_off = ((size_t)m * n + f0) * d;

  load_tile(es, E + tile_off, kFt, d, ld);  // published by the syncs below
  load_normalized_tile(ws, nrm, D + tile_off, kFt, d, ld);

  float ge[kFt][NC], gw[kFt][NC];
#pragma unroll
  for (int f = 0; f < kFt; ++f)
#pragma unroll
    for (int k = 0; k < NC; ++k) ge[f][k] = gw[f][k] = 0.f;
  float db_acc = 0.f, act_acc = 0.f, c_acc = 0.f, r_sq = 0.f;

  // pre / r.Wn^T ownership: batch row `row` x feature `fo`
  const int row = tid / kFt, fo = tid % kFt;
  const float bb = bias[(size_t)m * n + f0 + fo];
  const float* er = es + fo * ld;
  const float* wr = ws + fo * ld;

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
    float p = 0.f, q = 0.f;
    for (int j = 0; j < d; ++j) {
      p += xr[j] * er[j];
      q += rr_[j] * wr[j];
    }
    p += bb;
    const float mk = p > 0.f ? 1.f : 0.f;
    cs[row * kFt + fo] = relu_keep_nan(p);
    ps[row * kFt + fo] = (coef * q + alpha_over_b) * mk;
    __syncthreads();

    if (tid < kFt) {
      for (int i = 0; i < kBwdBatchTile; ++i) {
        const float cv = cs[i * kFt + tid];
        db_acc += ps[i * kFt + tid];
        c_acc += cv;
        act_acc += cv > 0.f ? 1.f : 0.f;  // c > 0 exactly where pre > 0
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
      for (int f = 0; f < kFt; ++f) {
        const float dp = ps[i * kFt + f];
        const float cc = coef * cs[i * kFt + f];
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          ge[f][k] += dp * xv[k];
          gw[f][k] += cc * rv[k];
        }
      }
    }
  }

  // epilogue: the finished gradient tiles and their sum of squares (the
  // sentinel's grad norm, folded in here as _bwd_kernel's _gnorm does)
  float g_sq = 0.f;
  float* dem = dE + tile_off;
  float* dwm = dWn + tile_off;
#pragma unroll
  for (int f = 0; f < kFt; ++f)
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int col = tid + k * kThreads;
      if (col < d) {
        dem[(size_t)f * d + col] = ge[f][k];
        dwm[(size_t)f * d + col] = gw[f][k];
        g_sq += ge[f][k] * ge[f][k] + gw[f][k] * gw[f][k];
      }
    }
  if (tid < kFt) {
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
    float* pp = part + ((size_t)m * gridDim.x + ft) * 4;
    pp[0] = t_mse / (float)((long long)B * d);
    pp[1] = alpha * t_c / batch_f;
    pp[2] = t_l0 / batch_f;
    pp[3] = t_g;
  }
}

template <int NC>
cudaError_t launch(const float* x, const float* r, const float* E,
                   const float* D, const float* b, const float* alphas,
                   float* dE, float* dWn, float* db, float* act, float* part,
                   int N, int B, int n, int d, float coef,
                   cudaStream_t stream) {
  const int ld = padded_ld(d);
  const size_t smem = sizeof(float) *
      ((size_t)(2 * kFt + 2 * kBwdBatchTile) * ld +
       2 * kBwdBatchTile * kFt + kFt + kWarps);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kFt, N);
  bwd_kernel<NC><<<grid, kThreads, smem, stream>>>(
      x, r, E, D, b, alphas, dE, dWn, db, act, part, B, n, d, ld, coef);
  return cudaGetLastError();
}

}  // namespace

// x [B, d], r [N, B, d], E [N, n, d] raw encoder, D [N, n, d] raw decoder,
// b [N, n], alphas [N] -> dE, dWn [N, n, d], db [N, n], act [N, n],
// part [N, n/16, 4]; all fp32, contiguous. coef = 2/(B*d) as fp32. Needs
// B % 32 == 0, n % 32 == 0, 1 <= d <= 768 (the tied kernels' contract).
// Returns the launch's cudaError_t.
extern "C" int sae_untied_bwd(const float* x, const float* r, const float* E,
                              const float* D, const float* b,
                              const float* alphas, float* dE, float* dWn,
                              float* db, float* act, float* part, int N,
                              int B, int n, int d, float coef, void* stream) {
  if (B % kFwdBatchTile || n % kFeatTile || d < 1 || d > kMaxD || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + kThreads - 1) / kThreads) {
    case 1:
      return (int)launch<1>(x, r, E, D, b, alphas, dE, dWn, db, act, part, N,
                            B, n, d, coef, s);
    case 2:
      return (int)launch<2>(x, r, E, D, b, alphas, dE, dWn, db, act, part, N,
                            B, n, d, coef, s);
    default:
      return (int)launch<3>(x, r, E, D, b, alphas, dE, dWn, db, act, part, N,
                            B, n, d, coef, s);
  }
}
