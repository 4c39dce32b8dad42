// big_sae_bwd — backward of the giant single SAE: every parameter grad,
// the dead-feature tracker's activation mass and the l1/l0 sums in one
// pass, with the [B, n] codes recomputed per tile and never stored.
//
// Replaces: sparse_coding_tpu/ops/fused_big_sae.py::big_sae_backward (the
// Pallas _bwd_kernel).
//
//   pre = xc E_f + t_f (E [d, n] RAW), c = relu(pre), mask = [pre > 0]
//   dpre = (coef * r . Wn_f + alpha/B) * mask,   coef = 2/(B*d)
//   dE[:, f] = xc^T dpre,  dWn_f = coef * c^T r,  dt_f = sum_b dpre,
//   c_totals_f = sum_b c,  l1 = sum c,  l0 = sum mask
//   dctr_enc = -sum_b sum_f dpre[b, f] E[:, f] = -E dt
//
// The last line is the TPU kernel's fifth product (a [Bt, Ft] x [Ft, d]
// product per grid step, summed over the batch) reordered: since
// sum_b dpre[b, f] = dt_f, each block writes -E[:, tile] dt[tile] from its
// own finished dt in its epilogue. Same function, summed in another order,
// and B*n*d fewer multiply-adds.
//
// Bound on an H100: operations. 8*B*n*d fp32 FLOPs dense (pre recomputed,
// r.Wn^T, and the two weight-grad products) against (2*B*d + 2*n*d + n +
// 2*n*d + 2*n + d)*4 bytes; at the trainer's shape (B=65536, n=16384,
// d=1024) that is 8.8 TFLOP = 131 ms at the 67 TFLOP/s fp32 peak vs about
// 1 GB = 0.3 ms at 3.35 TB/s. Two of the four products need only the
// active codes; chip_smoke.py counts those.
//
// Design: one block owns one 16-feature tile and loops over the whole
// batch, 8 rows a step, in a fixed order, so dE/dWn/dt/c_totals
// accumulate in registers with no atomics. The encoder slice E[:, tile]
// (64 KB at d=1024) and the Wn rows (64 KB) stay in shared memory for the
// whole loop; the xc and r rows stream through 8 at a time (32 KB each) —
// the ensemble kernels' 16- and 32-row tiles would not fit beside the two
// weight tiles at d=1024 (193 KB in all, of the 227 KB a block may use).
// Each step, two threads share one (row, feature) pair and each sums half
// of d (the even and the odd columns, which keeps the shared-memory banks
// distinct) for both pre and r.Wn^T, joined by one shuffle; then every
// thread adds the step's rank-8 updates to its dE and dWn columns
// (2 x 16 x NC accumulators). Cross-block values — the centering grad and
// l1/l0 — go to per-feature-tile partial buffers the wrapper sums in a
// fixed order.
#include "sae_common.cuh"

namespace {

using namespace sae;

constexpr int kFt = kBigBwdFeatTile;
constexpr int kRows = kBigBwdRows;
static_assert(2 * kRows * kFt == kThreads,
              "two threads per (batch row, feature) pair");
static_assert(kFt * 2 == 32, "one warp holds one row's 16 features x 2 halves");

// Row stride of the Wn rows in shared memory: = 2 (mod 32), so 16 rows x
// 2 neighbouring columns fall in 32 different banks.
__host__ __device__ inline int wn_ld(int d) { return (d + 31) / 32 * 32 + 2; }

template <int NC>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const float* __restrict__ xc, const float* __restrict__ r,
           const float* __restrict__ E, const float* __restrict__ Wn,
           const float* __restrict__ t, const float* __restrict__ alpha,
           float* __restrict__ dE, float* __restrict__ dWn,
           float* __restrict__ dt, float* __restrict__ c_totals,
           float* __restrict__ dctr_part, float* __restrict__ scal_part,
           int B, int n, int d, int ld, int wld, float coef) {
  extern __shared__ float smem[];
  float* es = smem;                  // [d][kFt]    E[:, f0:f0+16]
  float* ws = es + d * kFt;          // [kFt][wld]  Wn rows f0..f0+15
  float* xs = ws + kFt * wld;        // [kRows][ld] this step's xc rows
  float* rs = xs + kRows * ld;       // [kRows][ld] this step's r rows
  float* cs = rs + kRows * ld;       // [kRows][kFt] codes
  float* ps = cs + kRows * kFt;      // [kRows][kFt] dpre
  float* fs = ps + kRows * kFt;      // [3][kFt] dt, c sums, mask counts

  const int tid = threadIdx.x;
  const int ft = blockIdx.x;
  const int f0 = ft * kFt;
  const float alpha_over_b = alpha[0] / (float)B;

  load_window(es, E + f0, d, kFt, (size_t)n, kFt);  // published by the
  load_tile(ws, Wn + (size_t)f0 * d, kFt, d, wld);  // loop's first sync

  float ge[kFt][NC], gw[kFt][NC];
#pragma unroll
  for (int f = 0; f < kFt; ++f)
#pragma unroll
    for (int k = 0; k < NC; ++k) ge[f][k] = gw[f][k] = 0.f;
  float dt_acc = 0.f, c_acc = 0.f, l0_acc = 0.f;

  // pair ownership: warp -> batch row of the step, lane -> feature
  // (lane & 15) and half (lane >> 4: the even or the odd columns)
  const int row = tid >> 5, fo = tid & 15, half = (tid >> 4) & 1;
  const float tb = t[f0 + fo];
  const float* er = es + fo;         // E[j, f0 + fo] = er[j * kFt]
  const float* wr = ws + fo * wld;

  for (int b0 = 0; b0 < B; b0 += kRows) {
    __syncthreads();  // the previous step's reads of xs/rs/cs/ps are done
    load_tile(xs, xc + (size_t)b0 * d, kRows, d, ld);
    load_tile(rs, r + (size_t)b0 * d, kRows, d, ld);
    __syncthreads();

    const float* xr = xs + row * ld;
    const float* rr = rs + row * ld;
    float p = 0.f, q = 0.f;
#pragma unroll 4
    for (int j = half; j < d; j += 2) {
      p += xr[j] * er[j * kFt];
      q += rr[j] * wr[j];
    }
    p += __shfl_xor_sync(0xffffffffu, p, 16);
    q += __shfl_xor_sync(0xffffffffu, q, 16);
    if (half == 0) {
      const float pre = p + tb;
      const float mk = pre > 0.f ? 1.f : 0.f;
      cs[row * kFt + fo] = relu_keep_nan(pre);
      ps[row * kFt + fo] = (coef * q + alpha_over_b) * mk;
    }
    __syncthreads();

    if (tid < kFt) {
      for (int i = 0; i < kRows; ++i) {
        const float cv = cs[i * kFt + tid];
        dt_acc += ps[i * kFt + tid];
        c_acc += cv;
        l0_acc += cv > 0.f ? 1.f : 0.f;  // c > 0 exactly where pre > 0
      }
    }

    for (int i = 0; i < kRows; ++i) {
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
        const float cv = cs[i * kFt + f];
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          ge[f][k] += dp * xv[k];
          gw[f][k] += cv * rv[k];
        }
      }
    }
  }

  // epilogue: the finished tiles (dE is a column slice of the [d, n]
  // matrix, dWn a row slice of [n, d]), then the per-tile partials
  if (tid < kFt) {
    fs[tid] = dt_acc;
    fs[kFt + tid] = c_acc;
    fs[2 * kFt + tid] = l0_acc;
    dt[f0 + tid] = dt_acc;
    c_totals[f0 + tid] = c_acc;
  }
#pragma unroll
  for (int f = 0; f < kFt; ++f)
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int col = tid + k * kThreads;
      if (col < d) {
        dE[(size_t)col * n + f0 + f] = ge[f][k];
        dWn[(size_t)(f0 + f) * d + col] = coef * gw[f][k];
      }
    }
  __syncthreads();  // fs is published
  for (int j = tid; j < d; j += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int f = 0; f < kFt; ++f) s += es[j * kFt + f] * fs[f];
    dctr_part[(size_t)ft * d + j] = -s;
  }
  if (tid == 0) {
    float l1 = 0.f, l0 = 0.f;
    for (int f = 0; f < kFt; ++f) {
      l1 += fs[kFt + f];
      l0 += fs[2 * kFt + f];
    }
    scal_part[2 * ft] = l1;
    scal_part[2 * ft + 1] = l0;
  }
}

template <int NC>
cudaError_t launch(const float* xc, const float* r, const float* E,
                   const float* Wn, const float* t, const float* alpha,
                   float* dE, float* dWn, float* dt, float* c_totals,
                   float* dctr_part, float* scal_part, int B, int n, int d,
                   float coef, cudaStream_t stream) {
  const int ld = padded_ld(d);
  const int wld = wn_ld(d);
  const size_t smem = sizeof(float) *
      ((size_t)d * kFt + (size_t)kFt * wld + 2 * (size_t)kRows * ld +
       2 * kRows * kFt + 3 * kFt);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bwd_kernel<NC><<<n / kFt, kThreads, smem, stream>>>(
      xc, r, E, Wn, t, alpha, dE, dWn, dt, c_totals, dctr_part, scal_part, B,
      n, d, ld, wld, coef);
  return cudaGetLastError();
}

}  // namespace

// xc [B, d], r [B, d], E [d, n] raw encoder, Wn [n, d] row-normalized,
// t [n], alpha [1] -> dE [d, n], dWn [n, d], dt [n], c_totals [n],
// dctr_part [n/16, d], scal_part [n/16, 2]; all fp32, contiguous.
// coef = 2/(B*d) as fp32. Needs B % 32 == 0, n % 32 == 0, 1 <= d <= 1024
// (the forward's contract). Returns the launch's cudaError_t.
extern "C" int big_sae_bwd(const float* xc, const float* r, const float* E,
                           const float* Wn, const float* t,
                           const float* alpha, float* dE, float* dWn,
                           float* dt, float* c_totals, float* dctr_part,
                           float* scal_part, int B, int n, int d, float coef,
                           void* stream) {
  if (B % kBigBatchTile || n % kBigFeatTile || d < 1 || d > kBigMaxD || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + kThreads - 1) / kThreads) {
    case 1:
      return (int)launch<1>(xc, r, E, Wn, t, alpha, dE, dWn, dt, c_totals,
                            dctr_part, scal_part, B, n, d, coef, s);
    case 2:
      return (int)launch<2>(xc, r, E, Wn, t, alpha, dE, dWn, dt, c_totals,
                            dctr_part, scal_part, B, n, d, coef, s);
    case 3:
      return (int)launch<3>(xc, r, E, Wn, t, alpha, dE, dWn, dt, c_totals,
                            dctr_part, scal_part, B, n, d, coef, s);
    default:
      return (int)launch<4>(xc, r, E, Wn, t, alpha, dE, dWn, dt, c_totals,
                            dctr_part, scal_part, B, n, d, coef, s);
  }
}
