// sae_tied_fwd — forward of the feature-tiled tied SAE, with the residual
// as its epilogue.
//
// Replaces: sparse_coding_tpu/ops/fused_sae_tiled.py::_fwd_call (the Pallas
// _fwd_kernel, tied=True) AND the XLA residual pass after it
// (tiled_tied_sae_grads: resid = xhat - x).
//
//   r[m, b, :] = sum_f relu(x[b] . W_f + b_f) W_f  -  x[b]
//   W = E / max(||E||_row, 1e-8)
//
// Bound on an H100: operations. 4*N*B*n*d fp32 FLOPs (two products) against
// (B*d + N*n*d + N*n + N*B*d)*4 bytes; at the canonical shape (N=32,
// B=2048, n=2048, d=512) that is 275 GFLOP = 4.1 ms at the 67 TFLOP/s fp32
// (non-tensor) peak vs 0.14 GB = 0.04 ms at 3.35 TB/s. Tensor cores are out:
// TF32 would break compute_dtype="float32".
//
// Design: one block owns one (member, 32-row batch tile) output tile and
// loops over ALL feature tiles inside the block — the loop replaces the
// TPU's sequential grid axis, so the x-hat sum needs no atomics and its
// order is fixed. The codes never leave shared memory. Per feature tile the
// block loads 32 dictionary rows, normalizes them in shared memory (clip,
// as _normalize_tile), forms the [32, 32] code tile (2x2 outputs per
// thread) and accumulates x-hat in registers (each thread owns columns
// tid, tid+256, ... of all 32 rows). Shared memory rows are padded to an
// odd stride so column walks are bank-conflict free. Simple SIMT first;
// wgmma/TMA are later work.
#include "sae_common.cuh"

namespace {

using namespace sae;

template <int NC>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ x, const float* __restrict__ E,
           const float* __restrict__ bias, float* __restrict__ r,
           int B, int n, int d, int ld) {
  extern __shared__ float smem[];
  float* xs = smem;                                // [kFwdBatchTile][ld]
  float* ws = xs + kFwdBatchTile * ld;             // [kFeatTile][ld]
  float* cs = ws + kFeatTile * ld;                 // [kFwdBatchTile][kFeatTile]
  float* nrm = cs + kFwdBatchTile * kFeatTile;     // [kFeatTile]

  const int tid = threadIdx.x;
  const int m = blockIdx.y;
  const int b0 = blockIdx.x * kFwdBatchTile;
  const float* Em = E + (size_t)m * n * d;
  const float* bm = bias + (size_t)m * n;

  load_tile(xs, x + (size_t)b0 * d, kFwdBatchTile, d, ld);

  float acc[kFwdBatchTile][NC];
#pragma unroll
  for (int i = 0; i < kFwdBatchTile; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[i][k] = 0.f;

  // code-tile ownership: rows 2rp, 2rp+1 x features 2cp, 2cp+1
  const int rp = tid >> 4, cp = tid & 15;
  const float* xa = xs + (2 * rp) * ld;
  const float* xb = xa + ld;

  for (int f0 = 0; f0 < n; f0 += kFeatTile) {
    __syncthreads();  // every read of the previous tile's ws/cs is done
    load_normalized_tile(ws, nrm, Em + (size_t)f0 * d, d, ld);

    const float* wa = ws + (2 * cp) * ld;
    const float* wb = wa + ld;
    float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;
    for (int j = 0; j < d; ++j) {
      const float a0 = xa[j], a1 = xb[j], w0 = wa[j], w1 = wb[j];
      p00 += a0 * w0;
      p01 += a0 * w1;
      p10 += a1 * w0;
      p11 += a1 * w1;
    }
    const float bb0 = bm[f0 + 2 * cp], bb1 = bm[f0 + 2 * cp + 1];
    float* c0 = cs + (2 * rp) * kFeatTile + 2 * cp;
    c0[0] = relu_keep_nan(p00 + bb0);
    c0[1] = relu_keep_nan(p01 + bb1);
    c0[kFeatTile] = relu_keep_nan(p10 + bb0);
    c0[kFeatTile + 1] = relu_keep_nan(p11 + bb1);
    __syncthreads();

#pragma unroll 4
    for (int f = 0; f < kFeatTile; ++f) {
      float w[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int col = tid + k * kThreads;
        w[k] = col < d ? ws[f * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kFwdBatchTile; ++i) {
        const float cv = cs[i * kFeatTile + f];
#pragma unroll
        for (int k = 0; k < NC; ++k) acc[i][k] += cv * w[k];
      }
    }
  }

  // epilogue: the residual, written once (the XLA pass it replaces read
  // x-hat and x and wrote r)
  float* rm = r + ((size_t)m * B + b0) * d;
#pragma unroll
  for (int i = 0; i < kFwdBatchTile; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int col = tid + k * kThreads;
      if (col < d) rm[(size_t)i * d + col] = acc[i][k] - xs[i * ld + col];
    }
}

template <int NC>
cudaError_t launch(const float* x, const float* E, const float* b, float* r,
                   int N, int B, int n, int d, cudaStream_t stream) {
  const int ld = padded_ld(d);
  const size_t smem = sizeof(float) *
      ((size_t)(kFwdBatchTile + kFeatTile) * ld +
       kFwdBatchTile * kFeatTile + kFeatTile);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B / kFwdBatchTile, N);
  fwd_kernel<NC><<<grid, kThreads, smem, stream>>>(x, E, b, r, B, n, d, ld);
  return cudaGetLastError();
}

}  // namespace

// x [B, d], E [N, n, d], b [N, n] -> r [N, B, d]; all fp32, contiguous.
// Needs B % 32 == 0, n % 32 == 0, 1 <= d <= 768 (checked by the wrapper,
// and again here). Returns the launch's cudaError_t.
extern "C" int sae_tied_fwd(const float* x, const float* E, const float* b,
                            float* r, int N, int B, int n, int d,
                            void* stream) {
  if (B % kFwdBatchTile || n % kFeatTile || d < 1 || d > kMaxD || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + kThreads - 1) / kThreads) {
    case 1: return (int)launch<1>(x, E, b, r, N, B, n, d, s);
    case 2: return (int)launch<2>(x, E, b, r, N, B, n, d, s);
    default: return (int)launch<3>(x, E, b, r, N, B, n, d, s);
  }
}
