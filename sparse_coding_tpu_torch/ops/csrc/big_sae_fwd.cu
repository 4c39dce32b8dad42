// big_sae_fwd — forward of the giant single SAE: the reconstruction x-hat,
// with the [B, n] codes never stored.
//
// Replaces: sparse_coding_tpu/ops/fused_big_sae.py::big_sae_forward (the
// Pallas _fwd_kernel).
//
//   x-hat[b, :] = sum_f relu(xc[b] . E[:, f] + t_f) Wn_f
//   E [d, n] raw encoder (the JAX layout, read here with row stride n),
//   Wn [n, d] the row-normalized dictionary (formed by the wrapper)
//
// Bound on an H100: operations. 4*B*n*d fp32 FLOPs dense (the encode and
// decode products) against (2*B*d + 2*n*d + n)*4 bytes; at the trainer's
// shape (B=65536, n=16384, d=1024) that is 4.4 TFLOP = 66 ms at the
// 67 TFLOP/s fp32 (non-tensor) peak vs 0.67 GB = 0.2 ms at 3.35 TB/s. The
// decode product needs only the active codes; chip_smoke.py counts those.
// Tensor cores are out: TF32 would break compute_dtype="float32".
//
// Design: one block owns a 32-row batch tile and loops over ALL 32-feature
// tiles in order, so the x-hat sum has a fixed order and needs no atomics;
// x-hat stays in registers (each thread owns columns tid, tid+256, ... of
// the 32 rows). At d=1024 the xc tile alone is 128 KB, so the weights
// stream through one 32 KB buffer: per feature tile, the encoder slice
// E[j0:j0+256, f0:f0+32] chunk by chunk while every thread accumulates a
// 2x2 block of the [32, 32] pre-activation tile; then the tile's Wn rows,
// 8 at a time, for the decode. 164 KB of shared memory at d=1024, one
// block per SM. Simple SIMT; cp.async/TMA double buffering and wgmma
// are later work.
#include "sae_common.cuh"

namespace {

using namespace sae;

constexpr int kBt = kBigBatchTile;
constexpr int kFt = kBigFeatTile;
constexpr int kDc = 256;                  // encoder rows per streamed chunk
constexpr int kWr = 8;                    // Wn rows per streamed chunk
constexpr int kBuf = kDc * kFt;           // floats of the streaming buffer
static_assert(kWr * kBigMaxD == kBuf, "one buffer serves both streams");
static_assert(kBt * kFt == 4 * kThreads, "a 2x2 code block per thread");

template <int NC>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ xc, const float* __restrict__ E,
           const float* __restrict__ Wn, const float* __restrict__ t,
           float* __restrict__ xhat, int n, int d, int ld) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [kBt][ld] the xc tile
  float* buf = xs + kBt * ld;       // [kDc][kFt] E chunk, or [kWr][d] Wn rows
  float* cs = buf + kBuf;           // [kBt][kFt] the code tile

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kBt;
  load_tile(xs, xc + (size_t)b0 * d, kBt, d, ld);  // published by the syncs below

  float acc[kBt][NC];
#pragma unroll
  for (int i = 0; i < kBt; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[i][k] = 0.f;

  // code-tile ownership: rows 2rp, 2rp+1 x features 2cp, 2cp+1
  const int rp = tid >> 4, cp = tid & 15;
  const float* xa = xs + (2 * rp) * ld;
  const float* xb = xa + ld;

  for (int f0 = 0; f0 < n; f0 += kFt) {
    float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;
    for (int j0 = 0; j0 < d; j0 += kDc) {
      const int dc = min(kDc, d - j0);
      __syncthreads();  // every read of buf (and, at j0 = 0, of cs) is done
      load_window(buf, E + (size_t)j0 * n + f0, dc, kFt, (size_t)n, kFt);
      __syncthreads();
      const float* xa_j = xa + j0;
      const float* xb_j = xb + j0;
#pragma unroll 4
      for (int jj = 0; jj < dc; ++jj) {
        const float2 w = *reinterpret_cast<const float2*>(buf + jj * kFt + 2 * cp);
        const float a0 = xa_j[jj], a1 = xb_j[jj];
        p00 += a0 * w.x;
        p01 += a0 * w.y;
        p10 += a1 * w.x;
        p11 += a1 * w.y;
      }
    }
    const float t0 = t[f0 + 2 * cp], t1 = t[f0 + 2 * cp + 1];
    float* c0 = cs + (2 * rp) * kFt + 2 * cp;
    c0[0] = relu_keep_nan(p00 + t0);
    c0[1] = relu_keep_nan(p01 + t1);
    c0[kFt] = relu_keep_nan(p10 + t0);
    c0[kFt + 1] = relu_keep_nan(p11 + t1);

    for (int r0 = 0; r0 < kFt; r0 += kWr) {
      __syncthreads();  // buf reads done; at r0 = 0 this publishes cs
      load_tile(buf, Wn + (size_t)(f0 + r0) * d, kWr, d, d);
      __syncthreads();
#pragma unroll 2
      for (int f = 0; f < kWr; ++f) {
        float w[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int col = tid + k * kThreads;
          w[k] = col < d ? buf[f * d + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kBt; ++i) {
          const float cv = cs[i * kFt + r0 + f];
#pragma unroll
          for (int k = 0; k < NC; ++k) acc[i][k] += cv * w[k];
        }
      }
    }
  }

  float* out = xhat + (size_t)b0 * d;
#pragma unroll
  for (int i = 0; i < kBt; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int col = tid + k * kThreads;
      if (col < d) out[(size_t)i * d + col] = acc[i][k];
    }
}

template <int NC>
cudaError_t launch(const float* xc, const float* E, const float* Wn,
                   const float* t, float* xhat, int B, int n, int d,
                   cudaStream_t stream) {
  const int ld = padded_ld(d);
  const size_t smem = sizeof(float) * ((size_t)kBt * ld + kBuf + kBt * kFt);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<NC><<<B / kBt, kThreads, smem, stream>>>(xc, E, Wn, t, xhat, n,
                                                      d, ld);
  return cudaGetLastError();
}

}  // namespace

// xc [B, d], E [d, n], Wn [n, d] (row-normalized), t [n] -> xhat [B, d];
// all fp32, contiguous. Needs B % 32 == 0, n % 32 == 0, 1 <= d <= 1024
// (checked by the wrapper, and again here). Returns the launch's
// cudaError_t.
extern "C" int big_sae_fwd(const float* xc, const float* E, const float* Wn,
                           const float* t, float* xhat, int B, int n, int d,
                           void* stream) {
  if (B % kBt || n % kFt || d < 1 || d > kBigMaxD || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + kThreads - 1) / kThreads) {
    case 1: return (int)launch<1>(xc, E, Wn, t, xhat, B, n, d, s);
    case 2: return (int)launch<2>(xc, E, Wn, t, xhat, B, n, d, s);
    case 3: return (int)launch<3>(xc, E, Wn, t, xhat, B, n, d, s);
    default: return (int)launch<4>(xc, E, Wn, t, xhat, B, n, d, s);
  }
}
