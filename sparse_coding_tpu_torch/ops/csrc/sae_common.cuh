// Shared constants and helpers of the tied-SAE kernels (sm_90a, fp32 SIMT).
//
// The Python wrappers (ops/fused_sae_tiled.py, ops/fused_sae.py) mirror
// these constants; they check every shape against them before a launch.
#pragma once
#include <cuda_runtime.h>

namespace sae {

constexpr int kThreads = 256;             // threads per block, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kFwdBatchTile = 32;         // rows of x one forward block owns
constexpr int kFeatTile = 32;             // dictionary rows per feature tile
constexpr int kBwdBatchTile = 16;         // rows of x per backward loop step
constexpr int kAdamRows = kWarps;         // dictionary rows per adam block
constexpr int kMaxD = 3 * kThreads;       // widest d the fwd/bwd kernels take
constexpr float kNormEps = 1e-8f;         // row norms are clipped, not +eps

// Shared-memory row stride: odd, so 32 lanes walking one column of 32
// different rows hit 32 different banks.
__host__ __device__ inline int padded_ld(int d) { return (d % 2 == 0) ? d + 1 : d; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fixed-order block sum (xor tree in each warp, then warps 0..7 in order);
// the result is valid in thread 0. `scratch` holds kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  __syncthreads();  // a previous call may still be reading scratch
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) s += scratch[w];
  }
  return s;
}

// ReLU that keeps NaN, as jnp.maximum(pre, 0) and torch.relu do
// (fmaxf would turn a NaN into 0 and hide it from the sentinel).
__device__ __forceinline__ float relu_keep_nan(float p) {
  return (p > 0.f || p != p) ? p : 0.f;
}

// max(sqrt(sum_sq), 1e-8) that keeps NaN, as jnp.clip and torch.clamp do.
__device__ __forceinline__ float clipped_norm(float sum_sq) {
  const float n = sqrtf(sum_sq);
  return (n != n) ? n : fmaxf(n, kNormEps);
}

// Copy a row-major [rows, d] global tile into shared memory (row stride ld).
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int rows, int d, int ld) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d;
    dst[r * ld + (i - r * d)] = src[i];
  }
}

// Load a [kFeatTile, d] dictionary tile and row-normalize it in place:
// w = e / max(||e||, 1e-8), the formula of the Pallas kernels'
// _normalize_tile. `nrm` holds kFeatTile floats.
__device__ __forceinline__ void load_normalized_tile(float* ws, float* nrm,
                                                     const float* __restrict__ src,
                                                     int d, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_tile(ws, src, kFeatTile, d, ld);
  __syncthreads();
  for (int row = warp; row < kFeatTile; row += kWarps) {
    float s = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float v = ws[row * ld + j];
      s += v * v;
    }
    s = warp_sum(s);
    if (lane == 0) nrm[row] = clipped_norm(s);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kFeatTile * d; i += kThreads) {
    const int r = i / d;
    ws[r * ld + (i - r * d)] /= nrm[r];
  }
  __syncthreads();
}

}  // namespace sae
