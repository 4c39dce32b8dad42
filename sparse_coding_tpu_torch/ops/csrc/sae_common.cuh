// Shared constants and helpers of the SAE kernels (sm_90a, fp32 SIMT).
//
// The Python wrappers (ops/fused_sae_tiled.py, ops/fused_sae.py,
// ops/fused_big_sae.py) mirror these constants (ops/_build.py); they check
// every shape against them before a launch.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sae {

constexpr int kThreads = 256;             // threads per block, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kBatchTile = 32;            // the batch and a chunk's rows
                                          // divide by this
constexpr int kFeatTile = 32;             // the feature count divides by this
constexpr int kAdamRows = kWarps;         // dictionary rows per adam block
// widest d the ensemble kernels take: the widest d_mlp of the LM presets
// (gpt2-medium, Pythia-410M). Nothing in them scales with d but the
// GEMM template's K loop and the warp-strided row loops of the norm pass
// and the Adam epilogues; their workspace holds codes only.
constexpr int kMaxD = 4096;
// widest d the big-SAE kernels take, the ensemble kernels' for the same
// reason: d is a GEMM extent (K of the codes and dpre products, M or N of
// the decode, de and dwn products) and the grid of dctr (d + 1 blocks);
// their workspace holds codes only, so its chunk rows do not move with d.
constexpr int kBigMaxD = kMaxD;
constexpr float kNormEps = 1e-8f;         // row norms are clipped, not +eps
constexpr int kBf16DMultiple = 8;         // the bf16 forms' d divides by this

// The big-SAE kernels' chunk shapes: `rows` batch rows (a multiple of 32),
// n features (a multiple of 32), 1 <= d <= kBigMaxD (4096).
inline bool big_chunk_ok(int rows, int n, int d) {
  return rows >= 1 && rows % kBatchTile == 0 && n >= 1 &&
         n % kFeatTile == 0 && d >= 1 && d <= kBigMaxD;
}

// The big-SAE kernels' bf16 forms: big_chunk_ok's shapes with d a multiple
// of 8 (the tensor-core product copies 8 bf16 values at a time along every
// operand's contiguous dimension, d among them).
inline bool big_chunk_ok_bf16(int rows, int n, int d) {
  return big_chunk_ok(rows, n, d) && d % kBf16DMultiple == 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fixed-order block sum (xor tree in each warp, then warps 0..7 in order)
// of floats or doubles; the result is valid in thread 0. `scratch` holds
// kWarps values.
template <class T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // a previous call may still be reading scratch
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
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

// Adam moments as stored: fp32, or bf16 (fused_moments_dtype="bfloat16":
// read widened, updated in fp32, stored rounded to nearest even).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// max(sqrt(sum_sq), 1e-8) that keeps NaN, as jnp.clip and torch.clamp do.
__device__ __forceinline__ float clipped_norm(float sum_sq) {
  const float n = sqrtf(sum_sq);
  return (n != n) ? n : fmaxf(n, kNormEps);
}

}  // namespace sae
