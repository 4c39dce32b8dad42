// sgemm_simt.cuh — a register-tiled fp32 matrix product on the CUDA cores
// (sm_90a) with a pluggable epilogue: out[m, n] = epi(sum_k A(m,k) B(k,n)).
//
// True fp32, no TF32: wgmma has no fp32-input form (its nearest is TF32,
// ~10 mantissa bits), so the CUDA cores' FMA rate — 67 TFLOP/s on an H100
// SXM — is the ceiling for compute_dtype="float32".
//
// Blocking: one 256-thread block owns a 128x128 output tile and walks K in
// steps of 8. Each thread owns an 8x8 register micro-tile (rows ty*4+{0..3}
// and 64+ty*4+{0..3}, columns likewise with tx), so one k step loads four
// float4 from shared memory (16 floats) for 64 FMAs. Both operand tiles sit
// in shared memory K-major ([k][m] and [k][n], rows padded to 132 floats)
// in a ring of kStages stages filled by cp.async: one 16-byte copy a thread
// where the operand is contiguous along m (or n) and 16-byte aligned,
// 4-byte copies that transpose it where it is contiguous along k. Ragged
// M, N and K edges are zero-filled on load and masked on store. 25 KB of
// static shared memory and at most 128 registers a thread (launch bounds)
// let two blocks share an SM.
//
// Order: each output element is summed over K by one thread, k = 0, 1, ...
// in order, with no atomics, so two calls give the same bits.
//
// Raster: blocks that run together share one operand panel. When M <= N
// the grid walks M tiles fastest (consecutive blocks read the same B panel
// and the smaller A stays in L2), else N tiles fastest.
//
// Batches: the grid's third dimension runs `count` independent products
// of one shape (an ensemble's members). Operand z starts `zs` elements
// past operand 0 (zs = 0: one operand shared by every z), and the
// epilogue is told z. count = 1 launches an instantiation without the
// batch offsets (Batched = false): they cost the products whose operands
// load through 4-byte copies 3.5-7% (scripts/time_kernel_parts.py, H100 SXM at
// 700 W), which a single product need not pay. The sums are the same in
// either, in the same order.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace sgemm {

constexpr int kThreads = 256;
constexpr int kTile = 128;         // output tile, M and N
constexpr int kBK = 8;             // K step
constexpr int kLdS = kTile + 4;    // shared row stride: float4-aligned, and
                                   // the transposing stores hit 32 banks
constexpr int kStages = 3;

// One operand in device memory: element (row, k) of a K-contiguous
// operand is p[row * ld + k]; of an M/N-contiguous one, p[k * ld + row].
// vec: 16-byte copies are allowed (M/N-contiguous operands only). zs:
// elements from one batch entry's operand to the next (0: shared).
struct Operand {
  const float* p;
  int ld;
  bool vec;
  size_t zs = 0;
};

inline bool aligned16(const void* p, int ld, int extent, size_t zs = 0) {
  return ((uintptr_t)p & 15) == 0 && ld % 4 == 0 && extent % 4 == 0 &&
         zs % 4 == 0;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the [kBK][kTile] K-major tile (rows r0.., k0..) of one operand into
// shared memory; `rows` is the operand's M (or N) extent.
template <bool KContig>
__device__ __forceinline__ void load_tile(float* s, const Operand& o,
                                          int rows, int K, int r0, int k0) {
  const int tid = threadIdx.x;
  if constexpr (KContig) {
    // 4 elements a thread; 8 neighbouring lanes read one row's 8 k values
#pragma unroll
    for (int i = 0; i < kTile * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int k = idx & (kBK - 1), r = idx / kBK;
      const bool ok = r0 + r < rows && k0 + k < K;
      cp_async4(s + k * kLdS + r,
                ok ? o.p + (size_t)(r0 + r) * o.ld + k0 + k : o.p, ok);
    }
  } else {
    // one k row of 128 values is 32 float4; 8 rows = one float4 a thread
    const int k = tid / (kTile / 4), r = (tid % (kTile / 4)) * 4;
    const bool kok = k0 + k < K;
    const float* src = o.p + (size_t)(k0 + k) * o.ld + r0 + r;
    if (o.vec) {
      const bool ok = kok && r0 + r < rows;
      cp_async16(s + k * kLdS + r, ok ? src : o.p, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kok && r0 + r + e < rows;
        cp_async4(s + k * kLdS + r + e, ok ? src + e : o.p, ok);
      }
    }
  }
}

// 4 floats at (m, n..n+3) of a row-major matrix with row stride ld; the
// columns at or past N are neither read nor written. vec: the 4 are one
// aligned float4 (ld % 4 == 0, aligned base, N % 4 == 0).
__device__ __forceinline__ void load4(const float* p, int ld, bool vec, int m,
                                      int n, int N, float (&v)[4]) {
  const float* q = p + (size_t)m * ld + n;
  if (vec) {
    const float4 f = *reinterpret_cast<const float4*>(q);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = n + e < N ? q[e] : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, int ld, bool vec, int m,
                                       int n, int N, const float (&v)[4]) {
  float* q = p + (size_t)m * ld + n;
  if (vec) {
    *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < N) q[e] = v[e];
  }
}

// An epilogue for a product summed over K in chunks, in order:
// out[z] = (first ? 0 : out[z]) + acc, then times `scale` when `last`.
// out[z] is row-major with row stride ld, zs elements past out[0].
struct AccumEpi {
  float* o;
  int ld;
  size_t zs;
  bool vec;
  bool first;
  bool last;
  float scale;
  __device__ void operator()(int z, int m, int n, int N,
                             float (&v)[4]) const {
    float* oz = o + z * zs;
    if (!first) {
      float old[4];
      load4(oz, ld, vec, m, n, N, old);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = old[e] + v[e];
    }
    if (last) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __fmul_rn(scale, v[e]);
    }
    store4(oz, ld, vec, m, n, N, v);
  }
};

// An epilogue that adds a scaled product to an output written before it:
// out[z] = out[z] + scale * acc, the product rounded times scale first (no
// contraction into an FMA), as torch rounds a + scale * (A·B).
struct AddScaledEpi {
  float* o;
  int ld;
  size_t zs;
  bool vec;
  float scale;
  __device__ void operator()(int z, int m, int n, int N,
                             float (&v)[4]) const {
    float* oz = o + z * zs;
    float old[4];
    load4(oz, ld, vec, m, n, N, old);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = __fadd_rn(old[e], __fmul_rn(scale, v[e]));
    store4(oz, ld, vec, m, n, N, v);
  }
};

// Epi: a functor with
//   __device__ void operator()(int z, int m, int n, int N,
//                              float (&v)[4]) const
// called once per (batch entry z, row m < M, 4 columns from n < N) with
// the finished sums.
template <bool AKContig, bool BKContig, bool Batched, class Epi>
__global__ void __launch_bounds__(kThreads, 2)
sgemm_kernel(Operand a, Operand b, int M, int N, int K, bool m_fast,
             Epi epi) {
  __shared__ __align__(16) float as[kStages][kBK][kLdS];
  __shared__ __align__(16) float bs[kStages][kBK][kLdS];

  const int z = Batched ? (int)blockIdx.z : 0;
  if constexpr (Batched) {
    a.p += z * a.zs;
    b.p += z * b.zs;
  }

  const int m0 = (m_fast ? blockIdx.x : blockIdx.y) * kTile;
  const int n0 = (m_fast ? blockIdx.y : blockIdx.x) * kTile;
  const int kt_count = (K + kBK - 1) / kBK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) {
      load_tile<AKContig>(&as[s][0][0], a, M, K, m0, s * kBK);
      load_tile<BKContig>(&bs[s][0][0], b, N, K, n0, s * kBK);
    }
    cp_async_commit();
  }

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();  // ... every thread's part, and tile kt-1 is consumed
    const int pf = kt + kStages - 1;
    if (pf < kt_count) {
      const int s = pf % kStages;
      load_tile<AKContig>(&as[s][0][0], a, M, K, m0, pf * kBK);
      load_tile<BKContig>(&bs[s][0][0], b, N, K, n0, pf * kBK);
    }
    cp_async_commit();  // an empty group past the end keeps the count

    const int st = kt % kStages;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[st][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[st][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[st][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[st][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= N) continue;
      float v[4] = {acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                    acc[i][h * 4 + 3]};
      epi(z, m, n, N, v);
    }
  }
}

// Launch `count` products of one shape on `stream` (batch entry z reads
// its operands zs elements on, see Operand). AKContig: A is stored [M][K]
// (else [K][M]); BKContig: B is stored [N][K] (else [K][N]).
template <bool AKContig, bool BKContig, class Epi>
cudaError_t run(Operand a, Operand b, int M, int N, int K, const Epi& epi,
                cudaStream_t stream, int count = 1) {
  if (M < 1 || N < 1 || K < 1 || count < 1) return cudaErrorInvalidValue;
  const unsigned tm = (M + kTile - 1) / kTile, tn = (N + kTile - 1) / kTile;
  const bool m_fast = M <= N;
  const dim3 grid(m_fast ? tm : tn, m_fast ? tn : tm, count);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  if (count > 1)
    sgemm_kernel<AKContig, BKContig, true, Epi>
        <<<grid, kThreads, 0, stream>>>(a, b, M, N, K, m_fast, epi);
  else
    sgemm_kernel<AKContig, BKContig, false, Epi>
        <<<grid, kThreads, 0, stream>>>(a, b, M, N, K, m_fast, epi);
  return cudaGetLastError();
}

}  // namespace sgemm
