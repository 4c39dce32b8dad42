// bgemm_mma.cuh — a bf16 tensor-core matrix product (sm_90a) with the GEMM
// template's interface (sgemm_simt.cuh): out[m, n] = epi(sum_k A(m,k)
// B(k,n)), bf16 operands, fp32 accumulation. It carries
// compute_dtype="bfloat16" of the ensemble kernels, where the JAX package
// casts every dot operand to bf16 and accumulates in fp32
// (sparse_coding_tpu/ops/fused_sae.py _tied_tile_grads, _untied_kernel;
// fused_sae_tiled.py _fwd_kernel, _bwd_kernel).
//
// Bound: the bf16 tensor cores, 989 TFLOP/s dense on an H100 SXM, against
// the CUDA cores' 67 TFLOP/s that bound the fp32 template; at the
// ensembles' shapes (K = 512-2048, tiles of 128x128) the products do
// 64-256 multiply-adds per operand byte, above the card's ~295 FLOP per
// byte of HBM only from L2, so the loads matter too.
//
// Mainloop: mma.sync.aligned.m16n8k16 bf16 x bf16 -> fp32, fed by
// ldmatrix from a three-stage cp.async ring. One 256-thread block owns a
// 128x128 output tile and walks K in steps of 32; its 8 warps sit 2 (M)
// x 4 (N), each with a 64x32 warp tile: 4 x 4 mma tiles, 64 fp32
// accumulators a thread. An operand contiguous along K sits in shared
// memory as [rows][32 + 8] and loads with ldmatrix; one contiguous along
// M (or N) sits as [32][128 + 8] and loads with ldmatrix.trans. The pads
// put the 8 row addresses of every ldmatrix phase in distinct banks.
// wgmma, TMA and warp specialisation are later work.
//
// Every copy is 16 bytes: operands must be 16-byte aligned, with ld, zs
// and the extent along the contiguous dimension multiples of 8 elements
// (run() returns cudaErrorMisalignedAddress otherwise). Ragged M, N and K
// edges are zero-filled on load (cp.async with a zero source size) and
// masked on store.
//
// Order: each output element is summed by one thread, 16 k at a time in
// one mma, the mmas in k order, with no atomics, so two calls give the
// same bits.
//
// Epilogue: the template's Epi functors, called once per (batch entry z,
// row m < M, 4 columns from n < N). An mma tile leaves a thread 2
// neighbouring columns of rows g and g + 8; the two lanes of a pair swap
// halves (one shuffle each way), so that the even lane holds 4 columns of
// row g and the odd lane the same 4 columns of row g + 8.
//
// Raster and batches: as sgemm_simt.cuh's — M tiles fastest when
// M <= N, else N tiles; the grid's z runs `count` products of one shape,
// operand z `zs` elements past operand 0, and count = 1 launches the
// instantiation without the batch offsets.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bgemm {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTile = 128;        // output tile, M and N
constexpr int kBK = 32;           // K step: two mma k16 steps
constexpr int kStages = 3;
constexpr int kLdK = kBK + 8;     // K-contiguous tile row (80 bytes)
constexpr int kLdMN = kTile + 8;  // M/N-contiguous tile row (272 bytes)
constexpr int kTileElems =
    kTile * kLdK > kBK * kLdMN ? kTile * kLdK : kBK * kLdMN;
constexpr int kSmemBytes = kStages * 2 * kTileElems * (int)sizeof(bf16);

// One operand in device memory: element (row, k) of a K-contiguous
// operand is p[row * ld + k]; of an M/N-contiguous one, p[k * ld + row].
// zs: elements from one batch entry's operand to the next (0: shared).
struct Operand {
  const bf16* p;
  int ld;
  size_t zs = 0;
};

// Every copy is 16 bytes: the base 16-byte aligned, and ld, zs and the
// contiguous extent multiples of 8 elements.
inline bool operand_ok(const Operand& o, int contiguous_extent) {
  return ((uintptr_t)o.p & 15) == 0 && o.ld % 8 == 0 && o.zs % 8 == 0 &&
         contiguous_extent % 8 == 0;
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
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

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a · b for one 16x8 tile over 16 k (row-major A, column-major B)
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy the (rows r0.., k0..) tile of one operand into shared memory:
// K-contiguous as [kTile][kLdK], else as [kBK][kLdMN]; `rows` is the
// operand's M (or N) extent. 512 16-byte chunks, two a thread.
template <bool KContig>
__device__ __forceinline__ void load_tile(bf16* s, const Operand& o,
                                          int rows, int K, int r0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if constexpr (KContig) {
      const int r = idx >> 2, c = (idx & 3) * 8;
      const bool ok = r0 + r < rows && k0 + c < K;
      cp_async16(s + r * kLdK + c,
                 ok ? o.p + (size_t)(r0 + r) * o.ld + k0 + c : o.p, ok);
    } else {
      const int k = idx >> 4, c = (idx & 15) * 8;
      const bool ok = k0 + k < K && r0 + c < rows;
      cp_async16(s + k * kLdMN + c,
                 ok ? o.p + (size_t)(k0 + k) * o.ld + r0 + c : o.p, ok);
    }
  }
}

// Epi: a functor with
//   __device__ void operator()(int z, int m, int n, int N,
//                              float (&v)[4]) const
// called once per (batch entry z, row m < M, 4 columns from n < N) with
// the finished sums — the fp32 template's epilogues, unchanged.
template <bool AKContig, bool BKContig, bool Batched, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
bgemm_kernel(Operand a, Operand b, int M, int N, int K, bool m_fast,
             Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int z = Batched ? (int)blockIdx.z : 0;
  if constexpr (Batched) {
    a.p += z * a.zs;
    b.p += z * b.zs;
  }
  const int m0 = (m_fast ? blockIdx.x : blockIdx.y) * kTile;
  const int n0 = (m_fast ? blockIdx.y : blockIdx.x) * kTile;
  const int kt_count = (K + kBK - 1) / kBK;
  auto stage_a = [&](int s) { return smem + (2 * s) * kTileElems; };
  auto stage_b = [&](int s) { return smem + (2 * s + 1) * kTileElems; };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) {
      load_tile<AKContig>(stage_a(s), a, M, K, m0, s * kBK);
      load_tile<BKContig>(stage_b(s), b, N, K, n0, s * kBK);
    }
    cp_async_commit();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  // ldmatrix: lane l gives the address of row l % 8 of 8x8 matrix l / 8
  const int mat = lane >> 3, mrow = lane & 7;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();  // ... every thread's part, and tile kt-1 is consumed
    const int pf = kt + kStages - 1;
    if (pf < kt_count) {
      const int s = pf % kStages;
      load_tile<AKContig>(stage_a(s), a, M, K, m0, pf * kBK);
      load_tile<BKContig>(stage_b(s), b, N, K, n0, pf * kBK);
    }
    cp_async_commit();  // an empty group past the end keeps the count

    const bf16* as = stage_a(kt % kStages);
    const bf16* bs = stage_b(kt % kStages);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
      // (m 8-15, k 8-15) of each 16-row tile = the mma's a0..a3
      unsigned af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int mb = wm + mi * 16 + (mat & 1) * 8, kb = kk + (mat >> 1) * 8;
        if constexpr (AKContig)
          ldsm_x4(af[mi], as + (mb + mrow) * kLdK + kb);
        else
          ldsm_x4_trans(af[mi], as + (kb + mrow) * kLdMN + mb);
      }
      // B: matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
      // (n 8-15, k 8-15) of each 16-column pair = b0, b1 of two 8-column
      // tiles
      unsigned bfr[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int nb = wn + nj * 16 + (mat >> 1) * 8, kb = kk + (mat & 1) * 8;
        unsigned r[4];
        if constexpr (BKContig)
          ldsm_x4(r, bs + (nb + mrow) * kLdK + kb);
        else
          ldsm_x4_trans(r, bs + (kb + mrow) * kLdMN + nb);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16816(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

  // accumulator tile (mi, ni): c0, c1 at row g, columns 2t, 2t+1; c2, c3
  // at row g + 8 (g = lane / 4, t = lane % 4)
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float c0 = acc[mi][ni][0], c1 = acc[mi][ni][1],
                  c2 = acc[mi][ni][2], c3 = acc[mi][ni][3];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c0 : c2, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c1 : c3, 1);
      float v[4] = {odd ? r0 : c0, odd ? r1 : c1, odd ? c2 : r0,
                    odd ? c3 : r1};
      const int m = m0 + wm + mi * 16 + g + (odd ? 8 : 0);
      const int n = n0 + wn + ni * 8 + (t >> 1) * 4;
      if (m < M && n < N) epi(z, m, n, N, v);
    }
  }
}

// Launch `count` products of one shape on `stream` (batch entry z reads
// its operands zs elements on). AKContig: A is stored [M][K] (else
// [K][M]); BKContig: B is stored [N][K] (else [K][N]).
template <bool AKContig, bool BKContig, class Epi>
cudaError_t run(Operand a, Operand b, int M, int N, int K, const Epi& epi,
                cudaStream_t stream, int count = 1) {
  if (M < 1 || N < 1 || K < 1 || count < 1) return cudaErrorInvalidValue;
  if (!operand_ok(a, AKContig ? K : M) || !operand_ok(b, BKContig ? K : N))
    return cudaErrorMisalignedAddress;
  const unsigned tm = (M + kTile - 1) / kTile, tn = (N + kTile - 1) / kTile;
  const bool m_fast = M <= N;
  const dim3 grid(m_fast ? tm : tn, m_fast ? tn : tm, count);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  auto kernel = count > 1 ? bgemm_kernel<AKContig, BKContig, true, Epi>
                          : bgemm_kernel<AKContig, BKContig, false, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(a, b, M, N, K, m_fast, epi);
  return cudaGetLastError();
}

}  // namespace bgemm
