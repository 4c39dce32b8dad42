// bgemm_wgmma.cuh — a bf16 tensor-core matrix product for Hopper (sm_90a):
// TMA tile loads into a ring of shared-memory stages, wgmma from shared
// memory, fp32 accumulation. Its interface is the fp32 template's
// (sgemm_simt.cuh: Operand, run<AKContig, BKContig>, which here also takes
// whether the epilogue reads, and the same Epi functors). It carries every
// bf16 product of the port: those of
// the two ensemble backwards' bf16 forms (sae_bwd_bf16.cuh), which replace
// the TPU kernel sparse_coding_tpu/ops/fused_sae_tiled.py:230 _bwd_kernel
// (pallas_call :439) under compute_dtype="bfloat16", and its whole-dict
// forms fused_sae.py:152 _tied_tile_grads and :645 _untied_kernel; the
// two products of the two ensemble forwards' bf16 forms (sae_fwd.cuh),
// which replace fused_sae_tiled.py:191 _fwd_kernel (pallas_call :375); and
// the four products of the big SAE's bf16 backward (big_sae_bwd.cu, one
// product a launch), which replaces fused_big_sae.py:253 big_sae_backward
// (pallas_call :298) under compute_dtype="bfloat16"; and the two products
// of the big SAE's bf16 forward (big_sae_fwd.cu, one product a launch),
// which replaces fused_big_sae.py:214 big_sae_forward (pallas_call :234)
// under compute_dtype="bfloat16": every dot operand rounded to bf16, the
// sums in fp32.
//
// Bound: the products at the bf16 tensor cores' 989 TFLOP/s dense where K
// is long (the weight grads, K = a chunk's rows; all four at d=2048);
// where K = d is short (codes, dpre: 512 at the canonical shape) the
// epilogue's workspace traffic (6 and 10 bytes a code) at 3.35 TB/s. So
// the mainloop keeps the tensor cores fed without spending registers or
// instructions on loads (TMA, one producer warp), and the epilogue's
// stores overlap another block's mainloop.
//
// Block: 288 threads — two consumer warpgroups (warps 0-7), each owning 64
// rows of a 128 x BN output tile (BN/2 fp32 accumulators a thread), and
// one producer warp (warp 8) whose lane 0 issues the TMA loads. BN = 128:
// 3 stages, two blocks an SM, so one block's epilogue overlaps the
// other's mainloop. BN = 256, taken where K >= kWideK and the epilogue
// only stores, or K >= kWideKReads: 4 stages, one block an SM, a quarter
// fewer bytes loaded a multiply-add. K steps of 64 (128 bytes of bf16,
// one 128-byte swizzle row); each stage's `full` mbarrier completes when
// its bytes have landed (expect_tx), its `empty` one when the 8 consumer
// warps have retired the wgmmas that read it. A consumer keeps one k
// step's wgmmas in flight (wait_group 1) and releases the stage of the
// step before.
//
// Layouts (128-byte swizzle, stages 1024-byte aligned): a K-contiguous
// operand is one TMA box of 128 (A) or BN (B) rows x 64 k, row r at r *
// 128 bytes — wgmma's K-major layout, 8-row groups 1024 bytes apart
// (SBO), a k16 slice 32 bytes on. An M/N-contiguous operand is boxes of
// 64 k x 64 rows (8 KB each), k row at k * 128 bytes — the MN-major
// layout read with the transpose bit: 8-k groups 1024 bytes apart (SBO),
// 64-row atoms 8 KB apart (LBO), a k16 slice 2048 bytes on. Ragged M, N
// and K are zero-filled by TMA (out-of-bounds boxes) and masked on store.
//
// Batches: the grid's z runs `count` products of one shape; each operand
// is a rank-3 tensor map [z][rows][k] (or [z][k][rows]) whose z stride is
// the operand's zs, or extent 1 for an operand all entries share (zs = 0).
// Maps are encoded on the host per launch (cuTensorMapEncodeTiled, fetched
// from the driver at run time, so nothing links libcuda) and passed as
// __grid_constant__ parameters.
//
// Order: each output element is summed by one warpgroup over k in order,
// 16 k a wgmma, with no split-K and no atomics, so two calls give the same
// bits (the tile a shape takes is fixed by its K and its epilogue).
//
// Epilogue: the Epi functors of the other templates, unchanged, called
// once per (row, 4 columns). A warpgroup's m64nNk16 accumulators give warp
// w rows 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1 (g =
// lane / 4, t = lane % 4). They are staged in the ring, free once both
// warpgroups' last wgmmas have read it, and read back a row per warp
// instruction, lane l holding columns 4l..4l+3 of each 128: each call of
// a warp then stores (and its functor reads) 512 contiguous bytes of one
// row, where calls straight from the fragments touch 16 rows' 32 bytes
// each. On an H100 SXM that took the codes, dpre and dwr products from
// 0.69, 0.93 and 0.64 ms to 0.47, 0.71 and 0.31 ms at the canonical shape
// (scripts/time_kernel_parts.py).
//
// Raster: M tiles fastest when M <= N, else N tiles, so the blocks in
// flight share the smaller operand's tiles and walk the larger one (the
// big SAE's decode, M = 32,768 rows by N = d = 1,024: a row tile's four N
// tiles run together, and all of Wn, 32 MB in bf16, fits the 50 MB L2).
#pragma once
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums only
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wgemm {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                    // warpgroups, 64 rows each
constexpr int kThreads = kConsumers * 128 + 32;  // and the producer warp
constexpr int kTileM = 64 * kConsumers;          // output tile's M
constexpr int kBK = 64;                          // K step: 128 bytes
constexpr int kBoxBytes = 64 * kBK * 2;          // 64 rows x 64 k: 8 KB
constexpr int kABytes = kTileM * kBK * 2;        // A's share of a stage

// The output tile's N: 128 (3 stages, two blocks an SM) or 256 (4
// stages, one block an SM; a quarter fewer bytes loaded a multiply-add,
// for long K). The ring then holds the tile's sums for the epilogue, each
// row padded by 4 floats.
template <int BN>
struct Shape {
  static_assert(BN == 128 || BN == 256, "N tiles of 128 or 256");
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kBlocks = BN == 128 ? 2 : 1;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + align
  static constexpr int kLdStage = BN + 4;  // a staged row, floats
  static_assert(kTileM * kLdStage * 4 <= kStages * kStageBytes,
                "the ring holds the staged tile");
};

// One operand in device memory: element (row, k) of a K-contiguous
// operand is p[row * ld + k]; of an M/N-contiguous one, p[k * ld + row].
// zs: elements from one batch entry's operand to the next (0: shared).
struct Operand {
  const bf16* p;
  int ld;
  size_t zs = 0;
};

// TMA's rules: the base 16-byte aligned, the strides (ld, zs) multiples of
// 16 bytes; the contiguous extent a multiple of 8 elements as the other
// template's rule (the callers' d % 8).
inline bool operand_ok(const Operand& o, int contiguous_extent) {
  return ((uintptr_t)o.p & 15) == 0 && o.ld % 8 == 0 && o.zs % 8 == 0 &&
         contiguous_extent % 8 == 0;
}

// --- host: tensor maps ---------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (null if
// it offers none)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of one operand whose non-K extent is `rows`: K-contiguous as
// [z][rows][K] in boxes of box_rows rows x 64 k, else [z][K][rows] in
// boxes of 64 k x 64 rows; z extent `count`, or 1 for a shared operand.
inline cudaError_t make_map(CUtensorMap* map, const Operand& o, bool kcontig,
                            int rows, int K, int count, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t inner = kcontig ? K : rows, outer = kcontig ? rows : K;
  const cuuint64_t row_bytes = (cuuint64_t)o.ld * sizeof(bf16);
  const bool batched = count > 1 && o.zs != 0;
  const cuuint64_t dims[3] = {inner, outer, batched ? (cuuint64_t)count : 1};
  const cuuint64_t strides[2] = {
      row_bytes, batched ? o.zs * sizeof(bf16) : row_bytes * outer};
  const cuuint32_t box[3] = {64, kcontig ? (cuuint32_t)box_rows : 64u, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(o.p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// --- device: barriers, TMA, wgmma ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of `map` at (c0, c1, c2), innermost first, into dst; its bytes
// complete on bar
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The (r0.., k0..) tile of one operand, Rows rows, into a stage: one
// Rows x 64 box (K-contiguous) or Rows / 64 boxes of 64 x 64, 8 KB apart.
template <bool KContig, int Rows>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          uint32_t dst, uint32_t bar, int r0,
                                          int k0, int z) {
  if constexpr (KContig) {
    tma_load(map, dst, bar, k0, r0, z);
  } else {
#pragma unroll
    for (int i = 0; i < Rows / 64; ++i)
      tma_load(map, dst + i * kBoxBytes, bar, r0 + 64 * i, k0, z);
  }
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// The descriptor of a warpgroup's k16 slice kk of an operand in a stage:
// `rows0` the first of its rows (a multiple of 64) within the tile.
template <bool KContig>
__device__ __forceinline__ uint64_t slice_desc(uint32_t tile, int rows0,
                                               int kk) {
  if constexpr (KContig)
    return smem_desc(tile + rows0 * 128 + kk * 32, 16, 1024);
  else
    return smem_desc(tile + rows0 * 128 + kk * 2048, kBoxBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous window of a wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A · B over 16 k for a 64 x N tile (N = 128 or 256: 64 or 128
// accumulators a thread), A and B from shared memory; TA / TB: the
// operand is M- / N-contiguous (wgmma's transpose bits)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[128], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// Epi: a functor with
//   __device__ void operator()(int z, int m, int n, int N,
//                              float (&v)[4]) const
// called once per (batch entry z, row m < M, 4 columns from n < N) with
// the finished sums. za, zb: 1 where the operand's map has a z extent
// (its entries differ per batch entry), 0 where it is shared.
template <bool AKContig, bool BKContig, int BN, class Epi>
__global__ void __launch_bounds__(kThreads, Shape<BN>::kBlocks)
wgemm_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b, int za, int zb,
             int M, int N, int K, bool m_fast, Epi epi) {
  using S = Shape<BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S::kStages], empty[S::kStages];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int z = blockIdx.z;
  const int m0 = (m_fast ? blockIdx.x : blockIdx.y) * kTileM;
  const int n0 = (m_fast ? blockIdx.y : blockIdx.x) * BN;
  const int kt_count = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer
    if (lane == 0) {
      for (int kt = 0; kt < kt_count; ++kt) {
        const int s = kt % S::kStages;
        // the stage's previous round released (passes at once in round 0)
        mbar_wait(smem_u32(&empty[s]), ((kt / S::kStages) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, S::kStageBytes);
        const uint32_t tile = smem + s * S::kStageBytes;
        load_tile<AKContig, kTileM>(&map_a, tile, bar, m0, kt * kBK, z * za);
        load_tile<BKContig, BN>(&map_b, tile + kABytes, bar, n0, kt * kBK,
                                z * zb);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows wg * 64 .. + 63 of the tile
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < kt_count; ++kt) {
    const int s = kt % S::kStages;
    mbar_wait(smem_u32(&full[s]), (kt / S::kStages) & 1);
    const uint32_t tile_a = smem + s * S::kStageBytes;
    const uint32_t tile_b = tile_a + kABytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64k16<AKContig ? 0 : 1, BKContig ? 0 : 1>(
          acc, slice_desc<AKContig>(tile_a, wg * 64, kk),
          slice_desc<BKContig>(tile_b, 0, kk));
    wgmma_commit();
    fence_acc(acc);
    // the step before is retired: release its stage
    wgmma_wait<1>();
    fence_acc(acc);
    if (kt > 0 && lane == 0)
      mbar_arrive(smem_u32(&empty[(kt - 1) % S::kStages]));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Epilogue. Both warpgroups' wgmmas have read their last stage, so the
  // ring (all of its loads consumed) takes the tile's sums: warpgroup wg's
  // 64 rows at stage[wg * 64 ..], kLdStage floats a row. Accumulators
  // 4j..4j+3 of a thread are rows g, g, g + 8, g + 8 of its warp's 16,
  // columns 8j + 2t, 8j + 2t + 1 (g = lane / 4, t = lane % 4); with the
  // 4-float pad those float2 writes fill the 32 banks once. Each warp then
  // reads back its own 16 rows, a row at a time, lane l holding columns
  // 4l..4l+3, so every epilogue call of a warp covers 512 contiguous
  // bytes of a row.
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float* stage = reinterpret_cast<float*>(
      smem_raw + (smem - smem_u32(smem_raw)));
  const int w4 = warp & 3, g = lane >> 2, t = lane & 3;
  constexpr int ld = S::kLdStage;
  float* rows = stage + (wg * 64 + w4 * 16) * ld;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(rows + g * ld + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(rows + (g + 8) * ld + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncwarp();
  const int m_warp = m0 + wg * 64 + w4 * 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int m = m_warp + i;
#pragma unroll
    for (int c = 0; c < BN; c += 128) {
      const int n = n0 + c + 4 * lane;
      const float4 f =
          *reinterpret_cast<const float4*>(rows + i * ld + c + 4 * lane);
      float v[4] = {f.x, f.y, f.z, f.w};
      if (m < M && n < N) epi(z, m, n, N, v);
    }
  }
}

// Launch `count` products of one shape on `stream` (batch entry z reads
// its operands zs elements on). AKContig: A is stored [M][K] (else
// [K][M]); BKContig: B is stored [N][K] (else [K][N]); BN: the output
// tile's N (Shape). A refused map or launch returns its error; nothing
// falls back.
template <bool AKContig, bool BKContig, int BN, class Epi>
cudaError_t run_tiles(Operand a, Operand b, int M, int N, int K,
                      const Epi& epi, cudaStream_t stream, int count) {
  using S = Shape<BN>;
  if (M < 1 || N < 1 || K < 1 || count < 1) return cudaErrorInvalidValue;
  if (!operand_ok(a, AKContig ? K : M) || !operand_ok(b, BKContig ? K : N))
    return cudaErrorMisalignedAddress;
  const unsigned tm = (M + kTileM - 1) / kTileM, tn = (N + BN - 1) / BN;
  const bool m_fast = M <= N;
  const dim3 grid(m_fast ? tm : tn, m_fast ? tn : tm, count);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  cudaError_t err = make_map(&map_a, a, AKContig, M, K, count, kTileM);
  if (err != cudaSuccess) return err;
  err = make_map(&map_b, b, BKContig, N, K, count, BN);
  if (err != cudaSuccess) return err;
  auto kernel = wgemm_kernel<AKContig, BKContig, BN, Epi>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err == cudaSuccess)  // all of L1 that two blocks' rings leave
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
      map_a, map_b, count > 1 && a.zs != 0, count > 1 && b.zs != 0, M, N, K,
      m_fast, epi);
  return cudaGetLastError();
}

// K from which a product whose epilogue only stores takes the 128 x 256
// tile: there the mainloop dominates, and the wider tile loads a quarter
// fewer bytes a multiply-add. An epilogue that reads its output back (or
// another array of its shape) stays on two 128 x 128 blocks an SM, which
// overlap one's epilogue with the other's mainloop: with one block an SM
// its loads stall the SM (on an H100 SXM at d=2048, dpre 2.46 -> 2.72 ms
// and dwr 2.31 -> 2.72 ms, where codes 2.12 -> 1.92 and dwx 2.03 -> 1.71;
// scripts/time_kernel_parts.py).
constexpr int kWideK = 1024;

// K from which a product whose epilogue reads takes the 128 x 256 tile as
// well: the stall is then a small share of a long mainloop (on an H100
// SXM, the big SAE's bf16 de and dwn adding to their grads at K = 5,440
// rows, 0.340 -> 0.297 ms; worse at K = 2,048, above;
// scripts/time_kernel_parts.py --only big_bf16). The ensemble forwards'
// decode, whose epilogue reads the batch, agrees: 2.23 -> 1.82 ms at K =
// n = 8,192, 0.285 -> 0.308 at 2,048 (--only bf16_fwd).
constexpr int kWideKReads = 4096;

// run_tiles with the tile chosen by K and by whether the epilogue reads
template <bool AKContig, bool BKContig, class Epi>
cudaError_t run(Operand a, Operand b, int M, int N, int K, const Epi& epi,
                bool epi_reads, cudaStream_t stream, int count = 1) {
  return K >= (epi_reads ? kWideKReads : kWideK)
             ? run_tiles<AKContig, BKContig, 256>(a, b, M, N, K, epi, stream,
                                                  count)
             : run_tiles<AKContig, BKContig, 128>(a, b, M, N, K, epi, stream,
                                                  count);
}

}  // namespace wgemm
