// A bf16 GEMM mainloop for NVIDIA Hopper (sm_90a), shared by matmul.cu and
// matmul_rmsnorm.cu: TMA loads into a ring of swizzled shared-memory stages,
// wgmma.mma_async into f32 register accumulators, and an epilogue that the
// including kernel supplies. flash_attention.cu builds its own forward from
// the device primitives here (barriers, 2-D and 4-D TMA maps and loads,
// descriptors, wgmma fences, setmaxnreg, the last-CTA ticket). Raw PTX
// throughout (no CUTLASS), so a source that includes it builds in seconds.
//
// Operands as the port holds them, nothing copied or transposed per call.
// Each operand comes in one of two layouts, a template flag of the kernel:
//   a (M, K) row-major, so K-major for wgmma (TA false); or aᵀ, the
//   transpose of a row-major (K, M) storage at row stride lda, so M-major
//   ("MN-major", TA true): the backward's xᵀ of dw = xᵀ·dy;
//   b (K, N) with row stride ldb (a column slice of a wider weight passes as
//   it lies), so N-major (TB false); or bᵀ, the transpose of a row-major
//   (N, K) storage at row stride ldb, so K-major (TB true): the backward's
//   wᵀ of dx = dy·wᵀ.
// wgmma reads an MN-major A or B from shared memory for 16-bit types
// (imm-trans-a / imm-trans-b = 1), so the four layouts differ only in the
// TMA boxes, the shared-memory descriptors and those two immediates.
// TMA asks for a 16-byte aligned base and row strides that are multiples of
// 16 bytes (lda % 8 == 0 and ldb % 8 == 0 in bf16, lda = K for a row-major
// a); the wrappers route any other layout to the FFMA kernels. Ragged edges (M, N, K not multiples of
// the tile) are TMA's zero fill: out-of-range rows, columns and depths load
// as 0, add nothing to the sums, and are not stored.
//
// Shape of the kernel (one CTA = one BM x BN output tile, the whole of K):
//   - warpgroups 0 .. BM/64-1 consume: each owns 64 rows of the tile and
//     runs m64nBNk16 wgmma (bf16 x bf16 -> f32), four per 64-deep stage;
//   - the last warpgroup produces: one thread starts the TMA loads of a
//     (K-major: one 64 x BM box; M-major: BM/64 boxes of 64 x 64) and of b
//     (N-major: BN/64 boxes of 64 x 64; K-major: one 64 x BN box) into
//     stage s and
//     arms full[s] with the bytes to expect; consumers release a stage on
//     empty[s] once the wgmma that read it has retired (wait_group 1, so
//     the next stage's products are in flight meanwhile);
//   - kStages stages of (BM + BN) x 64 bf16, 128-byte swizzled by TMA, the
//     wgmma descriptors carrying the same swizzle (layout type 1).
// With two consumer warpgroups the producer gives registers back
// (setmaxnreg.dec 40) and the consumers take them (setmaxnreg.inc 232):
// 256 x 232 + 128 x 40 = 64512 of the SM's 65536.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

// Element conversions every kernel of the port's GEMM sources uses: loads
// widened to f32, stores rounded to the output type, one or two at a time.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

constexpr int kBK = 64;        // depth of a stage: 64 bf16 = one 128 B row
constexpr int kStages = 4;     // ring depth
constexpr int kMaxCluster = 8; // the portable cluster limit

// Dynamic shared memory of one CTA: the stages, plus 1 KB to align the base
// to the 1024-byte period of the 128-byte swizzle.
__host__ __device__ constexpr int smem_bytes(int bm, int bn) {
  return kStages * (bm + bn) * kBK * 2 + 1024;
}

// ---------------------------------------------------------------------------
// host: tensor maps, cuTensorMapEncodeTiled looked up at run time (no -lcuda)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
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

// A 2-D bf16 tensor map over rows of `inner` elements at a stride of
// `row_elems`, read in boxes of box_inner x box_outer with the 128-byte
// swizzle; out-of-range elements load as zero.
inline cudaError_t make_map(CUtensorMap* map, const void* base,
                            uint64_t inner, uint64_t outer, uint64_t row_elems,
                            uint32_t box_inner, uint32_t box_outer) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_elems * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 4-D bf16 tensor map: dims[0] contiguous, the byte strides of dims 1-3,
// read in boxes of box[0] x .. x box[3] with the 128-byte swizzle;
// out-of-range elements load as zero. A box never crosses an outer
// dimension, so a (rows of one head) box stops at the end of its sequence.
inline cudaError_t make_map_4d(CUtensorMap* map, const void* base,
                               const uint64_t (&dims)[4],
                               const uint64_t (&strides)[3],
                               const uint32_t (&box)[4]) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t bx[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), d, st, bx, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What TMA takes: a 16-byte aligned base and row strides of 16-byte
// multiples.
inline bool tma_ok(const void* p, long row_elems) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0 && row_elems % 8 == 0;
}

// ---------------------------------------------------------------------------
// device: barriers, TMA, wgmma, clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Wait for the completion of the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// The "last CTA to arrive" step of a reduction across CTAs: after every
// thread's writes, one thread releases them (fence.acq_rel.gpu) and draws a
// ticket; the CTA that draws the last of `count` acquires everyone's writes
// (the caller resets the ticket to 0 once it is done). Returns whether this
// CTA was last; `last` is one int of shared memory.
__device__ __forceinline__ bool last_to_arrive(int* ticket, int count,
                                               int* last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    *last = atomicAdd(ticket, 1) == count - 1;
    if (*last) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  return *last;
}

// A wgmma shared-memory descriptor with the 128-byte swizzle (layout type
// 1). Offsets in bytes. K-major (a, or a transposed b): SBO = 1024 (the next
// 8 rows of M or N), LBO unused (16). MN-major (b, or a transposed a): SBO =
// 1024 (the next 8 rows of K), LBO = the next 64-column box of N (an A tile
// of 64 rows is one box, so there LBO is never read).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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
// Keeps the compiler from moving accumulator reads across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// Every thread of every CTA of the cluster arrives, then waits: writes to
// shared memory before it are visible to the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// A float in the shared memory of the cluster's CTA `rank`, at the address
// `p` has in this CTA.
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// m64nNk16, bf16 x bf16 -> f32, a and b from shared memory, accumulating
// into d (scale-d 1; the caller zeroes d first). TA and TB are the PTX
// imm-trans-a and imm-trans-b: 1 reads that operand MN-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
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
};

template <>
struct Wgmma<256> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
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
};


// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// The accumulator fragment of one consumer thread, as wgmma lays it out: in
// its warpgroup's 64 rows, warp w holds rows 16w + lane/4 and that + 8; for
// each 8-column group i, columns 8i + 2(lane % 4) and the next one.
//   d[4i + 0], d[4i + 1]: (row0, col), (row0, col + 1)
//   d[4i + 2], d[4i + 3]: (row0 + 8, col), (row0 + 8, col + 1)
struct Frag {
  int row0;   // tile row of d[4i], d[4i + 1] (the other two at row0 + 8)
  int col0;   // tile column of d[0] (add 8i)
};

// The epilogue contract: `consume(d, frag, tile_m0, tile_n0, row_ss)` runs
// in every consumer thread once its accumulators are final; `idle()` runs in
// every producer thread once its loads are started (a cluster epilogue
// matches its barriers there). row_ss is BM floats of shared memory.
template <int BM, int BN, bool TA, bool TB, class Epilogue>
__global__ void __launch_bounds__((BM / 64 + 1) * 128, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, int K,
                Epilogue ep) {
  constexpr int kCons = BM / 64;                  // consumer warpgroups
  constexpr int kStageA = BM * kBK;               // bf16 elements
  constexpr int kStageB = BN * kBK;
  constexpr uint32_t kTx = (kStageA + kStageB) * 2;
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
  static_assert(BN == 64 || BN == 128 || BN == 256, "BN is 64, 128 or 256");

  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sb = sa + kStages * kStageA;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ float row_ss[BM];

  const int wg = threadIdx.x / 128;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kCons);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kCons) {
    // ---------------- producer warpgroup ----------------
    if constexpr (kCons == 2) setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_b)) : "memory");
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], kTx);
        if constexpr (TA) {
#pragma unroll
          for (int c = 0; c < BM / 64; ++c)
            tma_load_2d(sa + s * kStageA + c * 64 * kBK, &map_a, &full[s],
                        m0 + 64 * c, kt * kBK);
        } else {
          tma_load_2d(sa + s * kStageA, &map_a, &full[s], kt * kBK, m0);
        }
        if constexpr (TB) {
          tma_load_2d(sb + s * kStageB, &map_b, &full[s], kt * kBK, n0);
        } else {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(sb + s * kStageB + c * 64 * kBK, &map_b, &full[s],
                        n0 + 64 * c, kt * kBK);
        }
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    __syncwarp();
    ep.idle();
  } else {
    // ---------------- consumer warpgroups ----------------
    if constexpr (kCons == 2) setmaxnreg_inc<232>();
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    const int lane = threadIdx.x % 32;
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(&full[s], phase);
      const __nv_bfloat16* a_tile = sa + s * kStageA + wg * 64 * kBK;
      const __nv_bfloat16* b_tile = sb + s * kStageB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // K-major: 16 deeper is 32 bytes along the swizzled row; MN-major:
        // 16 rows of 128 bytes further (a warpgroup's 64 rows of an M-major
        // a are one 64 x 64 box, at the same offset as 64 K-major rows)
        const uint64_t da =
            TA ? sw128_desc(a_tile + kk * 16 * 64, 64 * kBK * 2, 1024)
               : sw128_desc(a_tile + kk * 16, 16, 1024);
        const uint64_t db =
            TB ? sw128_desc(b_tile + kk * 16, 16, 1024)
               : sw128_desc(b_tile + kk * 16 * 64, 64 * kBK * 2, 1024);
        Wgmma<BN>::template mma<TA ? 1 : 0, TB ? 0 : 1>(d, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();                 // the previous stage's wgmma retired
      fence_regs(d);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(d);
    if (lane == 0) mbar_arrive(&empty[prev]);
    const int warp = (threadIdx.x % 128) / 32;
    const Frag f{wg * 64 + 16 * warp + lane / 4, 2 * (lane % 4)};
    ep.consume(d, f, m0, n0, row_ss);
  }
}

// Launch gemm_kernel on a grid of ceil(N / BN) x ceil(M / BM) CTAs, in
// clusters of `cluster` CTAs along N (1: no cluster). lda and ldb are the row
// strides of a's and b's storage: (M, K) at lda = K, or (K, M) at lda >= M
// when TA; (K, N) at ldb >= N, or (N, K) at ldb >= K when TB.
template <int BM, int BN, bool TA, bool TB, class Epilogue>
cudaError_t launch_gemm(const void* a, const void* b, int M, int N, int K,
                        int lda, int ldb, int cluster, const Epilogue& ep,
                        cudaStream_t stream) {
  if (!tma_ok(a, lda) || !tma_ok(b, ldb) || cluster < 1 ||
      cluster > kMaxCluster)
    return cudaErrorInvalidValue;
  const int grid_n = (N + BN - 1) / BN;
  if (grid_n % cluster != 0) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  cudaError_t err = TA ? make_map(&map_a, a, M, K, lda, 64, kBK)
                       : make_map(&map_a, a, K, M, lda, kBK, BM);
  if (err != cudaSuccess) return err;
  err = TB ? make_map(&map_b, b, K, N, ldb, kBK, BN)
           : make_map(&map_b, b, N, K, ldb, 64, kBK);
  if (err != cudaSuccess) return err;
  auto kernel = gemm_kernel<BM, BN, TA, TB, Epilogue>;
  constexpr int smem = smem_bytes(BM, BN);
  static bool attr_set = false;        // once per instantiation
  if (!attr_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_n, (M + BM - 1) / BM, 1);
  cfg.blockDim = dim3((BM / 64 + 1) * 128, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, K, ep);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Dispatch a runtime (BM, BN) to its instantiation, in the layout TA, TB.
template <bool TA, bool TB, class Epilogue>
cudaError_t launch_tiled_layout(int bm, int bn, const void* a, const void* b,
                                int M, int N, int K, int lda, int ldb,
                                int cluster, const Epilogue& ep,
                                cudaStream_t stream) {
#define HOPPER_TILE(BM_, BN_)                                              \
  if (bm == BM_ && bn == BN_)                                              \
    return launch_gemm<BM_, BN_, TA, TB, Epilogue>(a, b, M, N, K, lda, ldb, \
                                                   cluster, ep, stream);
  HOPPER_TILE(64, 64)
  HOPPER_TILE(64, 128)
  HOPPER_TILE(64, 256)
  HOPPER_TILE(128, 64)
  HOPPER_TILE(128, 128)
  HOPPER_TILE(128, 256)
#undef HOPPER_TILE
  return cudaErrorInvalidValue;
}

// The row-major a (M, K) and N-major b of matmul_rmsnorm.
template <class Epilogue>
cudaError_t launch_tiled(int bm, int bn, const void* a, const void* b, int M,
                         int N, int K, int ldb, int cluster,
                         const Epilogue& ep, cudaStream_t stream) {
  return launch_tiled_layout<false, false>(bm, bn, a, b, M, N, K, K, ldb,
                                           cluster, ep, stream);
}

}  // namespace hopper
