// Matrix product for NVIDIA Hopper (sm_90a), bound to Python through a plain
// C interface (ctypes; see repro_torch/kernels/matmul.py).
//
// Replaces: src/repro/kernels/matmul.py `_matmul_kernel` (the Pallas TPU
// kernel): c (M, N) = a (M, K) @ b (K, N), every product and sum in f32, the
// f32 accumulator written once in the output type at the end of the K loop.
// On the port's tensor-parallel path it is every GEMM a ring schedule issues
// (src/repro_torch/core/primitives.py): one call per arriving activation
// chunk, per rotating-accumulator hop, and per barrier GEMM.
//
// Layout: c row-major and contiguous. a is row-major (M, K), or (layout
// flag ta) the transpose of a row-major (K, M) storage at row stride lda,
// as the backward's xᵀ of dw = xᵀ·dy; b is row-major (K, N), or (tb) the
// transpose of a row-major (N, K) storage at row stride ldb, as the
// backward's wᵀ of dx = dy·wᵀ. A transposed operand is read where it lies:
// nothing is copied or transposed per call. Types: a and b both f32 or both
// bf16; c f32 or bf16. Any M, N, K >= 1.
//
// What bounds it on an H100: at the ring's shapes (M = B * S_loc / chunks
// rows, K and N 256..8192) a product does 2MNK operations on (MK + KN) + MN
// elements, far above the card's ~295 operations per byte, so it is bound
// by operations. Two variants, one launch a call; the wrapper's `plan`
// picks one:
//
// 1. wgmma (bf16 with row strides lda, ldb % 8 == 0 and N % 8 == 0,
//    16-byte aligned bases; every layout):
//    the shared Hopper mainloop (hopper_gemm.cuh: TMA into a 4-stage
//    swizzled ring, one producer warp, one or two consumer warpgroups on
//    wgmma at the tensor cores' 989 TF/s) with a plain epilogue that stores
//    each f32 fragment pair in the output type. The wrapper tiles by shape
//    (BM 64 or 128, BN 64, 128 or 256) so that the ring's shapes fill the
//    132 SMs.
// 2. ffma (f32, which must not use TF32 since parity needs rtol 2e-5; and
//    any bf16 layout TMA cannot take): the f32 CUDA cores (67 TF/s). A CTA
//    of 256 threads holds a 64 x 64 tile of c, each thread a 4 x 4 register
//    tile at stride 16 (conflict-free shared-memory reads, coalesced
//    stores), over K in steps of 16 staged through shared memory; bf16 is
//    widened to f32 as it lands. Each tile is staged with neighbouring
//    threads on neighbouring addresses of its storage, along K for a
//    row-major a and a transposed b, along M or N otherwise. The loads of the ragged edge tiles are
//    guarded and zero-filled, the stores guarded; the TPU kernel instead
//    clipped its block sizes to divisors of the shape.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int kBM = 64;         // rows of c per CTA
constexpr int kBN = 64;         // columns of c per CTA
constexpr int kBK = 16;         // depth of one shared-memory stage
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;         // keeps the transposed a-tile stores apart

using hopper::store;
using hopper::store2;
using hopper::to_f32;

// TA, TB: a and b stored transposed (a layout of the template, so the
// row-major case compiles to the same staging as before the layouts).
template <typename TIn, typename TOut, bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                  TOut* __restrict__ c, int M, int N, int K, int lda,
                  int ldb) {
  __shared__ float As[kBK][kBM + kPad];   // a tile, transposed: As[k][m]
  __shared__ float Bs[kBK][kBN + kPad];   // b tile: Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // each thread stages 4 elements of each tile (64 * 16 = 4 * 256)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + r * kThreads;
      const int am = TA ? e % kBM : e / kBK, ak = TA ? e / kBM : e % kBK;
      const int gm = m0 + am, gk = k0 + ak;
      As[ak][am] = (gm < M && gk < K)
                       ? to_f32(TA ? a[(size_t)gk * lda + gm]
                                   : a[(size_t)gm * lda + gk])
                       : 0.f;
      const int bk = TB ? e % kBK : e / kBN, bn = TB ? e / kBK : e % kBN;
      const int gkb = k0 + bk, gn = n0 + bn;
      Bs[bk][bn] = (gkb < K && gn < N)
                       ? to_f32(TB ? b[(size_t)gn * ldb + gkb]
                                   : b[(size_t)gkb * ldb + gn])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) store(&c[(size_t)row * N + col], acc[i][j]);
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch_ffma(const void* a, const void* b, void* c, int M, int N,
                        int K, int lda, int ldb, int ta, int tb,
                        cudaStream_t stream) {
  if ((M + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const TIn* pa = static_cast<const TIn*>(a);
  const TIn* pb = static_cast<const TIn*>(b);
  TOut* pc = static_cast<TOut*>(c);
  if (ta && tb)
    matmul_kernel<TIn, TOut, true, true>
        <<<grid, kThreads, 0, stream>>>(pa, pb, pc, M, N, K, lda, ldb);
  else if (ta)
    matmul_kernel<TIn, TOut, true, false>
        <<<grid, kThreads, 0, stream>>>(pa, pb, pc, M, N, K, lda, ldb);
  else if (tb)
    matmul_kernel<TIn, TOut, false, true>
        <<<grid, kThreads, 0, stream>>>(pa, pb, pc, M, N, K, lda, ldb);
  else
    matmul_kernel<TIn, TOut, false, false>
        <<<grid, kThreads, 0, stream>>>(pa, pb, pc, M, N, K, lda, ldb);
  return cudaGetLastError();
}

// wgmma's epilogue: each thread stores its fragment pairs as they are.
template <typename TOut>
struct StoreEpilogue {
  TOut* c;
  int M, N;

  __device__ void idle() const {}

  template <int R>
  __device__ void consume(float (&d)[R], hopper::Frag f, int m0, int n0,
                          float*) const {
    const int r0 = m0 + f.row0, r1 = r0 + 8;
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const int col = n0 + f.col0 + 8 * i;
      if (col >= N) continue;     // N % 8 == 0: a pair is in or out whole
      if (r0 < M) store2(&c[(size_t)r0 * N + col], d[4 * i], d[4 * i + 1]);
      if (r1 < M)
        store2(&c[(size_t)r1 * N + col], d[4 * i + 2], d[4 * i + 3]);
    }
  }
};

template <typename TOut>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int M, int N,
                         int K, int lda, int ldb, int ta, int tb, int bm,
                         int bn, cudaStream_t stream) {
  if (N % 8 != 0 || (M + bm - 1) / bm > 65535) return cudaErrorInvalidValue;
  const StoreEpilogue<TOut> ep{static_cast<TOut*>(c), M, N};
  if (ta && tb)
    return hopper::launch_tiled_layout<true, true>(bm, bn, a, b, M, N, K, lda,
                                                   ldb, 1, ep, stream);
  if (ta)
    return hopper::launch_tiled_layout<true, false>(bm, bn, a, b, M, N, K,
                                                    lda, ldb, 1, ep, stream);
  if (tb)
    return hopper::launch_tiled_layout<false, true>(bm, bn, a, b, M, N, K,
                                                    lda, ldb, 1, ep, stream);
  return hopper::launch_tiled_layout<false, false>(bm, bn, a, b, M, N, K, lda,
                                                   ldb, 1, ep, stream);
}

template <typename TIn, typename TOut>
cudaError_t dispatch(int variant, const void* a, const void* b, void* c,
                     int M, int N, int K, int lda, int ldb, int ta, int tb,
                     int bm, int bn, cudaStream_t stream) {
  if (variant == 0)
    return launch_ffma<TIn, TOut>(a, b, c, M, N, K, lda, ldb, ta, tb, stream);
  if constexpr (sizeof(TIn) == 2)
    if (variant == 1)
      return launch_wgmma<TOut>(a, b, c, M, N, K, lda, ldb, ta, tb, bm, bn,
                                stream);
  return cudaErrorInvalidValue;        // wgmma here is bf16 only
}

}  // namespace

extern "C" {

// variant: 0 = ffma (64 x 64 tiles), 1 = wgmma (bm 64 or 128 rows and bn 64,
// 128 or 256 columns a CTA; bf16 only). ta, tb: 1 where a, b is the
// transpose of its row-major storage; lda, ldb: the storages' row strides
// (lda = K, ldb >= N when not transposed). in_dtype, out_dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 = launched).
int matmul_fwd(const void* a, const void* b, void* c, int M, int N, int K,
               int lda, int ldb, int ta, int tb, int variant, int bm, int bn,
               int in_dtype, int out_dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (in_dtype != 0 && in_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1) || lda < (ta ? M : K) ||
      ldb < (tb ? K : N))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return out_dtype == 0
               ? (int)dispatch<float, float>(variant, a, b, c, M, N, K, lda,
                                             ldb, ta, tb, bm, bn, st)
               : (int)dispatch<float, __nv_bfloat16>(variant, a, b, c, M, N,
                                                     K, lda, ldb, ta, tb, bm,
                                                     bn, st);
  return out_dtype == 0
             ? (int)dispatch<__nv_bfloat16, float>(variant, a, b, c, M, N, K,
                                                   lda, ldb, ta, tb, bm, bn,
                                                   st)
             : (int)dispatch<__nv_bfloat16, __nv_bfloat16>(
                   variant, a, b, c, M, N, K, lda, ldb, ta, tb, bm, bn, st);
}

const char* matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
