// Matrix product with an RMSNorm epilogue for NVIDIA Hopper (sm_90a), bound
// to Python through a plain C interface (ctypes; see
// repro_torch/kernels/matmul_rmsnorm.py).
//
// Replaces: src/repro/kernels/matmul_ln.py `_matmul_ln_kernel` (the Pallas
// TPU kernel): out (M, N) = rmsnorm(a @ b) * (1 + scale), i.e.
//   z = a @ b (f32 products and sums),
//   out[m, n] = z[m, n] * rsqrt(mean_n(z[m, :]^2) + eps) * (1 + scale[n]),
// written once in the output type. The norm needs the whole output row, so
// the TPU kernel kept a (bm, N) f32 accumulator in VMEM across its K grid.
// On the port's serving path it is the two latent norms of every MLA layer
// (src/repro_torch/models/attention.py `_mla_q`, `_mla_latents`).
//
// Layout: a (M, K) row-major contiguous; b (K, N) with row stride ldb >= N
// and unit column stride (so a column slice of a wider weight, as
// `wkv_a[:, :kv_lora_rank]`, needs no copy); scale (N,) f32; out (M, N)
// contiguous. Types: a and b both f32 or both bf16; out f32 or bf16. bf16 is
// widened to f32 as it lands in shared memory. No tensor cores and no TF32,
// so the f32 case is full f32 (FFMA).
//
// Design: one CTA owns BM whole output rows (BM in {4, 8, 16, 32, 64}, chosen
// by the wrapper from N and M) and keeps their BM x N f32 accumulator in
// dynamic shared memory, as the TPU kernel kept it in VMEM. It walks the row
// block's columns in chunks of BN = 4096 / BM; for each chunk its 256
// threads hold a BM x BN tile in registers (4 x 4 per thread, at strides
// that keep shared-memory reads conflict-free and stores coalesced) over K
// in steps of 16 staged through shared memory, then park the tile in the
// row accumulator. The epilogue gives each warp whole rows: lanes sum z^2
// over the row, reduce by shuffles, and write the scaled row. So z never
// goes to device memory. The accumulator and the stages bound N:
// 4 * BM * N + 64 * (BN + BM + 4) bytes <= 227 KB, so N <= 10400 at BM = 4.
//
// What bounds it on an H100, and what this simple design does about it: at
// the MLA prefill shapes (M = B * S rows, K = d_model 2560, N 768 or 256)
// a call does 2MNK operations on MK + KN + MN elements, far above the card's
// ~295 operations per byte, so it is bound by operations; this design runs
// them on the f32 CUDA cores (67 TF/s, not the 989 TF/s of bf16 wgmma), with
// the A tile re-read once per column chunk and loads not double-buffered.
// At decode (M = batch) it is bound by the bytes of b, and a grid of
// ceil(M / BM) CTAs leaves most SMs idle (one CTA at M <= 4). A split-N
// design with a cluster reduction of the row sums, on wgmma, is the later
// change that moves both bounds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;           // depth of one shared-memory stage
constexpr int kTileElems = 4096;  // BM * BN: 256 threads x 4 x 4 outputs
constexpr int kPad = 4;           // keeps the transposed a-tile stores apart
constexpr int kMaxSmem = 232448;  // 227 KB: the most a CTA may opt in to

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int BM>
__host__ __device__ constexpr int block_cols() { return kTileElems / BM; }

template <int BM>
size_t smem_bytes(int N) {
  return sizeof(float) * ((size_t)BM * N + (size_t)kBK * (BM + kPad) +
                          (size_t)kBK * block_cols<BM>());
}

template <typename TIn, typename TOut, int BM>
__global__ void __launch_bounds__(kThreads)
    matmul_rmsnorm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                          const float* __restrict__ scale,
                          TOut* __restrict__ out, int M, int N, int K, int ldb,
                          float eps) {
  constexpr int BN = block_cols<BM>();
  constexpr int RT = BM / 4;         // threads along the rows
  constexpr int CT = kThreads / RT;  // threads along the columns (BN / 4)
  extern __shared__ float smem[];
  float* acc_s = smem;                          // [BM][N]: z of the row block
  float* As = acc_s + (size_t)BM * N;           // [kBK][BM + kPad], a^T tile
  float* Bs = As + kBK * (BM + kPad);           // [kBK][BN], b tile

  const int tid = threadIdx.x;
  const int tx = tid % CT;
  const int ty = tid / CT;
  const int m0 = blockIdx.x * BM;

  for (int n0 = 0; n0 < N; n0 += BN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kBK) {
      // a tile: BM x kBK elements, at most 4 a thread
      for (int e = tid; e < BM * kBK; e += kThreads) {
        const int am = e / kBK, ak = e % kBK;
        const int gm = m0 + am, gk = k0 + ak;
        As[ak * (BM + kPad) + am] =
            (gm < M && gk < K) ? to_f32(a[(size_t)gm * K + gk]) : 0.f;
      }
      // b tile: kBK x BN elements, neighbouring threads on neighbouring n
#pragma unroll 4
      for (int e = tid; e < kBK * BN; e += kThreads) {
        const int bk = e / BN, bn = e % BN;
        const int gk = k0 + bk, gn = n0 + bn;
        Bs[bk * BN + bn] =
            (gk < K && gn < N) ? to_f32(b[(size_t)gk * ldb + gn]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float ar[4], br[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ar[i] = As[kk * (BM + kPad) + ty + RT * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) br[j] = Bs[kk * BN + tx + CT * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
    // park the chunk in the row accumulator (columns past N are dropped)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + RT * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + CT * j;
        if (col < N) acc_s[(size_t)r * N + col] = acc[i][j];
      }
    }
  }
  __syncthreads();

  // epilogue: a warp per row, the row's sum of squares by shuffles
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int row = m0 + r;
    if (row >= M) break;
    const float* z = acc_s + (size_t)r * N;
    float ss = 0.f;
    for (int n = lane; n < N; n += 32) ss = fmaf(z[n], z[n], ss);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float inv = rsqrtf(ss / (float)N + eps);
    TOut* o = out + (size_t)row * N;
    for (int n = lane; n < N; n += 32)
      store(&o[n], z[n] * inv * (1.f + scale[n]));
  }
}

template <typename TIn, typename TOut, int BM>
cudaError_t launch(const void* a, const void* b, const float* scale, void* out,
                   int M, int N, int K, int ldb, float eps,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<BM>(N);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      matmul_rmsnorm_kernel<TIn, TOut, BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((M + BM - 1) / BM));
  matmul_rmsnorm_kernel<TIn, TOut, BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), scale,
      static_cast<TOut*>(out), M, N, K, ldb, eps);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t dispatch(const void* a, const void* b, const float* scale,
                     void* out, int M, int N, int K, int ldb, int bm,
                     float eps, cudaStream_t stream) {
  switch (bm) {
    case 64:
      return launch<TIn, TOut, 64>(a, b, scale, out, M, N, K, ldb, eps, stream);
    case 32:
      return launch<TIn, TOut, 32>(a, b, scale, out, M, N, K, ldb, eps, stream);
    case 16:
      return launch<TIn, TOut, 16>(a, b, scale, out, M, N, K, ldb, eps, stream);
    case 8:
      return launch<TIn, TOut, 8>(a, b, scale, out, M, N, K, ldb, eps, stream);
    case 4:
      return launch<TIn, TOut, 4>(a, b, scale, out, M, N, K, ldb, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in_dtype, out_dtype: 0 = float32, 1 = bfloat16; bm: rows per CTA (4, 8,
// 16, 32 or 64). Returns a cudaError_t (0 = launched).
int matmul_rmsnorm_fwd(const void* a, const void* b, const void* scale,
                       void* out, int M, int N, int K, int ldb, int bm,
                       float eps, int in_dtype, int out_dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || ldb < N || (in_dtype != 0 && in_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (in_dtype == 0)
    return out_dtype == 0
               ? (int)dispatch<float, float>(a, b, sc, out, M, N, K, ldb, bm,
                                             eps, st)
               : (int)dispatch<float, __nv_bfloat16>(a, b, sc, out, M, N, K,
                                                     ldb, bm, eps, st);
  return out_dtype == 0
             ? (int)dispatch<__nv_bfloat16, float>(a, b, sc, out, M, N, K, ldb,
                                                   bm, eps, st)
             : (int)dispatch<__nv_bfloat16, __nv_bfloat16>(
                   a, b, sc, out, M, N, K, ldb, bm, eps, st);
}

const char* matmul_rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
