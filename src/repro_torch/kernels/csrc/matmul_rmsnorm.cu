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
// contiguous. Types: a and b both f32 or both bf16; out f32 or bf16. f32
// never uses TF32 (full f32 FMA), bf16 products accumulate in f32.
//
// Three variants, one launch a call; the wrapper's `plan` picks one:
//
// 1. splitk (M <= 16, decode; bf16 or f32; b 16-byte aligned rows; at
//    most 64 column blocks, so N <= 8192 in bf16, 4096 in f32). At
//    decode the call is bound by the bytes of b (3.9 MB for the bf16 query
//    latent, 1.2 us at 3.35 TB/s), so the grid has to cover the card: a
//    grid of ceil(N / BN) column blocks x S K-slices, BN = 16 threads x one
//    16-byte load (128 bf16 / 64 f32 columns). A CTA keeps its (M x kslice)
//    strip of a in shared memory, streams its kslice x BN slice of b once
//    (each thread 8 loads in flight, along N, honouring ldb), and writes an
//    f32 partial of z to a workspace the wrapper allocates. The reduction
//    is in the same launch, "last CTA to arrive": after a release fence,
//    an atomic ticket per column block (reset to 0 by the CTA that draws
//    the last one, so no zeroing launch) elects the column block's last CTA,
//    which sums the S partials in slice order (all S loads in flight at
//    once) into z, kept in registers, and publishes its rows' sums of
//    squares over its columns. The nb column finishers then wait for each
//    other on a second counter (safe while nb < the SM count: see the
//    kernel), each sums the nb row sums in block order and writes its own
//    columns normalised; the last to leave resets the counters. Every sum
//    runs in a fixed order, so the result does not depend on which CTA
//    arrives last: deterministic, no float atomics.
// 2. wgmma (bf16, M > 16, N <= 8 x 256; TMA-able layout): the shared Hopper
//    mainloop (hopper_gemm.cuh) with a norm epilogue across a cluster. A
//    cluster of ceil(N / BN) CTAs along N covers whole rows. Each consumer
//    thread squares and sums its fragment's two rows, the four lanes of a
//    quad that share a row add theirs by shuffles, and the CTAs of the
//    cluster swap those per-row partials through distributed shared memory
//    between two cluster barriers (the second keeps a CTA alive while a
//    peer still reads it). Each CTA then scales its registers and stores: z
//    never reaches device memory. At the prefill shapes (M = B * S, K =
//    2560) the call is bound by operations (16 GFLOP at 989 TF/s = 16 us
//    for the query latent), which wgmma serves.
// 3. ffma (everything else: f32 with M > 16, N beyond a cluster, layouts
//    TMA cannot take). One CTA owns BM whole output rows (BM in {4, 8, 16,
//    32, 64}, chosen by the wrapper from N and M) and keeps their BM x N f32
//    accumulator in dynamic shared memory, as the TPU kernel kept it in
//    VMEM. It walks the row block's columns in chunks of BN = 4096 / BM; for
//    each chunk its 256 threads hold a BM x BN tile in registers (4 x 4 per
//    thread) over K in steps of 16 staged through shared memory, then park
//    the tile in the row accumulator. The epilogue gives each warp whole
//    rows: lanes sum z^2 over the row, reduce by shuffles, and write the
//    scaled row. 4 * BM * N + 64 * (BN + BM + 4) bytes <= 227 KB, so N <=
//    10400 at BM = 4. It runs on the f32 CUDA cores (67 TF/s), which f32
//    parity needs (no TF32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// ffma: whole rows of f32 in shared memory, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBK = 16;           // depth of one shared-memory stage
constexpr int kTileElems = 4096;  // BM * BN: 256 threads x 4 x 4 outputs
constexpr int kPad = 4;           // keeps the transposed a-tile stores apart
constexpr int kMaxSmem = 232448;  // 227 KB: the most a CTA may opt in to

using hopper::last_to_arrive;
using hopper::store;
using hopper::store2;
using hopper::to_f32;

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
cudaError_t launch_ffma(const void* a, const void* b, const float* scale,
                        void* out, int M, int N, int K, int ldb, float eps,
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
cudaError_t dispatch_ffma(const void* a, const void* b, const float* scale,
                          void* out, int M, int N, int K, int ldb, int bm,
                          float eps, cudaStream_t stream) {
  switch (bm) {
    case 64:
      return launch_ffma<TIn, TOut, 64>(a, b, scale, out, M, N, K, ldb, eps,
                                        stream);
    case 32:
      return launch_ffma<TIn, TOut, 32>(a, b, scale, out, M, N, K, ldb, eps,
                                        stream);
    case 16:
      return launch_ffma<TIn, TOut, 16>(a, b, scale, out, M, N, K, ldb, eps,
                                        stream);
    case 8:
      return launch_ffma<TIn, TOut, 8>(a, b, scale, out, M, N, K, ldb, eps,
                                       stream);
    case 4:
      return launch_ffma<TIn, TOut, 4>(a, b, scale, out, M, N, K, ldb, eps,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// splitk: decode rows, split along K and N, reduced by the last CTA
// ---------------------------------------------------------------------------

constexpr int kSkThreads = 256;
constexpr int kSkCols = 16;        // threads along N, one 16-byte load each
constexpr int kSkLanes = 16;       // threads along K
constexpr int kSkUnroll = 8;       // b loads in flight per thread
constexpr int kSkMaxSlice = 256;   // deepest K slice (a strip in smem)
constexpr int kSkBatch = 32;       // partial loads in flight at the end
constexpr int kSkMaxBlocks = 64;   // column blocks, fewer than the SMs

template <typename T>
struct Lanes;
template <>
struct Lanes<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void widen(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void widen(const uint4& v, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 q = __bfloat1622float2(p[i]);
      f[2 * i] = q.x;
      f[2 * i + 1] = q.y;
    }
  }
};

template <typename TIn>
__host__ __device__ constexpr int splitk_cols() {
  return kSkCols * Lanes<TIn>::kVec;
}

template <typename TIn, int MT>
size_t splitk_smem(int kslice) {
  return sizeof(float) * ((size_t)MT * kslice +
                          (size_t)(kSkThreads / 32) * MT * splitk_cols<TIn>());
}

// Grid (ceil(N / BN), S); work = [S][M][N] partials and [nb][M] row sums of
// squares (f32); tickets = nb + 2 ints, 0 between launches.
template <typename TIn, typename TOut, int MT>
__global__ void __launch_bounds__(kSkThreads)
    splitk_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                  const float* __restrict__ scale, TOut* __restrict__ out,
                  float* __restrict__ work, int* tickets, int M, int N, int K,
                  int ldb, int kslice, float eps) {
  constexpr int kVec = Lanes<TIn>::kVec;
  constexpr int BN = splitk_cols<TIn>();
  constexpr int kWarps = kSkThreads / 32;
  const int nb = gridDim.x, splits = gridDim.y;
  const int j = blockIdx.x, s = blockIdx.y;
  float* part = work;
  float* ssbuf = part + (size_t)splits * M * N;
  extern __shared__ float smem[];
  float* a_s = smem;                        // [MT][kslice]
  float* red = a_s + MT * kslice;           // [warps][MT][BN]
  __shared__ float row_ss[MT];
  __shared__ float inv_s[MT];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = tid % kSkCols, r = tid / kSkCols;
  const int k0 = s * kslice;
  const int klen = min(kslice, K - k0);
  const int n0 = j * BN;
  const int n = n0 + c * kVec;
  const bool col_ok = n < N;

  // b's first loads go out before a's strip lands, so the two latencies
  // overlap
  uint4 v[kSkUnroll];
  auto load_b = [&](int kb) {
#pragma unroll
    for (int u = 0; u < kSkUnroll; ++u) {
      const int k = kb + u * kSkLanes;
      v[u] = (col_ok && k < klen)
                 ? __ldg(reinterpret_cast<const uint4*>(
                       b + (size_t)(k0 + k) * ldb + n))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load_b(r);
  for (int e = tid; e < MT * kslice; e += kSkThreads) {
    const int m = e / kslice, k = e % kslice;
    a_s[e] = (m < M && k < klen) ? to_f32(a[(size_t)m * K + k0 + k]) : 0.f;
  }
  __syncthreads();

  float acc[MT][kVec];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int q = 0; q < kVec; ++q) acc[m][q] = 0.f;
  for (int kb = r; kb < klen; kb += kSkLanes * kSkUnroll) {
    if (kb != r) load_b(kb);
#pragma unroll
    for (int u = 0; u < kSkUnroll; ++u) {
      const int k = kb + u * kSkLanes;
      if (k >= klen) break;
      float bv[kVec];
      Lanes<TIn>::widen(v[u], bv);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float am = a_s[m * kslice + k];
#pragma unroll
        for (int q = 0; q < kVec; ++q) acc[m][q] = fmaf(am, bv[q], acc[m][q]);
      }
    }
  }
  // the two K lanes of a warp, then the warps, in a fixed order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int q = 0; q < kVec; ++q)
      acc[m][q] += __shfl_xor_sync(0xffffffffu, acc[m][q], 16);
  if (lane < kSkCols) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < kVec; ++q)
        red[(warp * MT + m) * BN + c * kVec + q] = acc[m][q];
  }
  __syncthreads();
  for (int e = tid; e < MT * BN; e += kSkThreads) {
    const int m = e / BN, col = n0 + e % BN;
    if (m >= M || col >= N) continue;
    float z = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) z += red[(w * MT + m) * BN + e % BN];
    part[((size_t)s * M + m) * N + col] = z;
  }

  // the last of the column block's S CTAs sums their partials
  if (!last_to_arrive(&tickets[j], splits, &last)) return;
  // a thread takes 4 columns of a row (N % 4 == 0), so a row of the block
  // is one warp (bf16, 32 x 4 columns) or half of one (f32, 16 x 4), and
  // every split's partial is loaded before any is added; z stays in
  // registers until the row sums are known
  constexpr int kQuads = BN / 4;
  constexpr int kIters = (MT * kQuads + kSkThreads - 1) / kSkThreads;
  constexpr int kBatch = MT >= 16 ? kSkBatch / 2 : kSkBatch;  // registers
  const size_t split_quads = (size_t)M * N / 4;
  float4 z[kIters];
  float g[kIters][4];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = tid + it * kSkThreads;
    const int m = e / kQuads, col = n0 + 4 * (e % kQuads);
    z[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e >= MT * kQuads) break;         // whole warps: MT * kQuads % 32 == 0
    if (m < M && col < N) {
#pragma unroll
      for (int i = 0; i < 4; ++i) g[it][i] = 1.f + scale[col + i];
      const float4* p =
          reinterpret_cast<const float4*>(part + (size_t)m * N + col);
      for (int t0 = 0; t0 < splits; t0 += kBatch) {
        float4 pv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (t0 + u < splits) pv[u] = __ldcg(p + (t0 + u) * split_quads);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (t0 + u >= splits) break;
          z[it].x += pv[u].x;
          z[it].y += pv[u].y;
          z[it].z += pv[u].z;
          z[it].w += pv[u].w;
        }
      }
    }
    float q = z[it].x * z[it].x + z[it].y * z[it].y + z[it].z * z[it].z +
              z[it].w * z[it].w;
#pragma unroll
    for (int off = kQuads / 2; off > 0; off >>= 1)
      q += __shfl_xor_sync(0xffffffffu, q, off);
    if (e % kQuads == 0) row_ss[m] = q;
  }
  __syncthreads();
  if (tid < M) ssbuf[(size_t)j * M + tid] = row_ss[tid];

  // every column block's finisher publishes its rows' sums of squares and
  // waits for the other nb - 1. Only finishers wait, and a finisher exists
  // once its block's other CTAs have run to their end, so at most nb - 1
  // CTAs hold an SM while the rest of the grid still needs one: with
  // nb < the SM count (the launcher refuses nb > 64), every CTA gets
  // to run.
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    atomicAdd(&tickets[nb], 1);
    int seen = 0;
    while (seen < nb)
      asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n"
                   : "=r"(seen) : "l"(&tickets[nb]) : "memory");
  }
  __syncthreads();
  if (tid < M) {
    float ss = 0.f;
#pragma unroll 8
    for (int q = 0; q < nb; ++q) ss += __ldcg(&ssbuf[(size_t)q * M + tid]);
    inv_s[tid] = rsqrtf(ss / (float)N + eps);
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = tid + it * kSkThreads;
    const int m = e / kQuads, col = n0 + 4 * (e % kQuads);
    if (e >= MT * kQuads || m >= M || col >= N) break;
    const float inv = inv_s[m];
    TOut* o = out + (size_t)m * N + col;
    store2(o, z[it].x * inv * g[it][0], z[it].y * inv * g[it][1]);
    store2(o + 2, z[it].z * inv * g[it][2], z[it].w * inv * g[it][3]);
  }
  // the counters back to 0 for the next launch, after the stores: no CTA
  // of this launch reads this block's ticket again, and the last finisher
  // to leave has seen every other one pass the wait
  if (tid == 0) {
    tickets[j] = 0;
    if (atomicAdd(&tickets[nb + 1], 1) == nb - 1) {
      tickets[nb] = 0;
      tickets[nb + 1] = 0;
    }
  }
}

template <typename TIn, typename TOut, int MT>
cudaError_t launch_splitk(const void* a, const void* b, const float* scale,
                          void* out, float* work, int* tickets, int M, int N,
                          int K, int ldb, int kslice, float eps,
                          cudaStream_t stream) {
  constexpr int kVec = Lanes<TIn>::kVec;
  if (M > MT || kslice < kSkLanes || kslice > kSkMaxSlice ||
      kslice % kSkLanes != 0 || ldb % kVec != 0 || N % kVec != 0 ||
      (N + splitk_cols<TIn>() - 1) / splitk_cols<TIn>() > kSkMaxBlocks ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return cudaErrorInvalidValue;
  static bool attr_set = false;        // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        splitk_kernel<TIn, TOut, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)splitk_smem<TIn, MT>(kSkMaxSlice));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((N + splitk_cols<TIn>() - 1) / splitk_cols<TIn>(),
                  (K + kslice - 1) / kslice);
  splitk_kernel<TIn, TOut, MT>
      <<<grid, kSkThreads, splitk_smem<TIn, MT>(kslice), stream>>>(
          static_cast<const TIn*>(a), static_cast<const TIn*>(b), scale,
          static_cast<TOut*>(out), work, tickets, M, N, K, ldb, kslice, eps);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t dispatch_splitk(int mt, const void* a, const void* b,
                            const float* scale, void* out, float* work,
                            int* tickets, int M, int N, int K, int ldb,
                            int kslice, float eps, cudaStream_t stream) {
  switch (mt) {
    case 4:
      return launch_splitk<TIn, TOut, 4>(a, b, scale, out, work, tickets, M,
                                         N, K, ldb, kslice, eps, stream);
    case 8:
      return launch_splitk<TIn, TOut, 8>(a, b, scale, out, work, tickets, M,
                                         N, K, ldb, kslice, eps, stream);
    case 16:
      return launch_splitk<TIn, TOut, 16>(a, b, scale, out, work, tickets, M,
                                          N, K, ldb, kslice, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// wgmma: the Hopper mainloop with a norm epilogue across a cluster
// ---------------------------------------------------------------------------

template <typename TOut>
struct NormEpilogue {
  TOut* out;
  const float* scale;
  int M, N;
  float eps;

  // the producer warpgroup matches the consumers' two cluster barriers
  __device__ void idle() const {
    hopper::cluster_sync();
    hopper::cluster_sync();
  }

  template <int R>
  __device__ void consume(float (&d)[R], hopper::Frag f, int m0, int n0,
                          float* row_ss) const {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      s0 = fmaf(d[4 * i], d[4 * i], s0);
      s0 = fmaf(d[4 * i + 1], d[4 * i + 1], s0);
      s1 = fmaf(d[4 * i + 2], d[4 * i + 2], s1);
      s1 = fmaf(d[4 * i + 3], d[4 * i + 3], s1);
    }
    // the quad of lanes that shares the two rows
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (threadIdx.x % 4 == 0) {
      row_ss[f.row0] = s0;
      row_ss[f.row0 + 8] = s1;
    }
    hopper::cluster_sync();
    // every CTA of the cluster adds the same partials in rank order
    const uint32_t ranks = hopper::cluster_size();
    float t0 = 0.f, t1 = 0.f;
    for (uint32_t q = 0; q < ranks; ++q) {
      t0 += hopper::ld_cluster(&row_ss[f.row0], q);
      t1 += hopper::ld_cluster(&row_ss[f.row0 + 8], q);
    }
    hopper::cluster_sync();
    const float inv0 = rsqrtf(t0 / (float)N + eps);
    const float inv1 = rsqrtf(t1 / (float)N + eps);
    const int r0 = m0 + f.row0, r1 = r0 + 8;
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const int col = n0 + f.col0 + 8 * i;
      if (col >= N) continue;     // N % 8 == 0: a pair is in or out whole
      const float g0 = 1.f + scale[col], g1 = 1.f + scale[col + 1];
      if (r0 < M)
        store2(&out[(size_t)r0 * N + col], d[4 * i] * inv0 * g0,
               d[4 * i + 1] * inv0 * g1);
      if (r1 < M)
        store2(&out[(size_t)r1 * N + col], d[4 * i + 2] * inv1 * g0,
               d[4 * i + 3] * inv1 * g1);
    }
  }
};

template <typename TOut>
cudaError_t launch_wgmma(const void* a, const void* b, const float* scale,
                         void* out, int M, int N, int K, int ldb, int bm,
                         int bn, int cluster, float eps, cudaStream_t stream) {
  if (N % 8 != 0 || (N + bn - 1) / bn != cluster)  // a cluster: whole rows
    return cudaErrorInvalidValue;
  const NormEpilogue<TOut> ep{static_cast<TOut*>(out), scale, M, N, eps};
  return hopper::launch_tiled(bm, bn, a, b, M, N, K, ldb, cluster, ep,
                              stream);
}

template <typename TIn, typename TOut>
cudaError_t dispatch(int variant, const void* a, const void* b,
                     const float* scale, void* out, float* work, int* tickets,
                     int M, int N, int K, int ldb, int bm, int bn, int cluster,
                     int kslice, float eps, cudaStream_t stream) {
  switch (variant) {
    case 0:
      return dispatch_ffma<TIn, TOut>(a, b, scale, out, M, N, K, ldb, bm, eps,
                                      stream);
    case 1:
      if constexpr (sizeof(TIn) == 2)
        return launch_wgmma<TOut>(a, b, scale, out, M, N, K, ldb, bm, bn,
                                  cluster, eps, stream);
      return cudaErrorInvalidValue;      // wgmma here is bf16 only
    case 2:
      return dispatch_splitk<TIn, TOut>(bm, a, b, scale, out, work, tickets,
                                        M, N, K, ldb, kslice, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// variant: 0 = ffma (bm: rows per CTA, 4..64), 1 = wgmma (bm 64 or 128 rows
// and bn 64/128/256 columns a CTA, `cluster` = ceil(N / bn) CTAs a row),
// 2 = splitk (bm: the row bound 4, 8 or 16 >= M; kslice: the K depth of a
// CTA; work and tickets as splitk_kernel says). in_dtype, out_dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int matmul_rmsnorm_fwd(const void* a, const void* b, const void* scale,
                       void* out, void* work, void* tickets, int M, int N,
                       int K, int ldb, int variant, int bm, int bn,
                       int cluster, int kslice, float eps, int in_dtype,
                       int out_dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || ldb < N || (in_dtype != 0 && in_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* w = static_cast<float*>(work);
  int* t = static_cast<int*>(tickets);
  if (in_dtype == 0)
    return out_dtype == 0
               ? (int)dispatch<float, float>(variant, a, b, sc, out, w, t, M,
                                             N, K, ldb, bm, bn, cluster,
                                             kslice, eps, st)
               : (int)dispatch<float, __nv_bfloat16>(variant, a, b, sc, out,
                                                     w, t, M, N, K, ldb, bm,
                                                     bn, cluster, kslice, eps,
                                                     st);
  return out_dtype == 0
             ? (int)dispatch<__nv_bfloat16, float>(variant, a, b, sc, out, w,
                                                   t, M, N, K, ldb, bm, bn,
                                                   cluster, kslice, eps, st)
             : (int)dispatch<__nv_bfloat16, __nv_bfloat16>(
                   variant, a, b, sc, out, w, t, M, N, K, ldb, bm, bn,
                   cluster, kslice, eps, st);
}

const char* matmul_rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
