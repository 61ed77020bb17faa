// Flash attention forward for NVIDIA Hopper (sm_90a), bound to Python through
// a plain C interface (ctypes; see repro_torch/kernels/flash_attention.py).
//
// Replaces: src/repro/kernels/flash_attention.py `_flash_kernel` (the Pallas
// TPU kernel). It computes the same function -- softmax(q k^T * scale) v with
// an online softmax over KV tiles and f32 running (max, sum, acc) -- but takes
// the mask from explicit positions, as the model's attention_core does
// (src/repro/models/attention.py): key j is visible to query i iff
//   kv_pos[j] >= 0  &&  (!causal || ((kv_pos[j] <= q_pos[i]
//                                     || (kv_pos[j] < prefix && q_pos[i] < prefix))
//                                    && (window == 0 || kv_pos[j] > q_pos[i] - window))),
// prefix the prefix-LM prefix (bidirectional among its positions; 0: none);
// the window applies after the prefix's OR, as in JAX.
// The TPU kernel's own case (top-left causal over (BH, S, d)) is positions =
// arange with H = Hkv = 1.
//
// Layout: q/out (B, Sq, H, dh) and (B, Sq, H, dv), k (B, Skv, Hkv, dh),
// v (B, Skv, Hkv, dv) with dv <= dh, positions int32 (B, Sq) and (B, Skv);
// all contiguous. GQA: query head h reads kv head h / G, G = H / Hkv.
// A row none of whose keys is visible (a padding query, q_pos = -1 under the
// causal mask) has l = 0: it is written as zeros, never divided by l.
//
// Three variants behind one entry point; the wrapper's `plan` picks one:
//
// 1. wgmma (bf16, more than 16 query rows per kv head, (dh, dv) one of the
//    instantiated pairs, TMA-able bases). Prefill, the TP attention core and
//    the MLA prefill are bound by the tensor-core operations
//    (4 (dh + dv) / 2 flops per visible (query, key) pair), which bf16 wgmma
//    serves at 989 TF/s. An FA2/FA3-style forward: a CTA takes 128 query
//    rows of ONE head (grid (H, B, q tiles), the last q tiles -- the longest
//    under the causal mask -- launched first). Its third warpgroup is the
//    producer: one warp loads the Q tile once and then K and V tiles of BN
//    keys into a ring of kWgStages stages by TMA on full/empty mbarriers.
//    q, k, v are read through 4-D tensor maps (dh, heads, S, B), so a box of
//    64 columns x BM or BN rows never crosses a head or a batch row: rows
//    past Sq or Skv load as TMA's zero fill (and are masked or not stored),
//    and dh 96 fills its second 64-column box with 32 zero columns that the
//    wgmma k-steps never read. Before it loads a tile the producer reads the
//    tile's key positions and skips it unless some key may be visible to
//    some row of the CTA (a conservative test on the rows' least and
//    greatest position: the causal diagonal, the window, the end of each
//    context; a tile with a key of the prefix is live for a CTA with a row
//    in the prefix); it hands the positions to the consumers in shared
//    memory.
//    Two consumer warpgroups own 64 query rows each:
//      S = Q K^T by wgmma m64nBNk16 (K as stored is K-major: the plain B);
//      the mask from positions on the f32 accumulator fragments; the online
//      softmax in registers in the log2 domain (scale * log2 e folded in),
//      each row's max reduced over the 4 lanes that hold it by shuffles, the
//      -inf - -inf case guarded by a `live` flag; P rounded to bf16 in
//      registers -- as JAX's model rounds p to v's type before p @ v -- and
//      used as the register-A operand of O += P V (V as stored is N-major:
//      the transposed B, imm-trans-b 1, as hopper_gemm.cuh reads b). O stays
//      in f32 registers, rescaled per tile; the epilogue writes O / l, or
//      zeros where l = 0. v is read at its own dv, so MLA's v needs no pad.
//    The three instantiated tiles (FLASH_WGMMA_TILE below): dh 256 / dv 256
//    (gemma3-1b) with BN 64 (O alone is 128 f32 registers a thread), dh 128
//    / dv 128 (the internlm2-1.8b TP core) and dh 96 / dv 64 (minicpm3-4b)
//    with BN 128. Registers: 2 x 128 consumer threads at 232 and the
//    producer at 40 (setmaxnreg).
// 2. splitkv (decode: Sq * G <= 16 query rows per kv head; bf16 or f32; dh,
//    dv <= 256 in 16-byte vectors). Bound by the K/V bytes, so the grid has
//    to cover the card: (splits, Hkv, B) CTAs, the wrapper choosing splits
//    from Skv and the 132 SMs, each CTA a range of kchunk keys. A CTA keeps
//    its rows' q in shared memory (f32, pre-scaled), streams its keys in
//    tiles of 32 with 16-byte cp.async loads, double-buffered (the next
//    live tile loads while this one is computed), skips tiles no row may
//    see (a sliding window skips whole splits), and runs the online softmax
//    on the f32 CUDA cores. It writes its f32 partial (m, l, acc[dv]) per
//    row to a workspace the wrapper keeps; the last CTA of a (b, kv head) to
//    arrive (an atomic ticket, reset to 0 by that CTA, so no zeroing launch)
//    merges the partials in split order -- the result does not depend on
//    which CTA arrives last -- and writes O. A split with no visible key
//    contributes m = -inf, l = 0 and is weighted 0, never NaN. One split
//    writes O directly. The merge is in the same launch rather than a second
//    one: a decode step's call is a few microseconds, and a second launch
//    would add its own launch latency to every call.
// 3. ffma (f32 prefill, and anything the others cannot take: dh not a
//    multiple of 8, dh > 256, bases off 16 bytes, other (dh, dv) pairs).
//    The kernel of the port's first slice: 128 threads, TPR lanes per query
//    row (32, 8 or 4 by the rows), 32-key tiles widened to f32 in shared
//    memory, every product on the f32 CUDA cores (no TF32, which f32 parity
//    needs), the G heads of a kv head side by side so that one K/V tile
//    serves all of them. It takes v at dh: the wrapper pads a narrower v.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using hopper::last_to_arrive;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::store2;
using hopper::sw128_desc;
using hopper::tma_load_4d;

constexpr int kMaxSmem = 232448;  // 227 KB: the most a CTA may opt in to
constexpr float kLog2e = 1.4426950408889634f;

// The mask (see the top of the file): causal or not, a sliding window (0:
// none), a prefix-LM prefix (0: none). Passed by value to every kernel.
struct Mask {
  int causal, window, prefix;
};

// The keys visible to a query at position qp (see the top of the file) as
// one range, lo < kp <= hi: the causal limit is the query's position, or the
// prefix's last position for a query inside the prefix (kp <= qp || both in
// the prefix); the window raises lo above qp - window; without the causal
// mask every key >= 0. A kernel computes a row's range once, so the mask
// costs two compares a score whatever its terms.
struct KeyRange {
  int lo, hi;
};

__device__ __forceinline__ KeyRange key_range(int qp, Mask m) {
  if (!m.causal) return {-1, INT_MAX};
  return {m.window ? max(qp - m.window, -1) : -1,
          qp < m.prefix ? m.prefix - 1 : qp};
}

__device__ __forceinline__ bool in_range(int kp, KeyRange r) {
  return kp > r.lo && kp <= r.hi;
}

// A key is visible to a query at position qp.
__device__ __forceinline__ bool visible(int kp, int qp, Mask m) {
  return in_range(kp, key_range(qp, m));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  h[0] = __floats2bfloat162_rn(x.x, x.y);
  h[1] = __floats2bfloat162_rn(x.z, x.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// q[0..8) . k[0..8) with k read by one 16-byte load (8 bf16) or two
// (f32): a quarter warp reading 8 rows at a stride of 16 bytes more than a
// multiple of 128 meets no bank conflict
__device__ __forceinline__ float dot8(const float* q, const float* k) {
  return dot4(load4(q), load4(k)) + dot4(load4(q + 4), load4(k + 4));
}

__device__ __forceinline__ float dot8(const float* q,
                                      const __nv_bfloat16* k) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  const float4 q0 = load4(q), q1 = load4(q + 4);
  return q0.x * a.x + q0.y * a.y + q0.z * b.x + q0.w * b.y + q1.x * c.x +
         q1.y * c.y + q1.z * d.x + q1.w * d.y;
}

__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

__device__ __forceinline__ void fma4(float4& acc, float p, float4 y) {
  acc.x += p * y.x;
  acc.y += p * y.y;
  acc.z += p * y.z;
  acc.w += p * y.w;
}

// ===========================================================================
// 1. ffma: the first slice's kernel (f32 prefill, odd layouts)
// ===========================================================================

constexpr int kThreads = 128;    // threads per CTA
constexpr int kTileKeys = 32;    // keys per K/V tile (TK)
constexpr int kFfmaMaxDh = 512;  // the widest head dim (two register sizes)

// Dynamic shared memory of one CTA of `rows` query rows at head dim dh: q
// (pre-scaled), a K and a V tile, all f32 at a padded row stride; the P
// tile; the rows' and the tile's positions.
size_t ffma_smem(int rows, int dh) {
  return 4 * ((size_t)rows * (dh + 4) + 2 * (size_t)kTileKeys * (dh + 4) +
              (size_t)rows * (kTileKeys + 1)) +
         4 * ((size_t)rows + kTileKeys);
}

// TPR threads share one query row: each scores TK/TPR keys of a tile and
// owns dh/(4*TPR) float4 columns of the row's accumulator (DMAX: the widest
// dh the instantiation holds in registers).
template <typename T, int TPR, int DMAX>
__global__ void __launch_bounds__(kThreads)
ffma_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ q_pos,
            const int* __restrict__ kv_pos, T* __restrict__ out, int Sq,
            int Skv, int H, int Hkv, int dh, Mask mask,
            float scale) {
  constexpr int R = kThreads / TPR;
  constexpr int KPT = kTileKeys / TPR;    // keys scored per thread
  constexpr int CPT = DMAX / 4 / TPR;     // float4 columns per thread (max)
  const int G = H / Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int tid = threadIdx.x, r = tid / TPR, lt = tid % TPR;
  const int ds = dh + 4, dh4 = dh / 4;

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // R x ds, pre-scaled
  float* sK = sQ + R * ds;                      // TK x ds
  float* sV = sK + kTileKeys * ds;              // TK x ds
  float* sP = sV + kTileKeys * ds;              // R x (TK + 1)
  int* sQpos = reinterpret_cast<int*>(sP + R * (kTileKeys + 1));
  int* sKpos = sQpos + R;

  // CTA row rr is global row row0 + rr = qi * G + g  ->  head hk * G + g.
  const int row0 = blockIdx.x * R;
  for (int e = tid; e < R * dh4; e += kThreads) {
    const int rr = e / dh4, c = e % dh4;
    const int row = row0 + rr, qi = row / G, h = hk * G + row % G;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < Sq)
      x = scale4(load4(q + (((size_t)b * Sq + qi) * H + h) * dh + 4 * c),
                 scale);
    store4(sQ + rr * ds + 4 * c, x);
  }
  for (int rr = tid; rr < R; rr += kThreads) {
    const int qi = (row0 + rr) / G;
    sQpos[rr] = qi < Sq ? q_pos[(size_t)b * Sq + qi] : -1;
  }
  __syncthreads();

  const int my_qi = (row0 + r) / G;
  const bool row_in = my_qi < Sq;
  const KeyRange my_keys = key_range(sQpos[r], mask);
  const float* qrow = sQ + r * ds;
  float* prow = sP + r * (kTileKeys + 1);

  float m = -INFINITY, l = 0.f;
  float4 acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kv0 = 0; kv0 < Skv; kv0 += kTileKeys) {
    if (tid < kTileKeys)
      sKpos[tid] = kv0 + tid < Skv ? kv_pos[(size_t)b * Skv + kv0 + tid] : -1;
    __syncthreads();
    bool valid[KPT];
    bool any = false;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      valid[i] = row_in && in_range(sKpos[lt + TPR * i], my_keys);
      any = any || valid[i];
    }
    // skip a tile no row of this CTA may see (context end, window, diagonal)
    if (!__syncthreads_or(any)) continue;

    for (int e = tid; e < kTileKeys * dh4; e += kThreads) {
      const int j = e / dh4, c = e % dh4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kv0 + j < Skv) {
        const size_t off = (((size_t)b * Skv + kv0 + j) * Hkv + hk) * dh + 4 * c;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      store4(sK + j * ds + 4 * c, kx);
      store4(sV + j * ds + 4 * c, vx);
    }
    __syncthreads();

    // scores of this thread's keys, then the row max over the TPR lanes
    float s[KPT];
    float mt = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float* krow = sK + (lt + TPR * i) * ds;
      float a0 = 0.f, a1 = 0.f;
      int c = 0;
      for (; c + 1 < dh4; c += 2) {
        a0 += dot4(load4(qrow + 4 * c), load4(krow + 4 * c));
        a1 += dot4(load4(qrow + 4 * c + 4), load4(krow + 4 * c + 4));
      }
      if (c < dh4) a0 += dot4(load4(qrow + 4 * c), load4(krow + 4 * c));
      s[i] = valid[i] ? a0 + a1 : -INFINITY;
      mt = fmaxf(mt, s[i]);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));

    const float m_new = fmaxf(m, mt);
    const bool live = m_new != -INFINITY;  // some key of the row seen so far
    const float alpha = live ? expf(m - m_new) : 1.f;  // expf(-inf) = 0
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = (live && valid[i]) ? expf(s[i] - m_new) : 0.f;
      prow[lt + TPR * i] = p;
      psum += p;
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's TPR lanes lie in one warp: its P row is ready

#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[i] = scale4(acc[i], alpha);
    for (int j = 0; j < kTileKeys; ++j) {
      const float p = prow[j];
      const float* vrow = sV + j * ds;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = lt + TPR * i;
        if (c < dh4) fma4(acc[i], p, load4(vrow + 4 * c));
      }
    }
    __syncthreads();  // sK/sV/sKpos are rewritten by the next tile
  }

  if (row_in) {
    const int h = hk * G + (row0 + r) % G;
    T* orow = out + (((size_t)b * Sq + my_qi) * H + h) * dh;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // fully masked row -> zeros
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = lt + TPR * i;
      if (c < dh4) store4(orow + 4 * c, scale4(acc[i], inv));
    }
  }
}

template <typename T, int TPR, int DMAX>
cudaError_t launch_ffma(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, void* out, int B,
                        int Sq, int Skv, int H, int Hkv, int dh, Mask mask,
                        float scale, cudaStream_t stream) {
  constexpr int R = kThreads / TPR;
  const size_t smem = ffma_smem(R, dh);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ffma_kernel<T, TPR, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long rows = (long)Sq * (H / Hkv);
  dim3 grid((unsigned)((rows + R - 1) / R), (unsigned)Hkv, (unsigned)B);
  ffma_kernel<T, TPR, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), Sq, Skv,
      H, Hkv, dh, mask, scale);
  return cudaGetLastError();
}

// rows: the query rows a CTA takes (the wrapper's plan): 4, 16 or 32
template <typename T, int DMAX>
cudaError_t dispatch_ffma_rows(int rows, const void* q, const void* k,
                               const void* v, const int* qp, const int* kp,
                               void* out, int B, int Sq, int Skv, int H,
                               int Hkv, int dh, Mask mask,
                               float scale, cudaStream_t st) {
  switch (rows) {
    case 4:
      return launch_ffma<T, 32, DMAX>(q, k, v, qp, kp, out, B, Sq, Skv, H,
                                      Hkv, dh, mask, scale, st);
    case 16:
      return launch_ffma<T, 8, DMAX>(q, k, v, qp, kp, out, B, Sq, Skv, H,
                                     Hkv, dh, mask, scale, st);
    case 32:
      return launch_ffma<T, 4, DMAX>(q, k, v, qp, kp, out, B, Sq, Skv, H,
                                     Hkv, dh, mask, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_ffma(int rows, const void* q, const void* k,
                          const void* v, const int* qp, const int* kp,
                          void* out, int B, int Sq, int Skv, int H, int Hkv,
                          int dh, Mask mask, float scale,
                          cudaStream_t st) {
  if (dh % 4 != 0 || dh > kFfmaMaxDh) return cudaErrorInvalidValue;
  if (dh <= 256)
    return dispatch_ffma_rows<T, 256>(rows, q, k, v, qp, kp, out, B, Sq, Skv,
                                      H, Hkv, dh, mask, scale, st);
  return dispatch_ffma_rows<T, kFfmaMaxDh>(rows, q, k, v, qp, kp, out, B, Sq,
                                           Skv, H, Hkv, dh, mask,
                                           scale, st);
}

// ===========================================================================
// 2. wgmma: TMA + wgmma bf16 forward (prefill, the TP core, MLA prefill)
// ===========================================================================

constexpr int kWgBM = 128;       // query rows a CTA: two consumer warpgroups
constexpr int kWgStages = 2;     // K/V ring depth
constexpr int kWgThreads = 384;  // two consumer warpgroups + the producer

// Dynamic shared memory of one CTA: the Q tile and kWgStages K/V stages, in
// 64-column boxes of 128-byte rows, plus 1 KB to align them to the
// swizzle's 1024-byte period.
__host__ __device__ constexpr int wgmma_smem(int dh, int dv, int bn) {
  return 2 * 64 * ((dh + 63) / 64 * (kWgBM + kWgStages * bn) +
                   (dv + 63) / 64 * kWgStages * bn) +
         1024;
}

// m64nNk16, bf16 x bf16 -> f32. SS: a (K-major) and b (K-major, the plain
// B: imm-trans-b 0) from shared memory, d scaled by scale_d (0: d = a b).
// RS: a from registers (four b32 of two bf16 each, the m16n8k16 A fragment
// of each warp's 16 rows), b N-major (imm-trans-b 1), d += a b.
template <int N>
struct WgmmaSS;
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
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
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<256> {
  static __device__ __forceinline__ void mma(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
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
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared-memory plan of one (DH, DV, BN) instantiation, in bf16 elements.
template <int DH, int DV, int BN>
struct WgLayout {
  static constexpr int kDhBoxes = (DH + 63) / 64;
  static constexpr int kDvBoxes = (DV + 63) / 64;
  static constexpr int kQ = kWgBM * 64 * kDhBoxes;      // box c at c*BM*64
  static constexpr int kK = BN * 64 * kDhBoxes;         // box c at c*BN*64
  static constexpr int kV = BN * 64 * kDvBoxes;
  static constexpr int kStage = kK + kV;                // K, then V
  static constexpr uint32_t kQBytes = kQ * 2;
  static constexpr uint32_t kStageBytes = kStage * 2;
  static_assert(wgmma_smem(DH, DV, BN) ==
                    (kQ + kWgStages * kStage) * 2 + 1024,
                "wgmma_smem is the layout's size");
  static_assert(DH % 16 == 0 && DV % 8 == 0 && DV <= DH, "wgmma shapes");
};

// Grid (H, B, ceil(Sq / 128)); the maps are q (dh, H, Sq, B), k (dh, Hkv,
// Skv, B), v (dv, Hkv, Skv, B) in boxes of 64 x 1 x rows x 1.
template <int DH, int DV, int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos,
                 __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                 int Hkv, Mask mask, float scale_log2) {
  using L = WgLayout<DH, DV, BN>;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* skv = sq + L::kQ;
  __shared__ __align__(8) uint64_t full[kWgStages];
  __shared__ __align__(8) uint64_t empty[kWgStages];
  __shared__ __align__(8) uint64_t qbar;
  __shared__ int kpos[kWgStages][BN];  // the stage's key positions
  __shared__ int live[kWgStages];      // 1: a tile; 0: no more tiles

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWgBM;  // longest first
  const int hk = h / (H / Hkv);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer warpgroup: its first warp loads ----------
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x < 2 * 128 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(&qbar, L::kQBytes);
#pragma unroll
        for (int c = 0; c < L::kDhBoxes; ++c)
          tma_load_4d(sq + c * kWgBM * 64, &map_q, &qbar, 64 * c, h, q0, b);
      }
      // the least and greatest position of the CTA's query rows
      int qlo = INT_MAX, qhi = -1;
      for (int r = lane; r < kWgBM; r += 32) {
        const int qi = q0 + r;
        const int p = qi < Sq ? q_pos[(size_t)b * Sq + qi] : -1;
        if (p >= 0) {
          qlo = min(qlo, p);
          qhi = max(qhi, p);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        qlo = min(qlo, __shfl_xor_sync(0xffffffffu, qlo, o));
        qhi = max(qhi, __shfl_xor_sync(0xffffffffu, qhi, o));
      }
      int s = 0;
      uint32_t phase = 0;
      const int tiles = (Skv + BN - 1) / BN;
      for (int t = 0; t < tiles; ++t) {
        int kp[BN / 32];
        bool any = false;
#pragma unroll
        for (int i = 0; i < BN / 32; ++i) {
          const int j = t * BN + lane + 32 * i;
          kp[i] = j < Skv ? kv_pos[(size_t)b * Skv + j] : -1;
          // some row may see key j: the rows' positions span [qlo, qhi]; a
          // key of the prefix is live for a CTA that holds a prefix row
          any = any ||
                (kp[i] >= 0 &&
                 (!mask.causal ||
                  ((kp[i] <= qhi ||
                    (kp[i] < mask.prefix && qlo < mask.prefix)) &&
                   (mask.window == 0 || kp[i] > qlo - mask.window))));
        }
        if (!__any_sync(0xffffffffu, any)) continue;
        mbar_wait(&empty[s], phase ^ 1);
#pragma unroll
        for (int i = 0; i < BN / 32; ++i) kpos[s][lane + 32 * i] = kp[i];
        if (lane == 0) live[s] = 1;
        __syncwarp();
        if (lane == 0) {
          __nv_bfloat16* kt = skv + s * L::kStage;
          mbar_expect_tx(&full[s], L::kStageBytes);
#pragma unroll
          for (int c = 0; c < L::kDhBoxes; ++c)
            tma_load_4d(kt + c * BN * 64, &map_k, &full[s], 64 * c, hk,
                        t * BN, b);
#pragma unroll
          for (int c = 0; c < L::kDvBoxes; ++c)
            tma_load_4d(kt + L::kK + c * BN * 64, &map_v, &full[s], 64 * c,
                        hk, t * BN, b);
        }
        if (++s == kWgStages) {
          s = 0;
          phase ^= 1;
        }
      }
      mbar_wait(&empty[s], phase ^ 1);
      if (lane == 0) {
        live[s] = 0;
        mbar_arrive(&full[s]);   // no bytes: the phase completes at once
      }
    }
  } else {
    // ---------------- consumer warpgroups: 64 query rows each ------------
    hopper::setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row0 = wg * 64 + 16 * warp + lane / 4;  // and row0 + 8
    const int c2 = 2 * (lane % 4);
    KeyRange keys[2];   // rows row0 and row0 + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + row0 + 8 * r;
      keys[r] = key_range(qi < Sq ? q_pos[(size_t)b * Sq + qi] : -1, mask);
    }
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const __nv_bfloat16* qa = sq + wg * 64 * 64;
    mbar_wait(&qbar, 0);

    int s = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(&full[s], phase);
      if (!live[s]) break;
      const __nv_bfloat16* kt = skv + s * L::kStage;
      const __nv_bfloat16* vt = kt + L::kK;

      // S = Q K^T: dh / 16 k-steps; box kk / 4, 32 bytes a step within it
      float sc[BN / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint64_t da = sw128_desc(
            qa + (kk / 4) * kWgBM * 64 + (kk % 4) * 16, 16, 1024);
        const uint64_t db = sw128_desc(
            kt + (kk / 4) * BN * 64 + (kk % 4) * 16, 16, 1024);
        WgmmaSS<BN>::mma(sc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // the mask and the row max; sc[4i + e] is row row0 + 8 (e / 2),
      // column 8i + c2 + e % 2
      const int* kp = kpos[s];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float x = in_range(kp[8 * i + c2 + (e & 1)], keys[r])
                              ? sc[4 * i + e] * scale_log2
                              : -INFINITY;
          sc[4 * i + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
      bool alive[2];
      float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alive[r] = m_new != -INFINITY;   // some key of the row seen so far
        alpha[r] = alive[r] ? exp2f(m[r] - m_new) : 1.f;  // exp2(-inf) = 0
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = alive[r] ? exp2f(sc[4 * i + e] - m[r]) : 0.f;
          sc[4 * i + e] = p;
          ps[r] += p;
        }
      }
      // l per thread over its own columns; the 4 lanes of a row are summed
      // at the end (alpha is the same on all four)
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        o[4 * i + 0] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
      // P in bf16 as the A fragment of each 16-key step: the accumulator's
      // layout is the A fragment's, so step t is sc[8t .. 8t + 7] in pairs
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int t = 0; t < BN / 16; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[t][j] = pack_bf16(sc[8 * t + 2 * j], sc[8 * t + 2 * j + 1]);

      // O += P V: 16 keys a step (16 rows of 128 bytes), the next 64
      // columns of V one box (BN rows) further
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < BN / 16; ++t)
        WgmmaRS<DV>::mma(o, pa[t],
                         sw128_desc(vt + t * 16 * 64, BN * 64 * 2, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == kWgStages) {
        s = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qi = q0 + row0 + 8 * r;
      if (qi >= Sq) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no key: zeros
      __nv_bfloat16* orow = out + (((size_t)b * Sq + qi) * H + h) * DV + c2;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i)
        store2(orow + 8 * i, o[4 * i + 2 * r] * inv,
               o[4 * i + 2 * r + 1] * inv);
    }
  }
}

template <int DH, int DV, int BN>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_pos, void* out,
                         int B, int Sq, int Skv, int H, int Hkv, Mask mask,
                         float scale, cudaStream_t stream) {
  if (!hopper::tma_ok(q, DH) || !hopper::tma_ok(k, DH) ||
      !hopper::tma_ok(v, DV))
    return cudaErrorInvalidValue;
  const uint32_t qbox[4] = {64, 1, kWgBM, 1}, kvbox[4] = {64, 1, BN, 1};
  CUtensorMap mq, mk, mv;
  cudaError_t err = hopper::make_map_4d(
      &mq, q, {(uint64_t)DH, (uint64_t)H, (uint64_t)Sq, (uint64_t)B},
      {2ull * DH, 2ull * H * DH, 2ull * Sq * H * DH}, qbox);
  if (err != cudaSuccess) return err;
  err = hopper::make_map_4d(
      &mk, k, {(uint64_t)DH, (uint64_t)Hkv, (uint64_t)Skv, (uint64_t)B},
      {2ull * DH, 2ull * Hkv * DH, 2ull * Skv * Hkv * DH}, kvbox);
  if (err != cudaSuccess) return err;
  err = hopper::make_map_4d(
      &mv, v, {(uint64_t)DV, (uint64_t)Hkv, (uint64_t)Skv, (uint64_t)B},
      {2ull * DV, 2ull * Hkv * DV, 2ull * Skv * Hkv * DV}, kvbox);
  if (err != cudaSuccess) return err;
  auto kernel = wgmma_kernel<DH, DV, BN>;
  constexpr int smem = wgmma_smem(DH, DV, BN);
  static_assert(smem <= kMaxSmem, "the tile fits a CTA's shared memory");
  static bool attr_set = false;        // once per instantiation
  if (!attr_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(H, B, (Sq + kWgBM - 1) / kWgBM);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, q_pos, kv_pos, static_cast<__nv_bfloat16*>(out), Sq, Skv,
      H, Hkv, mask, scale * kLog2e);
  return cudaGetLastError();
}

// The (dh, dv) pairs the wgmma variant is built for, each with its key tile.
cudaError_t dispatch_wgmma(int bn, const void* q, const void* k,
                           const void* v, const int* qp, const int* kp,
                           void* out, int B, int Sq, int Skv, int H, int Hkv,
                           int dh, int dv, Mask mask,
                           float scale, cudaStream_t st) {
  if (B > 65535 || (Sq + kWgBM - 1) / kWgBM > 65535)
    return cudaErrorInvalidValue;
#define FLASH_WGMMA_TILE(DH_, DV_, BN_)                                     \
  if (dh == DH_ && dv == DV_ && bn == BN_)                                  \
    return launch_wgmma<DH_, DV_, BN_>(q, k, v, qp, kp, out, B, Sq, Skv, H, \
                                       Hkv, mask, scale, st);
  FLASH_WGMMA_TILE(256, 256, 64)
  FLASH_WGMMA_TILE(128, 128, 128)
  FLASH_WGMMA_TILE(96, 64, 128)
#undef FLASH_WGMMA_TILE
  return cudaErrorInvalidValue;
}

// ===========================================================================
// 3. splitkv: decode, the keys split over CTAs, merged by the last to arrive
// ===========================================================================

constexpr int kSplitThreads = 128;
constexpr int kSplitTileKeys = 32;   // keys per double-buffered tile
constexpr int kSplitMaxRows = 16;    // query rows (Sq * G) of a kv head
constexpr int kSplitMaxDh = 256;     // dh and dv
constexpr int kSplitMaxSplits = 64;  // key ranges of one (b, kv head)
constexpr int kSplitMergeLoads = 16; // float4 partial loads in flight

// Dynamic shared memory of one CTA of `rows` (4 or 16) query rows: two K and
// two V tiles in the input type at a row stride of one 16-byte vector more
// than dh (dv), q in f32 (pre-scaled), the P tile, the rows' positions and
// two tiles' key positions.
size_t splitkv_smem(int rows, int dh, int dv, int es) {
  return (size_t)es * 2 * kSplitTileKeys * (dh + dv + 2 * (16 / es)) +
         4 * ((size_t)rows * (dh + 4) + (size_t)rows * (kSplitTileKeys + 1) +
              rows + 2 * kSplitTileKeys);
}

// The workspace of nrec partial rows (B * Hkv * splits * Sq * G) in f32:
// (m, l) pairs, then from a 16-byte boundary acc[dv] per row.
__host__ __device__ constexpr long splitkv_workspace(long nrec, int dv) {
  return (2 * nrec + 3) / 4 * 4 + nrec * dv;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0) : "memory");
}

// TPR threads share a query row (32 for up to 4 rows, 8 for up to 16): each
// scores TK/TPR keys of a tile and owns dv/(4 TPR) float4 columns of acc.
// Grid (splits, Hkv, B); CTA (split, hk, b) takes keys [split * kchunk,
// + kchunk). work and tickets: see splitkv_workspace; one ticket per (b, hk),
// 0 between launches.
template <typename T, int TPR>
__global__ void __launch_bounds__(kSplitThreads)
    splitkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ q_pos,
                   const int* __restrict__ kv_pos, T* __restrict__ out,
                   float* __restrict__ work, int* tickets, int Sq, int Skv,
                   int H, int Hkv, int dh, int dv, Mask mask,
                   float scale_log2, int kchunk) {
  constexpr int R = kSplitThreads / TPR;
  constexpr int TK = kSplitTileKeys;
  constexpr int KPT = TK / TPR;                  // keys scored per thread
  constexpr int CPT = kSplitMaxDh / 4 / TPR;     // float4 columns (max)
  constexpr int VEC = 16 / sizeof(T);            // elements a 16-byte load
  const int G = H / Hkv, rows = Sq * G;
  const int split = blockIdx.x, splits = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid / TPR, lt = tid % TPR;
  const int k0 = split * kchunk, k1 = min(Skv, k0 + kchunk);
  const int dsk = dh + VEC, dsv = dv + VEC, dsq = dh + 4;
  const int dh4 = dh / 4, dv4 = dv / 4;

  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);           // 2 x TK x dsk
  T* sV = sK + 2 * TK * dsk;                     // 2 x TK x dsv
  float* sQ = reinterpret_cast<float*>(sV + 2 * TK * dsv);  // R x dsq
  float* sP = sQ + R * dsq;                      // R x (TK + 1)
  int* sQpos = reinterpret_cast<int*>(sP + R * (TK + 1));   // R
  int* sKpos = sQpos + R;                        // 2 x TK
  __shared__ int last;
  __shared__ float sW[R][kSplitMaxSplits];       // the merge's weights

  // the first tile's key positions load beside q: one round trip
  const int kp_first = tid < TK && k0 + tid < k1
                           ? kv_pos[(size_t)b * Skv + k0 + tid] : -1;
  // row rr = qi * G + g -> query qi, head hk * G + g
  for (int e = tid; e < R * dh4; e += kSplitThreads) {
    const int rr = e / dh4, c = e % dh4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rr < rows)
      x = scale4(load4(q + (((size_t)b * Sq + rr / G) * H + hk * G + rr % G) *
                               dh + 4 * c),
                 scale_log2);
    store4(sQ + rr * dsq + 4 * c, x);
  }
  for (int rr = tid; rr < R; rr += kSplitThreads)
    sQpos[rr] = rr < rows ? q_pos[(size_t)b * Sq + rr / G] : -1;
  __syncthreads();

  // the first tile at or after t0 some row may see; its key positions
  // (-1 past this split's keys) land in sKpos[buf]
  auto next_live = [&](int t0, int buf) -> int {
    for (int t = t0; t < k1; t += TK) {
      bool any = false;
      if (tid < TK) {
        const int j = t + tid;
        const int kp = t == k0 ? kp_first
                               : j < k1 ? kv_pos[(size_t)b * Skv + j] : -1;
        sKpos[buf * TK + tid] = kp;
        for (int rr = 0; rr < rows; ++rr)
          any = any || visible(kp, sQpos[rr], mask);
      }
      if (__syncthreads_or(any)) return t;
    }
    return k1;
  };
  // the tile's K and V rows by 16-byte cp.async; keys past the split load
  // as zeros
  auto load_tile = [&](int t, int buf) {
    const int nk = dh / VEC, nv = dv / VEC;
    for (int e = tid; e < TK * nk; e += kSplitThreads) {
      const int j = e / nk, c = e % nk;
      const bool in = t + j < k1;
      const T* src = in ? k + (((size_t)b * Skv + t + j) * Hkv + hk) * dh +
                              c * VEC
                        : k;
      cp_async16(sK + (buf * TK + j) * dsk + c * VEC, src, in);
    }
    for (int e = tid; e < TK * nv; e += kSplitThreads) {
      const int j = e / nv, c = e % nv;
      const bool in = t + j < k1;
      const T* src = in ? v + (((size_t)b * Skv + t + j) * Hkv + hk) * dv +
                              c * VEC
                        : v;
      cp_async16(sV + (buf * TK + j) * dsv + c * VEC, src, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const bool row_in = r < rows;
  const KeyRange my_keys = key_range(sQpos[r], mask);
  const float* qrow = sQ + r * dsq;
  float* prow = sP + r * (TK + 1);
  float m = -INFINITY, l = 0.f;
  float4 acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  int cur = next_live(k0, 0), buf = 0;
  if (cur < k1) load_tile(cur, 0);
  while (cur < k1) {
    const int nxt = next_live(cur + TK, buf ^ 1);
    if (nxt < k1) {
      load_tile(nxt, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    const T* kt = sK + buf * TK * dsk;
    const T* vt = sV + buf * TK * dsv;
    const int* kp = sKpos + buf * TK;
    bool valid[KPT];
    float s[KPT];
    float mt = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = lt + TPR * i;
      valid[i] = row_in && in_range(kp[j], my_keys);
      const T* krow = kt + j * dsk;
      float a0 = 0.f, a1 = 0.f;
      int c = 0;
      for (; c + 16 <= dh; c += 16) {
        a0 += dot8(qrow + c, krow + c);
        a1 += dot8(qrow + c + 8, krow + c + 8);
      }
      for (; c < dh; c += 4) a0 += dot4(load4(qrow + c), load4(krow + c));
      s[i] = valid[i] ? a0 + a1 : -INFINITY;
      mt = fmaxf(mt, s[i]);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float m_new = fmaxf(m, mt);
    const bool live = m_new != -INFINITY;
    const float alpha = live ? exp2f(m - m_new) : 1.f;
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = (live && valid[i]) ? exp2f(s[i] - m_new) : 0.f;
      prow[lt + TPR * i] = p;
      psum += p;
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's TPR lanes lie in one warp: its P row is ready
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[i] = scale4(acc[i], alpha);
    for (int j = 0; j < TK; ++j) {
      const float p = prow[j];
      const T* vrow = vt + j * dsv;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = lt + TPR * i;
        if (c < dv4) fma4(acc[i], p, load4(vrow + 4 * c));
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
    cur = nxt;
    buf ^= 1;
  }

  const size_t bh = (size_t)b * Hkv + hk;
  auto store_row = [&](int rr, const float4* x, float inv) {
    T* orow = out + (((size_t)b * Sq + rr / G) * H + hk * G + rr % G) * dv;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = lt + TPR * i;
      if (c < dv4) store4(orow + 4 * c, scale4(x[i], inv));
    }
  };
  if (splits == 1) {
    if (row_in) store_row(r, acc, l > 0.f ? 1.f / l : 0.f);
    return;
  }

  // this split's partial, then the last of the (b, hk) splits merges
  const long nrec = (long)gridDim.x * gridDim.y * gridDim.z * rows;
  float* ml = work;
  float* accs = work + (2 * nrec + 3) / 4 * 4;
  if (row_in) {
    const size_t rec = (bh * splits + split) * rows + r;
    if (lt == 0) {
      ml[2 * rec] = m;
      ml[2 * rec + 1] = l;
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = lt + TPR * i;
      if (c < dv4) store4(accs + rec * dv + 4 * c, acc[i]);
    }
  }
  if (!last_to_arrive(&tickets[bh], splits, &last)) return;
  // the merge, in split order: the TPR lanes of a row read the splits' (m,
  // l) in turn and reduce by shuffles (a fixed tree), weights w = 2^(m - M)
  // (0 for a split with no visible key) go to shared memory, then every
  // split's acc is summed in order, kLoads float4 loads in flight at once
  const size_t rec0 = bh * splits * rows + r;   // split sp: + sp * rows
  float mm = -INFINITY;
  if (row_in)
    for (int sp = lt; sp < splits; sp += TPR)
      mm = fmaxf(mm, __ldcg(ml + 2 * (rec0 + (size_t)sp * rows)));
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
  float ll = 0.f;
  if (row_in)
    for (int sp = lt; sp < splits; sp += TPR) {
      const size_t rec = rec0 + (size_t)sp * rows;
      const float ms = __ldcg(ml + 2 * rec);
      const float w = ms == -INFINITY ? 0.f : exp2f(ms - mm);
      sW[r][sp] = w;
      ll += w * __ldcg(ml + 2 * rec + 1);
    }
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    ll += __shfl_xor_sync(0xffffffffu, ll, o);
  __syncwarp();   // a row's weights, written by its lanes, in one warp
  if (row_in) {
    constexpr int kLoads = kSplitMergeLoads / CPT;   // splits a batch
    float4 o[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < splits; sp0 += kLoads) {
      float4 a[kLoads][CPT];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          const int c = lt + TPR * i;
          a[u][i] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (sp0 + u < splits && c < dv4)
            a[u][i] = __ldcg(reinterpret_cast<const float4*>(
                                 accs + (rec0 + (size_t)(sp0 + u) * rows) *
                                            dv) + c);
        }
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (sp0 + u < splits)
#pragma unroll
          for (int i = 0; i < CPT; ++i) fma4(o[i], sW[r][sp0 + u], a[u][i]);
    }
    store_row(r, o, ll > 0.f ? 1.f / ll : 0.f);
  }
  if (tid == 0) tickets[bh] = 0;   // for the next launch
}

template <typename T, int TPR>
cudaError_t launch_splitkv(const void* q, const void* k, const void* v,
                           const int* q_pos, const int* kv_pos, void* out,
                           float* work, int* tickets, int B, int Sq, int Skv,
                           int H, int Hkv, int dh, int dv, Mask mask,
                           float scale, int kchunk,
                           cudaStream_t stream) {
  constexpr int R = kSplitThreads / TPR;
  constexpr int VEC = 16 / sizeof(T);
  const int splits = (Skv + kchunk - 1) / kchunk;
  if (Sq * (H / Hkv) > R || dh % VEC != 0 || dv % VEC != 0 ||
      dh > kSplitMaxDh || kchunk % kSplitTileKeys != 0 || splits < 1 ||
      splits > kSplitMaxSplits || B > 65535 || Hkv > 65535 ||
      (splits > 1 && (work == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const size_t smem = splitkv_smem(R, dh, dv, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      splitkv_kernel<T, TPR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, Hkv, B);
  splitkv_kernel<T, TPR><<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), work,
      tickets, Sq, Skv, H, Hkv, dh, dv, mask, scale * kLog2e,
      kchunk);
  return cudaGetLastError();
}

// rows: the row bound the plan names, 4 or 16
template <typename T>
cudaError_t dispatch_splitkv(int rows, const void* q, const void* k,
                             const void* v, const int* qp, const int* kp,
                             void* out, float* work, int* tickets, int B,
                             int Sq, int Skv, int H, int Hkv, int dh, int dv,
                             Mask mask, float scale, int kchunk,
                             cudaStream_t st) {
  switch (rows) {
    case 4:
      return launch_splitkv<T, 32>(q, k, v, qp, kp, out, work, tickets, B,
                                   Sq, Skv, H, Hkv, dh, dv, mask,
                                   scale, kchunk, st);
    case 16:
      return launch_splitkv<T, 8>(q, k, v, qp, kp, out, work, tickets, B, Sq,
                                  Skv, H, Hkv, dh, dv, mask, scale,
                                  kchunk, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// variant: 0 = ffma (tile: query rows a CTA, 4 / 16 / 32; v at dh), 1 =
// wgmma (tile: the key tile BN; bf16), 2 = splitkv (tile: the row bound 4 /
// 16; kchunk: keys a CTA; work and tickets: splitkv_workspace(...) floats
// and B * Hkv ints, zero on the first call). dtype: 0 = float32, 1 =
// bfloat16. Returns a cudaError_t (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* kv_pos, void* out,
                        void* work, void* tickets, int B, int Sq, int Skv,
                        int H, int Hkv, int dh, int dv, int causal,
                        int window, int prefix, float scale, int variant,
                        int tile, int kchunk, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0 || dh < 4 ||
      dh % 4 != 0 || dv < 4 || dv % 4 != 0 || dv > dh || window < 0 ||
      prefix < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Mask mask{causal, window, prefix};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  float* w = static_cast<float*>(work);
  int* t = static_cast<int*>(tickets);
  switch (variant) {
    case 0:
      if (dv != dh) return (int)cudaErrorInvalidValue;
      return dtype == 0
                 ? (int)dispatch_ffma<float>(tile, q, k, v, qp, kp, out, B,
                                             Sq, Skv, H, Hkv, dh, mask,
                                             scale, st)
                 : (int)dispatch_ffma<__nv_bfloat16>(tile, q, k, v, qp, kp,
                                                     out, B, Sq, Skv, H, Hkv,
                                                     dh, mask,
                                                     scale, st);
    case 1:
      if (dtype != 1) return (int)cudaErrorInvalidValue;
      return (int)dispatch_wgmma(tile, q, k, v, qp, kp, out, B, Sq, Skv, H,
                                 Hkv, dh, dv, mask, scale, st);
    case 2:
      return dtype == 0
                 ? (int)dispatch_splitkv<float>(tile, q, k, v, qp, kp, out, w,
                                                t, B, Sq, Skv, H, Hkv, dh, dv,
                                                mask, scale, kchunk,
                                                st)
                 : (int)dispatch_splitkv<__nv_bfloat16>(
                       tile, q, k, v, qp, kp, out, w, t, B, Sq, Skv, H, Hkv,
                       dh, dv, mask, scale, kchunk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
