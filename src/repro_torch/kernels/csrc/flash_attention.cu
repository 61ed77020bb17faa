// Flash attention forward for NVIDIA Hopper (sm_90a), bound to Python through
// a plain C interface (ctypes; see repro_torch/kernels/flash_attention.py).
//
// Replaces: src/repro/kernels/flash_attention.py `_flash_kernel` (the Pallas
// TPU kernel). It computes the same function -- softmax(q k^T * scale) v with
// an online softmax over KV tiles and f32 running (max, sum, acc) -- but takes
// the mask from explicit positions, as the model's attention_core does
// (src/repro/models/attention.py): key j is visible to query i iff
//   kv_pos[j] >= 0  &&  (!causal || (kv_pos[j] <= q_pos[i]
//                                    && (window == 0 || kv_pos[j] > q_pos[i] - window))).
// The TPU kernel's own case (top-left causal over (BH, S, d)) is positions =
// arange with H = Hkv = 1.
//
// Layout: q/out (B, Sq, H, dh), k/v (B, Skv, Hkv, dh), positions int32
// (B, Sq) and (B, Skv); all contiguous. GQA indexes kv head h / G; one CTA
// takes rows (query index, head) of ONE kv head, G heads of a query position
// side by side, so each K/V tile it loads serves all G heads of the group.
//
// Types: f32 or bf16 inputs; every product and sum is f32 (no TF32, no tensor
// cores). bf16 tiles are widened to f32 as they land in shared memory.
//
// A row none of whose keys is visible (a padding query, q_pos = -1 under the
// causal mask) has l = 0: it is written as zeros, never divided by l.
//
// What bounds it on an H100, and what this simple design does about it:
// * Decode (Sq = 1): the K/V bytes. The kernel reads each K/V tile once per
//   (batch row, kv head) for all G query heads, and skips whole tiles whose
//   keys no row of the CTA may see (beyond the context, outside the sliding
//   window), so it reads only the bytes the masks need. It does NOT spread
//   one row's keys over several CTAs: the grid is B * Hkv CTAs and most SMs
//   idle at decode (split-KV is a later change), and the loads are not
//   double-buffered.
// * Long prefill: the tensor-core FLOPs. This design does its products on the
//   f32 CUDA cores (67 TF/s peak, not the 989 TF/s of bf16 wgmma), with
//   register tiles of (1 row x TK/TPR keys) for q.k and (1 row x dh/TPR
//   columns) for p.v and conflict-free padded shared-memory rows. It skips
//   tiles above the causal diagonal through the same tile test. A wgmma/TMA
//   design is the later change that moves this bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per CTA
constexpr int kTileKeys = 32;  // keys per K/V tile (TK)
constexpr int kMaxDh = 256;

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

// TPR threads share one query row: each scores TK/TPR keys of a tile and
// owns dh/(4*TPR) float4 columns of the row's accumulator.
template <int TPR>
__host__ __device__ constexpr int rows_per_cta() { return kThreads / TPR; }

template <int TPR>
size_t smem_bytes(int dh) {
  const int ds = dh + 4;  // padded row stride: conflict-free float4 rows
  const int R = rows_per_cta<TPR>();
  return sizeof(float) * ((size_t)R * ds + 2 * (size_t)kTileKeys * ds +
                          (size_t)R * (kTileKeys + 1)) +
         sizeof(int) * (R + kTileKeys);
}

template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, T* __restrict__ out,
                       int Sq, int Skv, int H, int Hkv, int dh, int causal,
                       int window, float scale) {
  constexpr int R = rows_per_cta<TPR>();
  constexpr int KPT = kTileKeys / TPR;     // keys scored per thread
  constexpr int CPT = kMaxDh / 4 / TPR;    // float4 columns per thread (max)
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
    if (qi < Sq) {
      x = load4(q + (((size_t)b * Sq + qi) * H + h) * dh + 4 * c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    store4(sQ + rr * ds + 4 * c, x);
  }
  for (int rr = tid; rr < R; rr += kThreads) {
    const int qi = (row0 + rr) / G;
    sQpos[rr] = qi < Sq ? q_pos[(size_t)b * Sq + qi] : -1;
  }
  __syncthreads();

  const int my_qi = (row0 + r) / G;
  const bool row_in = my_qi < Sq;
  const int my_qpos = sQpos[r];
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
      const int kp = sKpos[lt + TPR * i];
      bool ok = row_in && kp >= 0;
      if (causal) {
        ok = ok && kp <= my_qpos;
        if (window > 0) ok = ok && kp > my_qpos - window;
      }
      valid[i] = ok;
      any = any || ok;
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
    for (int i = 0; i < CPT; ++i) {
      acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
    }
    for (int j = 0; j < kTileKeys; ++j) {
      const float p = prow[j];
      const float* vrow = sV + j * ds;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = lt + TPR * i;
        if (c < dh4) {
          const float4 y = load4(vrow + 4 * c);
          acc[i].x += p * y.x; acc[i].y += p * y.y;
          acc[i].z += p * y.z; acc[i].w += p * y.w;
        }
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
      if (c < dh4) {
        float4 x = acc[i];
        x.x *= inv; x.y *= inv; x.z *= inv; x.w *= inv;
        store4(orow + 4 * c, x);
      }
    }
  }
}

template <typename T, int TPR>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int Sq, int Skv, int H, int Hkv, int dh, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<TPR>(dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, TPR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int R = rows_per_cta<TPR>();
  const long rows = (long)Sq * (H / Hkv);
  dim3 grid((unsigned)((rows + R - 1) / R), (unsigned)Hkv, (unsigned)B);
  flash_attention_kernel<T, TPR><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), Sq, Skv,
      H, Hkv, dh, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* q_pos, const int* kv_pos, void* out, int B,
                     int Sq, int Skv, int H, int Hkv, int dh, int causal,
                     int window, float scale, cudaStream_t stream) {
  // rows per CTA follow the work: a warp per row at decode (Sq * G <= 4),
  // 8 lanes per row for short chunks, 4 lanes per row otherwise
  const long rows = (long)Sq * (H / Hkv);
  if (rows <= rows_per_cta<32>())
    return launch<T, 32>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv, dh,
                         causal, window, scale, stream);
  if (rows <= rows_per_cta<8>())
    return launch<T, 8>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv, dh,
                        causal, window, scale, stream);
  return launch<T, 4>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv, dh,
                      causal, window, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* kv_pos, void* out,
                        int B, int Sq, int Skv, int H, int Hkv, int dh,
                        int causal, int window, float scale, int dtype,
                        void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0 || dh < 4 ||
      dh > kMaxDh || dh % 4 != 0 || window < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, qp, kp, out, B, Sq, Skv, H, Hkv, dh,
                                causal, window, scale, st);
  return (int)dispatch<__nv_bfloat16>(q, k, v, qp, kp, out, B, Sq, Skv, H,
                                      Hkv, dh, causal, window, scale, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
