// Flash attention for Hopper (sm_90a): online-softmax GQA attention with
// causal and sliding-window masks, fp32 arithmetic, output in q's dtype.
//   q (B,S,H,Dh), k/v (B,S,KV,Dh) -> o (B,S,H,Dh); query head h reads KV
//   head h / (H/KV).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention_pallas (_fa_kernel: a dense (B*H, q tiles, kv tiles)
// grid whose innermost kv axis carries the running max, sum and
// accumulator in VMEM scratch).
//
// What bounds it on an H100: operations.  At the serving shapes (qwen3-8b,
// S = 1000, causal, bf16) a call does ~8.2 GFLOP of products against
// ~20 MB of q/k/v/o, about 400 operations per byte, above the card's
// ratio of tensor-core rate to memory rate; its least time is set by the
// 989 TFLOP/s bf16 rate.  This kernel runs the products as plain fp32
// FMAs (the fp32 contract of 5e-5 allows no TF32), so the rate it can
// reach is the 67 TFLOP/s fp32 SIMT rate; tensor cores for bf16 are later
// work.
//
// Design: one 256-thread block per (64 query rows, head, batch).  The
// block's 64 query rows are staged once in shared memory as fp32; the
// block then walks 64-key tiles of k and v through shared memory.  Each
// thread owns 4 query rows and, for the 64x64 score tile, 4 keys strided
// by 16, so the 16 threads of a row group are one half warp and the row
// max and row sum are warp shuffles.  Probabilities go through a
// shared-memory tile that the same half warp reads back for the value
// product; each thread accumulates its 4 rows by 4 contiguous columns
// out of every 64.  The running max, sum and per-row rescale are those of
// the Pallas recurrence (NEG_INF = -1e30, masked probabilities zeroed,
// denominator clamped at 1e-30), so a fully masked row comes out 0.
// Unlike the TPU's dense grid, the block walks only the key tiles that
// some of its rows attend (causal: up to its last row; window: from its
// first row minus the window): a skipped tile would give alpha = 1 and
// p = 0, so the skip is exact.  The ragged edge (S not a multiple of 64)
// is masked: rows and keys past S are zero-filled and masked.  q, k and v
// are read through their batch, sequence and head strides (last axis
// contiguous), so the projections' (B,S,H,Dh) outputs go in without a
// transposed copy.  Every sum runs in a fixed order (no split over keys,
// no atomics), so results are deterministic.  Dh is a template parameter
// (8, 12, 16, 32, 64, 80, 128, 256); above 48 KB the shared tiles are
// dynamic shared memory (Dh 256 takes 210 KB, one block per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile
constexpr int THREADS = 256;
constexpr int RG = 4;              // query rows per thread
constexpr int CG = 16;             // threads across a row group: a half warp
constexpr int KPT = BK / CG;       // keys per thread in the score tile
constexpr int PS = BK + 4;         // P row stride: the two half warps of a
                                   // warp write to disjoint banks
constexpr float NEG_INF = -1e30f;

static_assert(THREADS == (BQ / RG) * CG, "one thread per (row group, lane)");

template <int DH>
struct Dims {
  // K row stride in floats: 8 consecutive keys read at one column fall in
  // 8 distinct 16-byte bank groups
  static constexpr int KS = DH + 4;
  static constexpr int NV = (DH + 63) / 64;   // 4-column groups per thread
  static constexpr size_t SMEM =
      sizeof(float) * (BQ * DH + BK * KS + BK * DH + BQ * PS);
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// rows x DH elements, rows `stride` elements apart in global memory ->
// shared fp32 rows `ld` floats apart; rows at and past `valid` are zero.
// Consecutive threads read consecutive columns of a row.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          long long stride, int valid) {
  static_assert((ROWS * DH) % THREADS == 0, "whole tiles per thread");
#pragma unroll 4
  for (int n = 0; n < ROWS * DH / THREADS; ++n) {
    const int e = n * THREADS + static_cast<int>(threadIdx.x);
    const int r = e / DH;
    const int d = e % DH;
    dst[r * ld + d] = r < valid ? to_f32(src[r * stride + d]) : 0.f;
  }
}

__device__ __forceinline__ bool attends(int qp, int kp, int S, int causal,
                                        int window) {
  bool ok = kp < S;
  if (causal) ok = ok && qp >= kp;
  if (window >= 0) {
    ok = ok && qp - kp < window;
    if (!causal) ok = ok && kp - qp < window;
  }
  return ok;
}

// reduce over the 16 lanes of a half warp
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = CG / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = CG / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int H,
          int groups, long long sqb, long long sqs, long long sqh,
          long long skb, long long sks, long long skh, long long svb,
          long long svs, long long svh, int causal, int window,
          float scale) {
  using D = Dims<DH>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BQ x DH
  float* Ks = Qs + BQ * DH;                      // BK x KS
  float* Vs = Ks + BK * D::KS;                   // BK x DH
  float* Ps = Vs + BK * DH;                      // BQ x PS

  const int tid = threadIdx.x;
  const int rg = tid / CG;
  const int c = tid % CG;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / groups;
  const int qrows = min(BQ, S - q0);
  const int qlast = q0 + qrows - 1;

  load_tile<T, DH, BQ>(Qs, DH, q + b * sqb + h * sqh + q0 * sqs, sqs, qrows);

  // the keys that some row of this block attends: [k_lo, k_hi)
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(k_hi, qlast + 1);
  if (window >= 0) {
    k_lo = max(k_lo, q0 - window + 1);
    if (!causal) k_hi = min(k_hi, qlast + window);
  }

  float m[RG], l[RG], acc[RG][4 * D::NV];
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < 4 * D::NV; ++n) acc[i][n] = 0.f;
  }

  const T* kbase = k + b * skb + kvh * skh;
  const T* vbase = v + b * svb + kvh * svh;
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    const int krows = min(BK, S - k0);
    __syncthreads();                  // the last tile's readers are done
    load_tile<T, DH, BK>(Ks, D::KS, kbase + k0 * sks, sks, krows);
    load_tile<T, DH, BK>(Vs, DH, vbase + k0 * svs, svs, krows);
    __syncthreads();

    // scores: s[i][j] = q[row i] . k[key c + 16 j], in fixed column order
    float s[RG][KPT];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[RG], kv[KPT];
#pragma unroll
      for (int i = 0; i < RG; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(rg * RG + i) * DH + d]);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(c + CG * j) * D::KS + d]);
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // online softmax, row by row (each row's 64 keys live in one half warp)
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int qp = q0 + rg * RG + i;
      bool ok[KPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        ok[j] = attends(qp, k0 + c + CG * j, S, causal, window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(rg * RG + i) * PS + c + CG * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < 4 * D::NV; ++n) acc[i][n] *= alpha;
    }
    __syncwarp();          // a row group's P is written and read by its
                           // own half warp

    // acc[row i][4c + 64n + e] += sum over keys of p * v
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(rg * RG + i) * PS + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int n = 0; n < D::NV; ++n) {
          const int col = 4 * c + 64 * n;
          if (col < DH) {
            const float4 vv =
                *reinterpret_cast<const float4*>(&Vs[(kk + e) * DH + col]);
#pragma unroll
            for (int i = 0; i < RG; ++i) {
              const float p = comp(pv[i], e);
              acc[i][4 * n + 0] = fmaf(p, vv.x, acc[i][4 * n + 0]);
              acc[i][4 * n + 1] = fmaf(p, vv.y, acc[i][4 * n + 1]);
              acc[i][4 * n + 2] = fmaf(p, vv.z, acc[i][4 * n + 2]);
              acc[i][4 * n + 3] = fmaf(p, vv.w, acc[i][4 * n + 3]);
            }
          }
        }
      }
    }
  }

  // o is contiguous (B,S,H,DH)
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    const int qp = q0 + rg * RG + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * S + qp) * H + h) * DH;
#pragma unroll
    for (int n = 0; n < D::NV; ++n) {
      const int col = 4 * c + 64 * n;
      if (col < DH) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          orow[col + e] = from_f32<T>(acc[i][4 * n + e] / denom);
      }
    }
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, const long long* st, int causal,
              int window, float scale, cudaStream_t stream) {
  const size_t smem = Dims<DH>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  fa_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, H / KV, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int Dh, const long long* st, int causal,
           int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 8: return launch_dh<T, 8>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
    case 12: return launch_dh<T, 12>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
    case 16: return launch_dh<T, 16>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
    case 32: return launch_dh<T, 32>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
    case 64: return launch_dh<T, 64>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
    case 80: return launch_dh<T, 80>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
    case 128: return launch_dh<T, 128>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
    case 256: return launch_dh<T, 256>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements: st holds
// (batch, seq, head) strides of q, then k, then v; the last axis of each
// is contiguous.  o is a contiguous (B,S,H,Dh) tensor.  window < 0 means
// no window; causal is 0 or 1.
extern "C" int repro_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int KV, int Dh, const long long* st, int causal, int window,
    float scale, void* stream) {
  return launch<float>(q, k, v, o, B, S, H, KV, Dh, st, causal, window,
                       scale, stream);
}

extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int KV, int Dh, const long long* st, int causal, int window,
    float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, Dh, st, causal,
                               window, scale, stream);
}
