// Backward of flash attention for Hopper (sm_90a): GQA with causal and
// sliding-window masks, fp32 arithmetic, gradients in the inputs' dtype.
//   q (B,S,H,Dh), k/v (B,S,KV,Dh), o and dO (B,S,H,Dh), all contiguous
//   -> dq (B,S,H,Dh), dk/dv (B,S,KV,Dh); query head h reads KV head
//   h / (H/KV).
// With s = scale * q.k over the keys a row may attend, P = softmax(s),
// O = P V:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),  D = rowsum(dO * O),
//   dQ = scale * dS K,  dK = scale * dS^T Q  (summed over a KV head's
//   query heads).
//
// Backward of: src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention_pallas.  The JAX package has no backward kernel (no
// custom_vjp): it trains by differentiating its jnp reference.  The
// port's forward runs the kernels of csrc/flash_attention.cu, so its
// gradient is this file's, reached through the torch.autograd.Function
// in kernels/flash_attention/flash_attention.py.
//
// Masks are the forward's: causal (j <= i), window (i - window < j, and
// j - i < window without causal), keys and queries past S masked; a masked
// probability is exactly 0, so a row that attends no key has zero
// gradients, as the forward's clamped denominator gives it a constant 0.
//
// What bounds it on an H100: operations.  The least work is five
// products of 2 * pairs * Dh (S = QK^T, dP = dO V^T, dV, dK, dQ); at the
// training path's shape (internlm2-1.8b, B4 S1024 H16/8 Dh128 causal bf16)
// that is ~43 GFLOP against ~100 MB, far above the card's ratio of
// tensor-core rate to memory rate.
//
// Design: a simple SIMT kernel that is right, in fp32 FMAs (tensor cores
// are later work).  Three launches, no atomics and every sum in a fixed
// order, so two calls give the same bits:
//   (a) fa_bwd_stats_kernel, one block per (BT query rows, head, batch):
//       recomputes each row's log-sum-exp over its keys (the forward
//       kernels keep no statistics, and stay as they are) and
//       D = rowsum(dO * O), both fp32 into a (B,H,S) workspace each.
//   (b) fa_bwd_dkdv_kernel, one block per (BT keys, KV head, batch): keeps
//       the tile's dK and dV in registers and walks the group's query
//       heads, and for each the query tiles the masks allow, in order:
//       recompute P, dP and dS, then dV += P^T dO, dK += dS^T Q.  GQA's
//       sum over query heads happens inside the block.
//   (c) fa_bwd_dq_kernel, one block per (BT query rows, head, batch): keeps
//       the tile's dQ in registers and walks the key tiles its rows attend:
//       recompute P, dP and dS, then dQ += dS K.
// 256 threads a block.  Tiles live in shared memory as fp32 rows of Dh + 1
// floats (an odd stride: reading one column down 16 rows meets 16 banks);
// a score tile (BT x BT) gives each thread a (BT/16) x (BT/16) patch of
// rows ti + 16a, columns tj + 16b, the 16 threads of a row patch being a
// half warp (row max and sum by shuffles); a (BT x Dh) accumulator gives
// each thread rows tr + 8a and columns tc + 32b (a warp reads one row of
// P broadcast and 32 consecutive columns).  BT is 64 keys and queries, 32
// at Dh 256 (shared memory: 165 KB at Dh 128, 140 KB at Dh 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

template <int DH>
struct Bwd {
  static constexpr int BT = DH <= 128 ? 64 : 32;   // rows of a tile
  static constexpr int LD = DH + 1;                // fp32 row stride
  static constexpr int PLD = BT + 1;               // score tile row stride
  static constexpr int SP = BT / 16;               // score patch side
  static constexpr int AR = BT / 8;                // accumulator rows
  static constexpr int AC = (DH + 31) / 32;        // accumulator columns
  static constexpr int TILE = BT * LD;             // floats
  static constexpr size_t SMEM_STATS = sizeof(float) * 2 * TILE;
  static constexpr size_t SMEM_DKDV =
      sizeof(float) * (4 * TILE + 2 * BT * PLD + 2 * BT);
  static constexpr size_t SMEM_DQ =
      sizeof(float) * (4 * TILE + BT * PLD + 2 * BT);
  static_assert(SMEM_DKDV <= 232448, "shared memory");
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

__device__ __forceinline__ bool attends(int qp, int kp, int S, int causal,
                                        int window) {
  bool ok = qp < S && kp < S;
  if (causal) ok = ok && qp >= kp;
  if (window >= 0) {
    ok = ok && qp - kp < window;
    if (!causal) ok = ok && kp - qp < window;
  }
  return ok;
}

// the keys [lo, hi) that some query in [q_first, q_last] attends
__device__ __forceinline__ void key_range(int q_first, int q_last, int S,
                                          int causal, int window, int& lo,
                                          int& hi) {
  lo = 0;
  hi = S;
  if (causal) hi = min(hi, q_last + 1);
  if (window >= 0) {
    lo = max(lo, q_first - window + 1);
    if (!causal) hi = min(hi, q_last + window);
  }
}

// the queries [lo, hi) that attend some key in [k_first, k_last]
__device__ __forceinline__ void query_range(int k_first, int k_last, int S,
                                            int causal, int window, int& lo,
                                            int& hi) {
  lo = 0;
  hi = S;
  if (causal) lo = k_first;
  if (window >= 0) {
    hi = min(hi, k_last + window);
    if (!causal) lo = max(lo, k_first - window + 1);
  }
}

// `rows` rows of DH elements, rows `stride` elements apart, into shared
// fp32 rows LD floats apart; rows at and past `valid` are zero
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          long long stride, int rows,
                                          int valid) {
  constexpr int LD = Bwd<DH>::LD;
  for (int e = threadIdx.x; e < rows * DH; e += THREADS) {
    const int r = e / DH;
    const int c = e % DH;
    dst[r * LD + c] = r < valid ? to_f32(src[r * stride + c]) : 0.f;
  }
}

// s[a][b] = A[ti + 16a] . B[tj + 16b] over DH columns, both tiles LD apart
template <int DH>
__device__ __forceinline__ void score_patch(const float* A, const float* Bm,
                                            int ti, int tj,
                                            float (&s)[Bwd<DH>::SP]
                                                      [Bwd<DH>::SP]) {
  using K = Bwd<DH>;
#pragma unroll
  for (int a = 0; a < K::SP; ++a)
#pragma unroll
    for (int b = 0; b < K::SP; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float av[K::SP], bv[K::SP];
#pragma unroll
    for (int a = 0; a < K::SP; ++a) av[a] = A[(ti + 16 * a) * K::LD + d];
#pragma unroll
    for (int b = 0; b < K::SP; ++b) bv[b] = Bm[(tj + 16 * b) * K::LD + d];
#pragma unroll
    for (int a = 0; a < K::SP; ++a)
#pragma unroll
      for (int b = 0; b < K::SP; ++b) s[a][b] = fmaf(av[a], bv[b], s[a][b]);
  }
}

// reduce over the 16 lanes of a half warp
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc[a][c] += sum over i < BT of P[i][tr + 8a] * X[i][tc + 32c]
// (TRANS: P read as P^T) or of P[tr + 8a][i] * X[i][tc + 32c]
template <int DH, bool TRANS>
__device__ __forceinline__ void acc_product(const float* P, const float* X,
                                            int tr, int tc,
                                            float (&acc)[Bwd<DH>::AR]
                                                        [Bwd<DH>::AC]) {
  using K = Bwd<DH>;
#pragma unroll 2
  for (int i = 0; i < K::BT; ++i) {
    float pv[K::AR], xv[K::AC];
#pragma unroll
    for (int a = 0; a < K::AR; ++a)
      pv[a] = TRANS ? P[i * K::PLD + tr + 8 * a] : P[(tr + 8 * a) * K::PLD + i];
#pragma unroll
    for (int c = 0; c < K::AC; ++c) {
      const int col = tc + 32 * c;
      xv[c] = col < DH ? X[i * K::LD + col] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < K::AR; ++a)
#pragma unroll
      for (int c = 0; c < K::AC; ++c) acc[a][c] = fmaf(pv[a], xv[c], acc[a][c]);
  }
}

// rows r0 + tr + 8a (< S) of a (B,S,heads,DH) tensor, column tc + 32c,
// from acc * mul
template <typename T, int DH>
__device__ __forceinline__ void store_acc(T* __restrict__ dst, long long b,
                                          int S, int heads, int head, int r0,
                                          int tr, int tc, float mul,
                                          const float (&acc)[Bwd<DH>::AR]
                                                            [Bwd<DH>::AC]) {
  using K = Bwd<DH>;
#pragma unroll
  for (int a = 0; a < K::AR; ++a) {
    const int s = r0 + tr + 8 * a;
    if (s >= S) continue;
    T* row = dst + ((b * S + s) * heads + head) * DH;
#pragma unroll
    for (int c = 0; c < K::AC; ++c) {
      const int col = tc + 32 * c;
      if (col < DH) row[col] = from_f32<T>(acc[a][c] * mul);
    }
  }
}

// ------------------------------------------------------------- (a) stats

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
fa_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ lse, float* __restrict__ delta,
                    int S, int H, int KV, int causal, int window,
                    float scale) {
  using K = Bwd<DH>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + K::TILE;
  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const int q0 = blockIdx.x * K::BT;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int qrows = min(K::BT, S - q0);
  const long long qstride = static_cast<long long>(H) * DH;
  const long long kstride = static_cast<long long>(KV) * DH;

  load_tile<T, DH>(Qs, q + ((b * S + q0) * H + h) * DH, qstride, K::BT,
                   qrows);
  float m[K::SP], l[K::SP];
#pragma unroll
  for (int a = 0; a < K::SP; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
  }
  int k_lo, k_hi;
  key_range(q0, q0 + qrows - 1, S, causal, window, k_lo, k_hi);
  const T* kb = k + (b * S * KV + kvh) * DH;
  for (int k0 = (k_lo / K::BT) * K::BT; k0 < k_hi; k0 += K::BT) {
    __syncthreads();                  // the last tile's readers are done
    load_tile<T, DH>(Ks, kb + k0 * kstride, kstride, K::BT,
                     min(K::BT, S - k0));
    __syncthreads();
    float s[K::SP][K::SP];
    score_patch<DH>(Qs, Ks, ti, tj, s);
#pragma unroll
    for (int a = 0; a < K::SP; ++a) {
      const int qp = q0 + ti + 16 * a;
      float mx = NEG_INF;
      bool ok[K::SP];
#pragma unroll
      for (int c = 0; c < K::SP; ++c) {
        ok[c] = attends(qp, k0 + tj + 16 * c, S, causal, window);
        s[a][c] = ok[c] ? s[a][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], half_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < K::SP; ++c)
        sum += ok[c] ? expf(s[a][c] - m_new) : 0.f;
      l[a] = l[a] * expf(m[a] - m_new) + half_sum(sum);
      m[a] = m_new;
    }
  }
  // D = rowsum(dO * O): a half warp per row, columns strided by 16
#pragma unroll
  for (int a = 0; a < K::SP; ++a) {
    const int qp = q0 + ti + 16 * a;
    float dsum = 0.f;
    if (qp < S) {
      const long long off = ((b * S + qp) * H + h) * DH;
      for (int c = tj; c < DH; c += 16)
        dsum = fmaf(to_f32(dout[off + c]), to_f32(o[off + c]), dsum);
    }
    dsum = half_sum(dsum);
    if (qp < S && tj == 0) {
      const long long at = (b * H + h) * S + qp;
      // a row that attends no key: P is 0 wherever it is read
      lse[at] = l[a] > 0.f ? m[a] + logf(l[a]) : 0.f;
      delta[at] = dsum;
    }
  }
}

// ------------------------------------------------------------- (b) dK, dV

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int S, int H, int KV, int causal,
                   int window, float scale) {
  using K = Bwd<DH>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + K::TILE;
  float* Qs = Vs + K::TILE;
  float* Os = Qs + K::TILE;            // the dO tile
  float* Ps = Os + K::TILE;            // BT x PLD
  float* Ds = Ps + K::BT * K::PLD;     // dS, BT x PLD
  float* Ls = Ds + K::BT * K::PLD;     // lse of the query tile
  float* Es = Ls + K::BT;              // D of the query tile
  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const int tr = tid / 32, tc = tid % 32;
  const int k0 = blockIdx.x * K::BT;
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int groups = H / KV;
  const int krows = min(K::BT, S - k0);
  const long long qstride = static_cast<long long>(H) * DH;
  const long long kstride = static_cast<long long>(KV) * DH;

  load_tile<T, DH>(Ks, k + ((b * S + k0) * KV + kvh) * DH, kstride, K::BT,
                   krows);
  load_tile<T, DH>(Vs, v + ((b * S + k0) * KV + kvh) * DH, kstride, K::BT,
                   krows);
  float dK[K::AR][K::AC], dV[K::AR][K::AC];
#pragma unroll
  for (int a = 0; a < K::AR; ++a)
#pragma unroll
    for (int c = 0; c < K::AC; ++c) {
      dK[a][c] = 0.f;
      dV[a][c] = 0.f;
    }
  int q_lo, q_hi;
  query_range(k0, k0 + krows - 1, S, causal, window, q_lo, q_hi);
  for (int g = 0; g < groups; ++g) {
    const int h = kvh * groups + g;
    for (int q0 = (q_lo / K::BT) * K::BT; q0 < q_hi; q0 += K::BT) {
      const int qrows = min(K::BT, S - q0);
      __syncthreads();                // the last tile's readers are done
      load_tile<T, DH>(Qs, q + ((b * S + q0) * H + h) * DH, qstride, K::BT,
                       qrows);
      load_tile<T, DH>(Os, dout + ((b * S + q0) * H + h) * DH, qstride,
                       K::BT, qrows);
      for (int i = tid; i < K::BT; i += THREADS) {
        const long long at = (b * H + h) * S + q0 + i;
        Ls[i] = i < qrows ? lse[at] : 0.f;
        Es[i] = i < qrows ? delta[at] : 0.f;
      }
      __syncthreads();
      float s[K::SP][K::SP], dp[K::SP][K::SP];
      score_patch<DH>(Qs, Ks, ti, tj, s);
      score_patch<DH>(Os, Vs, ti, tj, dp);
#pragma unroll
      for (int a = 0; a < K::SP; ++a) {
        const int i = ti + 16 * a;
#pragma unroll
        for (int c = 0; c < K::SP; ++c) {
          const int j = tj + 16 * c;
          const float p = attends(q0 + i, k0 + j, S, causal, window)
                              ? expf(s[a][c] * scale - Ls[i]) : 0.f;
          Ps[i * K::PLD + j] = p;
          Ds[i * K::PLD + j] = p * (dp[a][c] - Es[i]);
        }
      }
      __syncthreads();
      acc_product<DH, true>(Ps, Os, tr, tc, dV);
      acc_product<DH, true>(Ds, Qs, tr, tc, dK);
    }
  }
  store_acc<T, DH>(dk, b, S, KV, kvh, k0, tr, tc, scale, dK);
  store_acc<T, DH>(dv, b, S, KV, kvh, k0, tr, tc, 1.f, dV);
}

// ------------------------------------------------------------------ (c) dQ

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int S,
                 int H, int KV, int causal, int window, float scale) {
  using K = Bwd<DH>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + K::TILE;            // the dO tile
  float* Ks = Os + K::TILE;
  float* Vs = Ks + K::TILE;
  float* Ds = Vs + K::TILE;            // dS, BT x PLD
  float* Ls = Ds + K::BT * K::PLD;
  float* Es = Ls + K::BT;
  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const int tr = tid / 32, tc = tid % 32;
  const int q0 = blockIdx.x * K::BT;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int qrows = min(K::BT, S - q0);
  const long long qstride = static_cast<long long>(H) * DH;
  const long long kstride = static_cast<long long>(KV) * DH;

  load_tile<T, DH>(Qs, q + ((b * S + q0) * H + h) * DH, qstride, K::BT,
                   qrows);
  load_tile<T, DH>(Os, dout + ((b * S + q0) * H + h) * DH, qstride, K::BT,
                   qrows);
  for (int i = tid; i < K::BT; i += THREADS) {
    const long long at = (b * H + h) * S + q0 + i;
    Ls[i] = i < qrows ? lse[at] : 0.f;
    Es[i] = i < qrows ? delta[at] : 0.f;
  }
  float dQ[K::AR][K::AC];
#pragma unroll
  for (int a = 0; a < K::AR; ++a)
#pragma unroll
    for (int c = 0; c < K::AC; ++c) dQ[a][c] = 0.f;
  int k_lo, k_hi;
  key_range(q0, q0 + qrows - 1, S, causal, window, k_lo, k_hi);
  const T* kb = k + (b * S * KV + kvh) * DH;
  const T* vb = v + (b * S * KV + kvh) * DH;
  for (int k0 = (k_lo / K::BT) * K::BT; k0 < k_hi; k0 += K::BT) {
    const int krows = min(K::BT, S - k0);
    __syncthreads();                  // the last tile's readers are done
    load_tile<T, DH>(Ks, kb + k0 * kstride, kstride, K::BT, krows);
    load_tile<T, DH>(Vs, vb + k0 * kstride, kstride, K::BT, krows);
    __syncthreads();
    float s[K::SP][K::SP], dp[K::SP][K::SP];
    score_patch<DH>(Qs, Ks, ti, tj, s);
    score_patch<DH>(Os, Vs, ti, tj, dp);
#pragma unroll
    for (int a = 0; a < K::SP; ++a) {
      const int i = ti + 16 * a;
#pragma unroll
      for (int c = 0; c < K::SP; ++c) {
        const int j = tj + 16 * c;
        const float p = attends(q0 + i, k0 + j, S, causal, window)
                            ? expf(s[a][c] * scale - Ls[i]) : 0.f;
        Ds[i * K::PLD + j] = p * (dp[a][c] - Es[i]);
      }
    }
    __syncthreads();
    acc_product<DH, false>(Ds, Ks, tr, tc, dQ);
  }
  store_acc<T, DH>(dq, b, S, H, h, q0, tr, tc, scale, dQ);
}

// ---------------------------------------------------------------- launch

template <typename KernelFn>
int allow_smem(KernelFn kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

enum Stage { STATS = 0, DKDV = 1, DQ = 2 };

template <typename T, int DH>
int launch_dh(int stage, const void* q, const void* k, const void* v,
              const void* o, const void* dout, float* lse, float* delta,
              void* dq, void* dk, void* dv, int B, int S, int H, int KV,
              int causal, int window, float scale, cudaStream_t st) {
  using K = Bwd<DH>;
  const int tiles = (S + K::BT - 1) / K::BT;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dt = static_cast<const T*>(dout);
  int rc = 0;
  if (stage == STATS) {
    rc = allow_smem(fa_bwd_stats_kernel<T, DH>, K::SMEM_STATS);
    if (rc != 0) return rc;
    fa_bwd_stats_kernel<T, DH><<<dim3(tiles, H, B), THREADS, K::SMEM_STATS,
                                 st>>>(qt, kt, ot, dt, lse, delta, S, H, KV,
                                       causal, window, scale);
  } else if (stage == DKDV) {
    rc = allow_smem(fa_bwd_dkdv_kernel<T, DH>, K::SMEM_DKDV);
    if (rc != 0) return rc;
    fa_bwd_dkdv_kernel<T, DH><<<dim3(tiles, KV, B), THREADS, K::SMEM_DKDV,
                                st>>>(qt, kt, vt, dt, lse, delta,
                                      static_cast<T*>(dk),
                                      static_cast<T*>(dv), S, H, KV, causal,
                                      window, scale);
  } else if (stage == DQ) {
    rc = allow_smem(fa_bwd_dq_kernel<T, DH>, K::SMEM_DQ);
    if (rc != 0) return rc;
    fa_bwd_dq_kernel<T, DH><<<dim3(tiles, H, B), THREADS, K::SMEM_DQ, st>>>(
        qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), S, H, KV, causal,
        window, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int stage, const void* q, const void* k, const void* v,
           const void* o, const void* dout, void* lse_, void* delta_,
           void* dq, void* dk, void* dv, int B, int S, int H, int KV, int Dh,
           int causal, int window, float scale, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  float* lse = static_cast<float*>(lse_);
  float* delta = static_cast<float*>(delta_);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return launch_dh<T, 16>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    case 32: return launch_dh<T, 32>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    case 64: return launch_dh<T, 64>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    case 80: return launch_dh<T, 80>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    case 128: return launch_dh<T, 128>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    case 256: return launch_dh<T, 256>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, bound with ctypes.  q, o, dout and dq are contiguous
// (B,S,H,Dh); k, v, dk and dv contiguous (B,S,KV,Dh); lse and delta fp32
// (B,H,S) workspaces.  `stage` is 0 (stats: writes lse and delta), 1 (dK,
// dV: reads lse and delta) or 2 (dQ: reads lse and delta); pointers a
// stage does not use may be null.  window < 0 means no window; causal is
// 0 or 1; Dh is 16, 32, 64, 80, 128 or 256.  Each returns
// cudaGetLastError() after its launch, or the error that kept it from
// launching.
extern "C" int repro_flash_attention_bwd_f32(
    int stage, const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* lse, void* delta, void* dq, void* dk, void* dv,
    int B, int S, int H, int KV, int Dh, int causal, int window, float scale,
    void* stream) {
  return launch<float>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                       S, H, KV, Dh, causal, window, scale, stream);
}

extern "C" int repro_flash_attention_bwd_bf16(
    int stage, const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* lse, void* delta, void* dq, void* dk, void* dv,
    int B, int S, int H, int KV, int Dh, int causal, int window, float scale,
    void* stream) {
  return launch<__nv_bfloat16>(stage, q, k, v, o, dout, lse, delta, dq, dk,
                               dv, B, S, H, KV, Dh, causal, window, scale,
                               stream);
}
