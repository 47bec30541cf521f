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
// tensor-core rate to memory rate: 0.0435 ms at 989 TFLOP/s.
//
// Both routes make three launches; each output element is summed by one
// block, in a fixed order (no two blocks add to one element), so two calls
// give the same bits:
//   (a) stats: recomputes each row's log-sum-exp over its keys (the
//       forward kernels keep no statistics, and stay as they are) and
//       D = rowsum(dO * O), both fp32 into a (B,H,rows) workspace each;
//   (b) dK/dV, one block per (key tile, KV head, batch): keeps the tile's
//       dK and dV in registers and walks the group's query heads, and for
//       each the query tiles the masks allow, in order: recompute P, dP and
//       dS, then dV += P^T dO, dK += dS^T Q.  GQA's sum over query heads
//       happens inside the block;
//   (c) dQ, one block per (query tile, head, batch): keeps the tile's dQ in
//       registers and walks the key tiles its rows attend: recompute P, dP
//       and dS, then dQ += dS K.  No split over keys.
// The wrapper (kernels/flash_attention/flash_attention.py, route_bwd())
// picks the route before it launches.
//
// "wgmma", bf16 with Dh 64, 128 or 256 (the bf16 training path): every
// product on the tensor cores, wgmma fed by TMA, as the forward's
// (csrc/flash_attention.cu).  Tiles are 64 rows (queries or keys) of Dh,
// read through 4-D tensor maps (Dh, S, heads, B) of the contiguous tensors
// in boxes one 64-column, 128-byte swizzle atom wide, so a box never
// crosses a head or batch edge and rows past S arrive as zeros.  A block
// is one warpgroup (two at Dh 256 in (b)); its thread 0 issues the loads:
// the block's fixed tiles on one mbarrier, then a ring of 2 stages, each
// refilled once every warp is past it (a block-wide barrier), so a stage's
// load flies during the other stage's products.  Per 64 x 64 tile:
//   (a) S = Q K^T (SS wgmma: A = Q, B = K, both K-major over Dh), the
//       online max and sum in the log2 domain (scale log2(e) folded in);
//       lse is stored in log2 units (lse2, which only this route reads),
//       and the rows are padded to whole tiles in the workspaces;
//   (b) S^T = K Q^T and dP^T = V dO^T (SS: A the block's K or V, B the Q or
//       dO tile, all K-major over Dh), then P^T = exp2(S^T scale log2(e) -
//       lse2[query]) under the masks and dS^T = P^T (dP^T - D[query]),
//       lse2 and D per column from the stage (a 256-byte bulk copy each),
//       then dV += P^T dO and dK += dS^T Q on register-A wgmma: P^T and
//       dS^T rounded to bf16 pairs are, register for register, the A
//       fragments (the m64n64 accumulator's layout), and the same Q and dO
//       tiles are read again MN-major, the depth over their 64 rows (one
//       tile, two descriptors: the 128-byte swizzle and one-atom boxes
//       make both readings of one layout, as the forward reads K and V);
//   (c) S = Q K^T and dP = dO V^T (SS), P and dS with lse2 and D per row in
//       registers, then dQ += dS K (register A, K read MN-major).  Query
//       tiles go out last first: causal blocks heaviest first.
// Each product is waited for (wgmma_wait<0>, then register fences) before
// its accumulators are read.  A masked probability is set to exactly 0
// after the exponential, rows past S included; masks are evaluated only
// on tiles that cross the diagonal, the window edge or S.  The epilogues
// round dQ, dK (times the scale) and dV to bf16 into the ring and write
// rows below S with 16-byte stores.  Registers: at Dh 128 (b) holds dK and
// dV (128 a thread) beside S^T and dP^T (64), so its blocks are single
// warpgroups (the 255-register cap; 384-thread blocks are held near 168)
// and two fit an SM (about 99 KB of shared memory each); at Dh 256 dK and
// dV alone would take 256, so one warpgroup computes S^T, P^T and dV, and
// hands P^T over in shared memory (fp32, 16 KB, a named barrier) to the
// second, which computes dP^T, dS^T and dK.  Rounding P and dS to bf16
// before the second products is the one rounding the SIMT kernels do not
// make (at most 2^-9 of each), as in the forward.
// Expected, from arithmetic before the first run on the card: at the
// training shape the 64 x 64 tiles on and below the diagonal execute ~73
// GFLOP (one product in (a), four in (b), three in (c)); at 150-300
// TFLOP/s, a quarter of the bf16 peak or less as the forward reached, that
// is 0.25-0.5 ms a call (the SIMT kernels: 4.48 ms).
//
// "simt", every other call (fp32, whose contract allows no TF32; Dh 8,
// 12, 16, 32 and 80): plain fp32 FMAs.  256 threads a block.  Tiles live in shared
// memory as fp32 rows of Dh + 1 floats (an odd stride: reading one column
// down 16 rows meets 16 banks); a score tile (BT x BT) gives each thread a
// (BT/16) x (BT/16) patch of rows ti + 16a, columns tj + 16b, the 16
// threads of a row patch being a half warp (row max and sum by shuffles);
// a (BT x Dh) accumulator gives each thread rows tr + 8a and columns
// tc + 32b (a warp reads one row of P broadcast and 32 consecutive
// columns).  BT is 64 keys and queries, 32 at Dh 256 (shared memory:
// 165 KB at Dh 128, 140 KB at Dh 256); the workspaces are (B,H,S).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

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
  // bf16 at Dh 64, 128 and 256 takes the wgmma route: no SIMT instance
  constexpr bool F32 = std::is_same<T, float>::value;
  switch (Dh) {
    case 8: return launch_dh<T, 8>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    case 12: return launch_dh<T, 12>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    case 16: return launch_dh<T, 16>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    case 32: return launch_dh<T, 32>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    case 64: if constexpr (F32) return launch_dh<T, 64>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s); break;
    case 80: return launch_dh<T, 80>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    case 128: if constexpr (F32) return launch_dh<T, 128>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s); break;
    case 256: if constexpr (F32) return launch_dh<T, 256>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s); break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------ wgmma route

namespace wg {

constexpr int ROW = 128;          // bytes of one swizzled row: 64 bf16
constexpr int T = 64;             // rows of a tile: queries or keys
constexpr int ATOM = T * ROW;     // one 64-column swizzle atom of a tile
constexpr int STAGES = 2;         // ring depth of every kernel
constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Cfg {
  static constexpr int NA = DH / 64;               // swizzle atoms across Dh
  static constexpr int TILE = NA * ATOM;           // a 64 x DH bf16 tile
  // (b) at Dh 256: dV on one warpgroup, dK on another (dK and dV of 64
  // keys would take 256 registers a thread on one)
  static constexpr bool SPLIT = DH > 128;
  static constexpr int THREADS_B = SPLIT ? 256 : 128;
  static constexpr int LDO = DH + 8;               // epilogue tile row, bf16
  static constexpr int EPI = T * LDO * 2;          // epilogue tile, bytes
  static constexpr int BARS = 8 * (STAGES + 1);    // full[STAGES], fixed
  // (a) Q, a ring of K tiles
  static constexpr int SMEM_A = 1024 + TILE + STAGES * TILE + BARS;
  // (b) K, V, a ring of {Q, dO, lse[64], D[64]} (1024-aligned), P^T's
  // hand-over buffer (SPLIT)
  static constexpr int STAGE_B = 2 * TILE + 1024;
  static constexpr int PBUF = SPLIT ? 32 * 128 * 4 : 0;
  static constexpr int SMEM_B =
      1024 + 2 * TILE + STAGES * STAGE_B + PBUF + BARS;
  // (c) Q, dO, lse and D (1024 bytes), a ring of {K, V}
  static constexpr int STAGE_C = 2 * TILE;
  static constexpr int SMEM_C = 1024 + 2 * TILE + 1024 + STAGES * STAGE_C +
                                BARS;
  static_assert(DH % 64 == 0 && NA <= 4, "Dh 64, 128 or 256");
  static_assert(SMEM_B <= 232448 && SMEM_C <= 232448, "shared memory");
  static_assert(2 * EPI <= STAGES * STAGE_B && EPI <= STAGES * STAGE_C,
                "epilogue tiles must fit the ring");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// every (query, key) pair of queries [q0, q0 + 64) and keys [k0, k0 + 64)
// attends: the tile needs no masks
__device__ __forceinline__ bool all_attend(int q0, int k0, int S, int causal,
                                           int window) {
  if (q0 + T > S || k0 + T > S) return false;
  if (causal && q0 < k0 + T - 1) return false;
  if (window >= 0) {
    if (q0 + T - 1 - k0 >= window) return false;
    if (!causal && k0 + T - 1 - q0 >= window) return false;
  }
  return true;
}

// the 64 x DH tile at (row, head, b) of a (Dh, S, heads, B) map, atom by
// atom
template <int NA>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int head,
                                          int b) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
    hopper::tma_load_4d(dst + a * ATOM, map, bar, 64 * a, row, head, b);
}

// acc (64 x N) += A B^T, A (64 rows) and B (N rows) K-major tiles of NA
// atoms ATOM bytes apart, the depth in k16 steps of 32 bytes
template <int N, int NA>
__device__ __forceinline__ void products_kk(float* acc, const uint8_t* a,
                                            const uint8_t* b) {
#pragma unroll
  for (int x = 0; x < NA; ++x) {
    const uint64_t da = hopper::desc_sw128(a + x * ATOM, 16, 1024);
    const uint64_t db = hopper::desc_sw128(b + x * ATOM, 16, 1024);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hopper::wgmma_bf16<N, 0, 0>(acc, da + 2 * k, db + 2 * k);
  }
}

// acc (64 x DH) += A B: A (64 x 64) bf16 pairs in registers, a[j] the k16
// step j; B a 64-row tile read MN-major (its rows are the depth), a k16
// step 16 rows down, atoms ATOM bytes apart (LBO)
template <int DH>
__device__ __forceinline__ void products_rs(float* acc,
                                            const uint32_t (&a)[4][4],
                                            const uint8_t* b) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    hopper::wgmma_bf16_rs<DH, 1>(
        acc, a[j], hopper::desc_sw128(b + j * 16 * ROW, ATOM, 1024));
}

// a 64 x 64 fp32 fragment as the A operand of the next product
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[j][e] = pack_bf16(x[8 * j + 2 * e], x[8 * j + 2 * e + 1]);
}

// acc * mul rounded to bf16 into a 64 x LDO shared tile (thread t's rows
// 16 (t / 32) + (t % 32) / 4 and + 8, columns 8 (q / 4) + 2 (t % 4))
template <int DH>
__device__ __forceinline__ void frag_to_tile(const float (&acc)[DH / 2],
                                             float mul, __nv_bfloat16* tile,
                                             int t) {
  constexpr int LDO = Cfg<DH>::LDO;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int c = 2 * (t % 4);
#pragma unroll
  for (int q = 0; q < DH / 2; q += 2) {
    const int i = (q >> 1) & 1;
    *reinterpret_cast<uint32_t*>(tile + (r + 8 * i) * LDO + 8 * (q >> 2) +
                                 c) = pack_bf16(acc[q] * mul,
                                                acc[q + 1] * mul);
  }
}

// the first `rows` rows of a shared tile to rows `stride` elements apart,
// 16-byte stores by one warpgroup
template <int DH>
__device__ __forceinline__ void tile_to_global(const __nv_bfloat16* tile,
                                               __nv_bfloat16* dst,
                                               long long stride, int rows,
                                               int t) {
  constexpr int CH = DH / 8;
  constexpr int LDO = Cfg<DH>::LDO;
  for (int i = t; i < T * CH; i += 128) {
    const int r = i / CH;
    if (r < rows)
      *reinterpret_cast<uint4*>(dst + r * stride + (i % CH) * 8) =
          *reinterpret_cast<const uint4*>(tile + r * LDO + (i % CH) * 8);
  }
}

// ------------------------------------------------------- (a) statistics

// The online row max and sum of one key tile's scores s (thread t's rows
// r0 and r0 + 8, keys k0 + 8 (q / 4) + c + q % 2), in the log2 domain.
template <bool MASK>
__device__ __forceinline__ void stats_tile(float (&s)[32], float (&m)[2],
                                           float (&l)[2], int r0, int k0,
                                           int c, int S, int causal,
                                           int window, float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int i = (q >> 1) & 1;
    float x = s[q] * scale_log2;
    if (MASK && !attends(r0 + 8 * i, k0 + 8 * (q >> 2) + c + (q & 1), S,
                         causal, window))
      x = __int_as_float(0xff800000);          // -inf: exp2f gives 0
    s[q] = x;
    mx[i] = fmaxf(mx[i], x);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    l[i] *= exp2f(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int i = (q >> 1) & 1;
    l[i] += exp2f(s[q] - m[i]);
  }
}

// Block (head, query tile from the last, batch), one warpgroup: lse2 (the
// log-sum-exp of scale log2(e) q.k, log2 units) and D = rowsum(dO * O) of
// 64 rows, into (B, H, Sp) workspaces; rows past S get 0.
template <int DH>
__global__ void __launch_bounds__(128)
fa_bwd_stats_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          float* __restrict__ lse, float* __restrict__ delta,
                          int S, int Sp, int H, int groups, int causal,
                          int window, float scale_log2) {
  using K = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ring = qs + K::TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * K::TILE);
  uint64_t* fixed = full + STAGES;
  const int t = threadIdx.x;
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T;
  const int b = blockIdx.z;
  int k_lo, k_hi;
  key_range(q0, min(q0 + T, S) - 1, S, causal, window, k_lo, k_hi);
  const int t_lo = k_lo / T;
  const int n_steps = k_hi > k_lo ? (k_hi + T - 1) / T - t_lo : 0;

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init(fixed, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int n) {
    const int s = n % STAGES;
    hopper::mbar_arrive_expect_tx(&full[s], K::TILE);
    load_tile<K::NA>(ring + s * K::TILE, &tk, &full[s], (t_lo + n) * T,
                     h / groups, b);
  };
  if (t == 0) {
    hopper::mbar_arrive_expect_tx(fixed, K::TILE);
    load_tile<K::NA>(qs, &tq, fixed, q0, h, b);
    for (int n = 0; n < min(STAGES, n_steps); ++n) issue(n);
  }

  // D while the loads fly: two threads a row, 16-byte reads, a fixed order
  {
    const int r = t / 2, half = t % 2;
    float d = 0.f;
    if (q0 + r < S) {
      const long long off =
          ((static_cast<long long>(b) * S + q0 + r) * H + h) * DH +
          half * (DH / 2);
#pragma unroll 4
      for (int col = 0; col < DH / 2; col += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + off + col);
        const uint4 gv = *reinterpret_cast<const uint4*>(dout + off + col);
        const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const auto* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(o2[e]);
          const float2 g = __bfloat1622float2(g2[e]);
          d = fmaf(g.x, a.x, d);
          d = fmaf(g.y, a.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0)
      delta[(static_cast<long long>(b) * H + h) * Sp + q0 + r] = d;
  }

  const int r0 = q0 + 16 * (t / 32) + (t % 32) / 4;
  const int c = 2 * (t % 4);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(fixed, 0);
  for (int n = 0; n < n_steps; ++n) {
    const int s = n % STAGES;
    const int k0 = (t_lo + n) * T;
    hopper::mbar_wait(&full[s], (n / STAGES) & 1);
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    hopper::fence_regs(sacc);
    hopper::wgmma_fence();
    products_kk<T, K::NA>(sacc, qs, ring + s * K::TILE);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    if (all_attend(q0, k0, S, causal, window))
      stats_tile<false>(sacc, m, l, r0, k0, c, S, causal, window, scale_log2);
    else
      stats_tile<true>(sacc, m, l, r0, k0, c, S, causal, window, scale_log2);
    __syncthreads();                     // every warp is done with stage s
    if (t == 0 && n + STAGES < n_steps) issue(n + STAGES);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    // a row that attends no key (or lies past S): P is 0 wherever read
    if (c == 0)
      lse[(static_cast<long long>(b) * H + h) * Sp + r0 + 8 * i] =
          l[i] > 0.f ? m[i] + log2f(l[i]) : 0.f;
  }
}

// ------------------------------------------------------------ (b) dK, dV

struct KeyBlock {
  int S, KV, causal, window;
  float scale, scale_log2;
  int b, kvh, k0, qt_lo, nq, n_steps;
};

// One warpgroup's part of (b).  ROLE 2 (Dh 64, 128): the whole step, dV
// and dK; at Dh 256 ROLE 0 (S^T, P^T, dV += P^T dO; hands P^T over in
// shared memory) and ROLE 1 (dP^T, dS^T, dK += dS^T Q).
template <int DH, int ROLE, typename Issue>
__device__ __forceinline__ void dkdv_role(const KeyBlock& g, Issue issue,
                                          const uint8_t* ks,
                                          const uint8_t* vs, uint8_t* ring,
                                          float* pbuf, uint64_t* full, int t,
                                          __nv_bfloat16* __restrict__ dk,
                                          __nv_bfloat16* __restrict__ dv) {
  using K = Cfg<DH>;
  constexpr bool DO_S = ROLE != 1, DO_DP = ROLE != 0;
  constexpr int NT = K::THREADS_B;
  float dva[DO_S ? DH / 2 : 1], dka[DO_DP ? DH / 2 : 1];
  if constexpr (DO_S) {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dva[i] = 0.f;
  }
  if constexpr (DO_DP) {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dka[i] = 0.f;
  }
  // this thread's keys kr and kr + 8, queries 8 (q / 4) + c + q % 2
  const int kr = g.k0 + 16 * (t / 32) + (t % 32) / 4;
  const int c = 2 * (t % 4);
  for (int n = 0; n < g.n_steps; ++n) {
    const int s = n % STAGES;
    const int q0 = (g.qt_lo + n % g.nq) * T;
    hopper::mbar_wait(&full[s], (n / STAGES) & 1);
    const uint8_t* qt = ring + s * K::STAGE_B;
    const uint8_t* dot = qt + K::TILE;
    const float* Ls = reinterpret_cast<const float*>(qt + 2 * K::TILE);
    const float* Ds = Ls + T;
    float sacc[DO_S ? 32 : 1], dpacc[DO_DP ? 32 : 1];
    if constexpr (DO_S) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
      hopper::fence_regs(sacc);
    }
    if constexpr (DO_DP) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dpacc[i] = 0.f;
      hopper::fence_regs(dpacc);
    }
    hopper::wgmma_fence();
    if constexpr (DO_S) products_kk<T, K::NA>(sacc, ks, qt);     // S^T
    if constexpr (DO_DP) products_kk<T, K::NA>(dpacc, vs, dot);  // dP^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    if constexpr (DO_S) hopper::fence_regs(sacc);
    if constexpr (DO_DP) hopper::fence_regs(dpacc);
    const bool whole = all_attend(q0, g.k0, g.S, g.causal, g.window);
    if constexpr (DO_S) {
      // P^T = exp2(S^T scale log2(e) - lse2[query]), masked to exactly 0
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int col = 8 * (q >> 2) + c + (q & 1);
        const float p = exp2f(fmaf(sacc[q], g.scale_log2, -Ls[col]));
        sacc[q] = whole || attends(q0 + col, kr + 8 * ((q >> 1) & 1), g.S,
                                   g.causal, g.window)
                      ? p : 0.f;
      }
      if constexpr (ROLE == 0) {
#pragma unroll
        for (int q = 0; q < 32; ++q) pbuf[q * 128 + t] = sacc[q];
        hopper::named_bar_arrive(1, NT);
      }
    }
    if constexpr (DO_DP) {
      if constexpr (ROLE == 1) hopper::named_bar_sync(1, NT);
      // dS^T = P^T (dP^T - D[query])
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        float p;
        if constexpr (ROLE == 1)
          p = pbuf[q * 128 + t];
        else
          p = sacc[q];
        dpacc[q] = p * (dpacc[q] - Ds[8 * (q >> 2) + c + (q & 1)]);
      }
    }
    uint32_t pa[4][4], da[4][4];
    if constexpr (DO_S) {
      pack_a(sacc, pa);
      hopper::fence_regs(dva);
    }
    if constexpr (DO_DP) {
      pack_a(dpacc, da);
      hopper::fence_regs(dka);
    }
    hopper::wgmma_fence();
    if constexpr (DO_S) products_rs<DH>(dva, pa, dot);           // dV
    if constexpr (DO_DP) products_rs<DH>(dka, da, qt);           // dK
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    if constexpr (DO_S) hopper::fence_regs(dva);
    if constexpr (DO_DP) hopper::fence_regs(dka);
    hopper::named_bar_sync(2, NT);       // every warp is done with stage s
    if (ROLE != 1 && t == 0 && n + STAGES < g.n_steps) issue(n + STAGES);
  }
  // epilogue: dV, dK * scale rounded to bf16 in the ring, then rows < S
  __nv_bfloat16* tv = reinterpret_cast<__nv_bfloat16*>(ring);
  __nv_bfloat16* tk = reinterpret_cast<__nv_bfloat16*>(ring + K::EPI);
  if constexpr (DO_S) frag_to_tile<DH>(dva, 1.f, tv, t);
  if constexpr (DO_DP) frag_to_tile<DH>(dka, g.scale, tk, t);
  hopper::named_bar_sync(2, NT);
  const long long at = ((static_cast<long long>(g.b) * g.S + g.k0) * g.KV +
                        g.kvh) * DH;
  const int rows = min(T, g.S - g.k0);
  if constexpr (DO_S)
    tile_to_global<DH>(tv, dv + at, static_cast<long long>(g.KV) * DH, rows,
                       t);
  if constexpr (DO_DP)
    tile_to_global<DH>(tk, dk + at, static_cast<long long>(g.KV) * DH, rows,
                       t);
}

// Block (KV head, key tile, batch): the tile's K and V loaded once, then
// the group's query heads, for each the query tiles the masks allow.
template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::THREADS_B)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int S, int Sp, int H,
                         int KV, int causal, int window, float scale,
                         float scale_log2) {
  using K = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + K::TILE;
  uint8_t* ring = vs + K::TILE;
  float* pbuf = reinterpret_cast<float*>(ring + STAGES * K::STAGE_B);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(pbuf) + K::PBUF);
  uint64_t* fixed = full + STAGES;
  KeyBlock g;
  g.S = S;
  g.KV = KV;
  g.causal = causal;
  g.window = window;
  g.scale = scale;
  g.scale_log2 = scale_log2;
  g.kvh = blockIdx.x;
  g.k0 = blockIdx.y * T;
  g.b = blockIdx.z;
  const int groups = H / KV;
  int q_lo, q_hi;
  query_range(g.k0, min(g.k0 + T, S) - 1, S, causal, window, q_lo, q_hi);
  g.qt_lo = q_lo / T;
  g.nq = q_hi > q_lo ? (q_hi + T - 1) / T - g.qt_lo : 0;
  g.n_steps = groups * g.nq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init(fixed, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int n) {
    const int s = n % STAGES;
    const int h = g.kvh * groups + n / g.nq;
    const int q0 = (g.qt_lo + n % g.nq) * T;
    uint8_t* st = ring + s * K::STAGE_B;
    const long long at = (static_cast<long long>(g.b) * H + h) * Sp + q0;
    hopper::mbar_arrive_expect_tx(&full[s], 2 * K::TILE + 2 * T * 4);
    load_tile<K::NA>(st, &tq, &full[s], q0, h, g.b);
    load_tile<K::NA>(st + K::TILE, &tdo, &full[s], q0, h, g.b);
    hopper::bulk_load(st + 2 * K::TILE, lse + at, T * 4, &full[s]);
    hopper::bulk_load(st + 2 * K::TILE + T * 4, delta + at, T * 4, &full[s]);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(fixed, 2 * K::TILE);
    load_tile<K::NA>(ks, &tk, fixed, g.k0, g.kvh, g.b);
    load_tile<K::NA>(vs, &tv, fixed, g.k0, g.kvh, g.b);
    for (int n = 0; n < min(STAGES, g.n_steps); ++n) issue(n);
  }
  hopper::mbar_wait(fixed, 0);
  const int t = threadIdx.x % 128;
  if constexpr (K::SPLIT) {
    if (threadIdx.x < 128)
      dkdv_role<DH, 0>(g, issue, ks, vs, ring, pbuf, full, t, dk, dv);
    else
      dkdv_role<DH, 1>(g, issue, ks, vs, ring, pbuf, full, t, dk, dv);
  } else {
    dkdv_role<DH, 2>(g, issue, ks, vs, ring, pbuf, full, t, dk, dv);
  }
}

// ---------------------------------------------------------------- (c) dQ

// Block (head, query tile from the last, batch), one warpgroup: Q, dO,
// lse2 and D loaded once, then the key tiles the rows attend, in order.
template <int DH>
__global__ void __launch_bounds__(128)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int S, int Sp, int H,
                       int groups, int causal, int window, float scale,
                       float scale_log2) {
  using K = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* dos = qs + K::TILE;
  float* lsd = reinterpret_cast<float*>(dos + K::TILE);   // lse2[64], D[64]
  uint8_t* ring = dos + K::TILE + 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * K::STAGE_C);
  uint64_t* fixed = full + STAGES;
  const int t = threadIdx.x;
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T;
  const int b = blockIdx.z;
  const int kvh = h / groups;
  int k_lo, k_hi;
  key_range(q0, min(q0 + T, S) - 1, S, causal, window, k_lo, k_hi);
  const int t_lo = k_lo / T;
  const int n_steps = k_hi > k_lo ? (k_hi + T - 1) / T - t_lo : 0;

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init(fixed, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int n) {
    const int s = n % STAGES;
    uint8_t* st = ring + s * K::STAGE_C;
    hopper::mbar_arrive_expect_tx(&full[s], 2 * K::TILE);
    load_tile<K::NA>(st, &tk, &full[s], (t_lo + n) * T, kvh, b);
    load_tile<K::NA>(st + K::TILE, &tv, &full[s], (t_lo + n) * T, kvh, b);
  };
  if (t == 0) {
    const long long at = (static_cast<long long>(b) * H + h) * Sp + q0;
    hopper::mbar_arrive_expect_tx(fixed, 2 * K::TILE + 2 * T * 4);
    load_tile<K::NA>(qs, &tq, fixed, q0, h, b);
    load_tile<K::NA>(dos, &tdo, fixed, q0, h, b);
    hopper::bulk_load(lsd, lse + at, T * 4, fixed);
    hopper::bulk_load(lsd + T, delta + at, T * 4, fixed);
    for (int n = 0; n < min(STAGES, n_steps); ++n) issue(n);
  }
  // this thread's rows r and r + 8 of the tile, keys 8 (q / 4) + c + q % 2
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int c = 2 * (t % 4);
  hopper::mbar_wait(fixed, 0);
  const float l2[2] = {lsd[r], lsd[r + 8]};
  const float dd[2] = {lsd[T + r], lsd[T + r + 8]};
  float dqa[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dqa[i] = 0.f;
  for (int n = 0; n < n_steps; ++n) {
    const int s = n % STAGES;
    const int k0 = (t_lo + n) * T;
    hopper::mbar_wait(&full[s], (n / STAGES) & 1);
    const uint8_t* kt = ring + s * K::STAGE_C;
    float sacc[32], dpacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] = 0.f;
      dpacc[i] = 0.f;
    }
    hopper::fence_regs(sacc);
    hopper::fence_regs(dpacc);
    hopper::wgmma_fence();
    products_kk<T, K::NA>(sacc, qs, kt);                // S = Q K^T
    products_kk<T, K::NA>(dpacc, dos, kt + K::TILE);    // dP = dO V^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    hopper::fence_regs(dpacc);
    const bool whole = all_attend(q0, k0, S, causal, window);
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int i = (q >> 1) & 1;
      float p = exp2f(fmaf(sacc[q], scale_log2, -l2[i]));
      if (!whole && !attends(q0 + r + 8 * i, k0 + 8 * (q >> 2) + c + (q & 1),
                             S, causal, window))
        p = 0.f;
      dpacc[q] = p * (dpacc[q] - dd[i]);                // dS
    }
    uint32_t da[4][4];
    pack_a(dpacc, da);
    hopper::fence_regs(dqa);
    hopper::wgmma_fence();
    products_rs<DH>(dqa, da, kt);                       // dQ += dS K
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dqa);
    __syncthreads();                     // every warp is done with stage s
    if (t == 0 && n + STAGES < n_steps) issue(n + STAGES);
  }
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring);
  frag_to_tile<DH>(dqa, scale, tile, t);
  __syncthreads();
  tile_to_global<DH>(
      tile, dq + ((static_cast<long long>(b) * S + q0) * H + h) * DH,
      static_cast<long long>(H) * DH, min(T, S - q0), t);
}

// ---------------------------------------------------------------- launch

// the shared memory above 48 KB, opted into once per device
template <typename KernelFn>
int opt_in(KernelFn kernel, int smem, bool (&ready)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  return 0;
}

template <int DH>
int launch_dh(int stage, const void* q, const void* k, const void* v,
              const void* o, const void* dout, float* lse, float* delta,
              void* dq, void* dk, void* dv, int B, int S, int H, int KV,
              int causal, int window, float scale, cudaStream_t st) {
  using K = Cfg<DH>;
  static bool ready[3][MAX_DEVICES] = {};
  const int tiles = (S + T - 1) / T;
  const int Sp = tiles * T;              // the workspaces' row length
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * LOG2E;
  // (Dh, S, heads, B) maps of the contiguous tensors, 64 x 64 boxes;
  // encoded on the host at every call, passed by value
  CUtensorMap tq, tk, tv, tdo;
  const long long qs = static_cast<long long>(H) * DH;
  const long long kvs = static_cast<long long>(KV) * DH;
  int rc = hopper::encode_bf16_4d_sw128(&tq, q, DH, S, H, B, qs, DH, S * qs,
                                        64, T);
  if (rc == 0)
    rc = hopper::encode_bf16_4d_sw128(&tk, k, DH, S, KV, B, kvs, DH,
                                      S * kvs, 64, T);
  if (rc == 0 && stage != STATS)
    rc = hopper::encode_bf16_4d_sw128(&tv, v, DH, S, KV, B, kvs, DH,
                                      S * kvs, 64, T);
  if (rc == 0 && stage != STATS)
    rc = hopper::encode_bf16_4d_sw128(&tdo, dout, DH, S, H, B, qs, DH,
                                      S * qs, 64, T);
  if (rc != 0) return rc;
  const auto* ot = static_cast<const __nv_bfloat16*>(o);
  const auto* dt = static_cast<const __nv_bfloat16*>(dout);
  if (stage == STATS) {
    rc = opt_in(fa_bwd_stats_wgmma_kernel<DH>, K::SMEM_A, ready[0]);
    if (rc != 0) return rc;
    fa_bwd_stats_wgmma_kernel<DH><<<dim3(H, tiles, B), 128, K::SMEM_A, st>>>(
        tq, tk, ot, dt, lse, delta, S, Sp, H, H / KV, causal, window,
        scale_log2);
  } else if (stage == DKDV) {
    rc = opt_in(fa_bwd_dkdv_wgmma_kernel<DH>, K::SMEM_B, ready[1]);
    if (rc != 0) return rc;
    fa_bwd_dkdv_wgmma_kernel<DH>
        <<<dim3(KV, tiles, B), K::THREADS_B, K::SMEM_B, st>>>(
            tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
            static_cast<__nv_bfloat16*>(dv), S, Sp, H, KV, causal, window,
            scale, scale_log2);
  } else if (stage == DQ) {
    rc = opt_in(fa_bwd_dq_wgmma_kernel<DH>, K::SMEM_C, ready[2]);
    if (rc != 0) return rc;
    fa_bwd_dq_wgmma_kernel<DH><<<dim3(H, tiles, B), 128, K::SMEM_C, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), S, Sp,
        H, H / KV, causal, window, scale, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch(int stage, const void* q, const void* k, const void* v,
           const void* o, const void* dout, void* lse_, void* delta_,
           void* dq, void* dk, void* dv, int B, int S, int H, int KV, int Dh,
           int causal, int window, float scale, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  float* lse = static_cast<float*>(lse_);
  float* delta = static_cast<float*>(delta_);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return launch_dh<64>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    case 128: return launch_dh<128>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    case 256: return launch_dh<256>(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wg

}  // namespace

// C entry points, bound with ctypes.  q, o, dout and dq are contiguous
// (B,S,H,Dh); k, v, dk and dv contiguous (B,S,KV,Dh); lse and delta fp32
// (B,H,S) workspaces, (B,H,Sp) with Sp = S rounded up to 64 on the wgmma
// route (the third entry: bf16, Dh 64, 128 or 256, every base 16-byte
// aligned).  `stage` is 0 (stats: writes lse and delta), 1 (dK,
// dV: reads lse and delta) or 2 (dQ: reads lse and delta); pointers a
// stage does not use may be null.  window < 0 means no window; causal is
// 0 or 1; Dh is 8, 12, 16, 32, 64, 80, 128 or 256 (bf16 on the SIMT
// entry: 8, 12, 16, 32 or 80; on the wgmma entry: 64, 128 or 256).  Each
// returns cudaGetLastError() after its launch, or the error that kept it
// from launching.
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

extern "C" int repro_flash_attention_bwd_bf16_wgmma(
    int stage, const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* lse, void* delta, void* dq, void* dk, void* dv,
    int B, int S, int H, int KV, int Dh, int causal, int window, float scale,
    void* stream) {
  return wg::launch(stage, q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                    KV, Dh, causal, window, scale, stream);
}
