// Flash attention for Hopper (sm_90a): online-softmax GQA attention with
// causal and sliding-window masks, fp32 accumulation, output in q's dtype.
//   q (B,S,H,Dh), k/v (B,S,KV,Dh) -> o (B,S,H,Dh); query head h reads KV
//   head h / (H/KV).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention_pallas (_fa_kernel: a dense (B*H, q tiles, kv tiles)
// grid whose innermost kv axis carries the running max, sum and
// accumulator in VMEM scratch).
//
// Both routes keep the Pallas recurrence: scores scaled by 1/sqrt(Dh),
// masked scores NEG_INF = -1e30 (the wgmma route masks with -inf under a
// running max that starts at NEG_INF: the same max), masked probabilities
// exactly 0, the denominator clamped at 1e-30 (a fully masked row comes
// out 0).  A block
// walks only the key tiles that some of its rows attend (causal: up to its
// last row; window: from its first row minus the window); a skipped tile
// would give alpha = 1 and p = 0, so the skip is exact.  Keys are walked
// in a fixed order, with no split over keys and no atomics, so two calls
// give the same bits.
//
// What bounds it on an H100: operations.  At the serving shapes (qwen3-8b,
// S = 1000, causal, bf16) a call does ~8.2 GFLOP of products against
// ~20 MB of q/k/v/o, about 400 operations per byte, above the card's
// ratio of tensor-core rate to memory rate; its least time is set by the
// 989 TFLOP/s bf16 rate.  Two routes, chosen by the wrapper before it
// launches (kernels/flash_attention/flash_attention.py, route()):
//
// "wgmma", bf16 q/k/v with Dh 64, 128 or 256 that TMA can read (innermost
// stride 1, other strides and the bases 16-byte aligned): the whole bf16 LM
// prefill path.  Both products run on the tensor cores (wgmma, fp32
// accumulators), fed by TMA, which leaves the softmax on the SIMT units as the
// other cost.  One 384-thread block per (128 query rows, head, batch): a
// producer warpgroup whose one thread issues the TMA loads and two consumer
// warpgroups of 64 query rows each (setmaxnreg moves registers from the
// producer, 24, to the consumers, 240: setmaxnreg acts per warpgroup, so the
// producer is a whole warpgroup, not one warp). ptxas nonetheless compiles the
// consumers within about the launch bound's 168 registers a thread (the
// highest register in the SASS is R165 at Dh 256), so at Dh 256, where O alone
// takes 128, the instance spills and ptxas serializes its wgmmas.  q, k and v
// are read through 4-D tensor maps (Dh, S, heads, B), so a box never crosses a
// head or batch edge and rows past S arrive as zeros; boxes are one 64-column,
// 128-byte swizzle atom wide (Dh 128 is two atoms, Dh 256 four).  Q is loaded
// once; K/V tiles of BK keys walk a ring with a full and an empty mbarrier
// per stage.  BK is a template parameter that the wrapper picks
// (kernels/flash_attention/flash_attention.py, block_k; the default 128 for
// Dh <= 128, 32 for Dh 256, to keep S and P small beside O): the instances
// (Dh, BK) are (64, 64), (64, 128), (128, 64), (128, 128) and (256, 32), and
// the C entry refuses any other pair.  At Dh <= 128 the ring holds 256 keys
// (2 stages of 128, 4 of 64), 3 stages of 32 at Dh 256 (shared memory 81 KB
// at Dh 64, 161 KB at Dh 128 and 256).  Per tile a consumer warpgroup runs S = Q K^T (A = Q and B = K both
// K-major from shared memory, N = BK, the depth Dh in k16 steps across the
// atoms), then the online softmax on the accumulator fragment: a row's values
// lie on the 4 threads of a quad, so two shuffles give its max; log2(e) is
// folded into the scale and the exponentials are exp2f; the masks are
// evaluated only on tiles that cross the diagonal, the window edge or S. P is
// rounded to bf16 pairs, which are, register for register, the A-operand
// fragment of the next product (the m64nNk16 accumulator of 16 key columns has
// the A fragment's layout), so O += P V is a register-A wgmma with V MN-major
// from shared memory and N = Dh: P never touches shared memory.  The row sums
// stay in fp32 (unrounded p), per thread, and are summed over the quad at the
// end.  Rounding P to bf16 is the one rounding the Pallas kernel (P in fp32)
// does not make: at most 2^-9 of each probability.  Each product is waited for
// (wgmma_wait<0>, then register fences) before its accumulators are read: with
// a group left in flight ptxas moved accumulator reads above the wait in the
// grouped matmul (csrc/grouped_matmul.cu).  The two consumer warpgroups
// overlap each other's softmax with their products; overlapping one tile's
// softmax with the next tile's products inside a warpgroup is not done.  The
// epilogue divides O by the row sum, rounds to bf16, and writes the contiguous
// (B,S,H,Dh) output through shared memory with 16-byte stores; rows past S are
// not written.  Blocks take the heads along grid x and the query tiles, last
// first, along y: the dispatcher walks x fastest, so causal blocks go out
// heaviest first over all heads.
//
// "simt", every other call (fp32, whose contract allows no TF32; Dh 8,
// 12, 16, 32 and 80; strided views TMA cannot read): plain fp32 FMAs at
// the 67 TFLOP/s fp32 SIMT rate.  One 256-thread block per (64 query rows,
// head, batch).  The block's 64 query rows are staged once in shared
// memory as fp32; the block then walks 64-key tiles of k and v through
// shared memory.  Each thread owns 4 query rows and, for the 64x64 score
// tile, 4 keys strided by 16, so the 16 threads of a row group are one
// half warp and the row max and row sum are warp shuffles.  Probabilities
// go through a shared-memory tile that the same half warp reads back for
// the value product; each thread accumulates its 4 rows by 4 contiguous
// columns out of every 64.  The ragged edge (S not a multiple of 64) is
// masked: rows and keys past S are zero-filled and masked.  q, k and v
// are read through their batch, sequence and head strides (last axis
// contiguous), so the projections' (B,S,H,Dh) outputs go in without a
// transposed copy.  Dh is a template parameter (8, 12, 16, 32, 64, 80,
// 128, 256); above 48 KB the shared tiles are dynamic shared memory (Dh
// 256 takes 210 KB, one block per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------- wgmma

namespace wg {

constexpr int BQ = 128;           // query rows per block: two warpgroups of 64
constexpr int THREADS = 384;      // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int SMEM_LIMIT = 232448;           // per block on an H100
constexpr int ROW = 128;          // bytes of one swizzled row: 64 bf16

template <int DH, int BK_>
struct Cfg {
  static constexpr int NA = DH / 64;               // swizzle atoms across Dh
  // keys per tile and K/V ring depth: 256 keys in flight at Dh <= 128 (the
  // ring's bytes of the 128-key tile); at Dh 256 O takes 128 registers a
  // thread, and 32-key tiles keep S and P small (64-key tiles spilled
  // more, and were slower on the card), 3 stages
  static constexpr int BK = BK_;
  static constexpr int STAGES = DH <= 128 ? 256 / BK : 3;
  static constexpr int Q_BOX = BQ * ROW;           // one atom of Q
  static constexpr int KV_BOX = BK * ROW;          // one atom of a K/V tile
  static constexpr int Q_BYTES = NA * Q_BOX;
  static constexpr int K_BYTES = NA * KV_BOX;
  static constexpr int STAGE = 2 * K_BYTES;        // K, then V
  static constexpr int LDO = DH + 8;      // epilogue tile row, bf16 (16-byte
                                          // padded: no bank conflicts)
  // 1024 bytes of slack to align Q and the ring (swizzle atoms start
  // 1024-aligned), then a full and an empty mbarrier per stage and Q's
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * STAGE + 8 * (2 * STAGES + 1);
  static_assert(DH % 64 == 0 && NA <= 4, "Dh 64, 128 or 256");
  static_assert(BK % 16 == 0 && BK <= 256 && STAGES >= 2, "key tile");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
  static_assert(BQ * LDO * 2 <= STAGES * STAGE, "epilogue tile too large");
};

// the key range [lo, hi) that some query row in [q_first, q_last] attends
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The online-softmax step on one tile's score fragment s (64 x BK; this
// thread's rows r0 and r0 + 8, columns k0 + 8 (q / 4) + c + q % 2): s
// becomes p = exp2(s log2(e) / sqrt(Dh) - m_new), m becomes m_new, alpha
// the factor for O, and l (this thread's partial row sums) is rescaled and
// takes p.  MASK: evaluate the masks (a tile that crosses the diagonal,
// the window edge or S).  A masked score is -inf here, not NEG_INF: the
// running max starts at NEG_INF, so it is the Pallas kernel's max all the
// same, it stays finite, and exp2f(-inf - m) is exactly the Pallas
// kernel's masked 0, even in a row masked so far (m = NEG_INF), without a
// second pass over the masks.
template <bool MASK, int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int r0, int k0, int c, int S,
                                             int causal, int window,
                                             float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int q = 0; q < BK / 2; ++q) {
    const int i = (q >> 1) & 1;
    float x = s[q] * scale_log2;
    if (MASK && !attends(r0 + 8 * i, k0 + 8 * (q >> 2) + c + (q & 1), S,
                         causal, window))
      x = __int_as_float(0xff800000);         // -inf
    s[q] = x;
    mx[i] = fmaxf(mx[i], x);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = exp2f(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int q = 0; q < BK / 2; ++q) {
    const int i = (q >> 1) & 1;
    s[q] = exp2f(s[q] - m[i]);
    l[i] += s[q];
  }
}

// S = Q K^T over the depth DH: k16 steps of 32 bytes inside each 128-byte
// swizzle atom, atom after atom
template <int DH, int BK>
__device__ __forceinline__ void qk_products(float* sacc, const uint8_t* qw,
                                            const uint8_t* kt) {
  using K = Cfg<DH, BK>;
#pragma unroll
  for (int a = 0; a < K::NA; ++a) {
    const uint64_t dq = hopper::desc_sw128(qw + a * K::Q_BOX, 16, 1024);
    const uint64_t dk = hopper::desc_sw128(kt + a * K::KV_BOX, 16, 1024);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hopper::wgmma_bf16<BK, 0, 0>(sacc, dq + (k * 32 >> 4),
                                   dk + (k * 32 >> 4));
  }
}

// tq, tk, tv: q, k, v as (Dh, S, heads, B) maps, boxes of 64 x BQ (q) or
// 64 x BK (k, v).  Block (head, query tile from the last, batch).
template <int DH, int BK>
__global__ void __launch_bounds__(THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int S, int H, int groups,
                int causal, int window, float scale_log2) {
  using K = Cfg<DH, BK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = qs + K::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + K::STAGES * K::STAGE);
  uint64_t* empty = full + K::STAGES;
  uint64_t* qbar = empty + K::STAGES;
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  int k_lo, k_hi;
  key_range(q0, min(q0 + BQ, S) - 1, S, causal, window, k_lo, k_hi);
  const int t_lo = k_lo / BK;
  const int t_hi = (k_hi + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);       // the consumers' 8 warps
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread loads Q, then keeps the K/V ring full
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int kvh = h / groups;
      hopper::mbar_arrive_expect_tx(qbar, K::Q_BYTES);
      for (int a = 0; a < K::NA; ++a)
        hopper::tma_load_4d(qs + a * K::Q_BOX, &tq, qbar, 64 * a, q0, h, b);
      int s = 0;
      uint32_t phase = 0;
      for (int t = t_lo; t < t_hi; ++t) {
        hopper::mbar_wait(&empty[s], phase ^ 1);   // round 0 passes
        uint8_t* st = ring + s * K::STAGE;
        hopper::mbar_arrive_expect_tx(&full[s], K::STAGE);
        for (int a = 0; a < K::NA; ++a) {
          hopper::tma_load_4d(st + a * K::KV_BOX, &tk, &full[s], 64 * a,
                              t * BK, kvh, b);
          hopper::tma_load_4d(st + K::K_BYTES + a * K::KV_BOX, &tv, &full[s],
                              64 * a, t * BK, kvh, b);
        }
        if (++s == K::STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns query rows q0 + 64 w .. + 63; this thread
  // rows r0 and r0 + 8 of them, columns c, c + 1 of every 8
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int ct = threadIdx.x - 128;
  const int w = ct / 128;
  const int t = ct % 128;
  const int wq0 = q0 + 64 * w;
  const int r0 = wq0 + 16 * (t / 32) + (t % 32) / 4;
  const int c = 2 * (t % 4);
  const bool active = wq0 < S;
  const int wq_last = min(wq0 + 63, S - 1);
  int wk_lo, wk_hi;
  key_range(wq0, wq_last, S, causal, window, wk_lo, wk_hi);
  const uint8_t* qw = qs + w * 64 * ROW;

  float oacc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(qbar, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int tt = t_lo; tt < t_hi; ++tt) {
    const int k0 = tt * BK;
    hopper::mbar_wait(&full[s], phase);
    const uint8_t* st = ring + s * K::STAGE;
    // a tile none of this warpgroup's rows attends is skipped (exact)
    if (active && k0 < wk_hi && k0 + BK > wk_lo) {
      float sacc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
      hopper::fence_regs(sacc);
      hopper::wgmma_fence();
      qk_products<DH, BK>(sacc, qw, st);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);

      // masks only where some (row, key) pair of the tile is not attended
      const bool interior =
          k0 + BK <= S && (!causal || k0 + BK - 1 <= wq0) &&
          (window < 0 || (wq_last - k0 < window &&
                          (causal || k0 + BK - 1 - wq0 < window)));
      float alpha[2];
      if (interior)
        softmax_tile<false, BK>(sacc, m, l, alpha, r0, k0, c, S, causal,
                                window, scale_log2);
      else
        softmax_tile<true, BK>(sacc, m, l, alpha, r0, k0, c, S, causal,
                               window, scale_log2);
      // P as bf16 pairs: the A fragment of k16 step j is accumulator
      // entries 8 j .. 8 j + 7
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[j][e] = pack_bf16(sacc[8 * j + 2 * e], sacc[8 * j + 2 * e + 1]);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];

      hopper::fence_regs(oacc);
      hopper::wgmma_fence();
      // V tile: BK rows of keys, atom a holds columns 64 a .. + 63; a k16
      // step is 16 rows (2048 bytes), atoms KV_BOX bytes apart (LBO)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        hopper::wgmma_bf16_rs<DH, 1>(
            oacc, pa[j],
            hopper::desc_sw128(st + K::K_BYTES + j * 16 * ROW, K::KV_BOX,
                               1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
    }
    if ((ct & 31) == 0) hopper::mbar_arrive(&empty[s]);
    if (++s == K::STAGES) {
      s = 0;
      phase ^= 1;
    }
  }

  // epilogue: O / l rounded to bf16 into the ring (both warpgroups are
  // past their last product), then rows of 16-byte stores
  float denom[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    denom[i] = fmaxf(l[i], 1e-30f);
  }
  hopper::named_bar_sync(1, 256);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring);
  const int tr = r0 - q0;
#pragma unroll
  for (int q = 0; q < DH / 2; q += 2) {
    const int i = (q >> 1) & 1;
    const int col = 8 * (q >> 2) + c;
    *reinterpret_cast<uint32_t*>(tile + (tr + 8 * i) * K::LDO + col) =
        pack_bf16(oacc[q] / denom[i], oacc[q + 1] / denom[i]);
  }
  hopper::named_bar_sync(1, 256);
  constexpr int CHUNKS = DH / 8;               // 16-byte chunks per row
  for (int i = ct; i < BQ * CHUNKS; i += 256) {
    const int r = i / CHUNKS, qp = q0 + r;
    if (qp < S)
      *reinterpret_cast<uint4*>(
          o + ((static_cast<long long>(b) * S + qp) * H + h) * DH +
          (i % CHUNKS) * 8) =
          *reinterpret_cast<const uint4*>(tile + r * K::LDO +
                                          (i % CHUNKS) * 8);
  }
}

constexpr int MAX_DEVICES = 64;

template <int DH, int BK>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, const long long* st, int causal,
              int window, float scale, cudaStream_t stream) {
  using K = Cfg<DH, BK>;
  // once per device: the consumers' 240 registers exist only if ptxas gave
  // every thread its share of the 64K (setmaxnreg redistributes them), and
  // the shared memory above 48 KB must be opted into
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, fa_wgmma_kernel<DH, BK>);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (a.numRegs * THREADS < 128 * PRODUCER_REGS + 256 * CONSUMER_REGS)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    err = cudaFuncSetAttribute(fa_wgmma_kernel<DH, BK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               K::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  // encoded on the host at every call, passed by value
  CUtensorMap tq, tk, tv;
  int rc = hopper::encode_bf16_4d_sw128(&tq, q, DH, S, H, B, st[1], st[2],
                                        st[0], 64, BQ);
  if (rc != 0) return rc;
  rc = hopper::encode_bf16_4d_sw128(&tk, k, DH, S, KV, B, st[4], st[5], st[3],
                                    64, K::BK);
  if (rc != 0) return rc;
  rc = hopper::encode_bf16_4d_sw128(&tv, v, DH, S, KV, B, st[7], st[8], st[6],
                                    64, K::BK);
  if (rc != 0) return rc;
  const dim3 grid(H, (S + BQ - 1) / BQ, B);
  fa_wgmma_kernel<DH, BK><<<grid, THREADS, K::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, H / KV, causal,
      window, scale * 1.4426950408889634f);    // log2(e) folded in
  return static_cast<int>(cudaGetLastError());
}

// the compiled (Dh, BK) instances; any other pair is refused
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int Dh, const long long* st, int causal,
           int window, float scale, int bk, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (Dh == 64 && bk == 64)
    return launch_dh<64, 64>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
  if (Dh == 64 && bk == 128)
    return launch_dh<64, 128>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
  if (Dh == 128 && bk == 64)
    return launch_dh<128, 64>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
  if (Dh == 128 && bk == 128)
    return launch_dh<128, 128>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
  if (Dh == 256 && bk == 32)
    return launch_dh<256, 32>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wg

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements: st holds
// (batch, seq, head) strides of q, then k, then v; the last axis of each
// is contiguous.  o is a contiguous (B,S,H,Dh) tensor.  window < 0 means
// no window; causal is 0 or 1.  Each returns cudaGetLastError() after the
// launch, or the error that kept it from launching.  The first two are the
// SIMT route, the third the wgmma route (bf16, Dh 64, 128 or 256, strides
// multiples of 8 elements, bases 16-byte aligned), whose `bk` is the key
// tile of a compiled (Dh, BK) instance.
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

extern "C" int repro_flash_attention_bf16_wgmma(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int KV, int Dh, const long long* st, int causal, int window,
    float scale, int bk, void* stream) {
  return wg::launch(q, k, v, o, B, S, H, KV, Dh, st, causal, window, scale,
                    bk, stream);
}
