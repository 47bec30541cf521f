// GEMM for Hopper (sm_90a): C[b] = A[b] @ B[b], fp32 accumulator, output
// in the operands' dtype (fp32 or bf16).
//
// Replaces: src/repro/kernels/matmul/matmul.py, matmul_pallas (the Pallas
// TPU kernel with K innermost accumulating into an fp32 VMEM tile).
//
// What bounds it on an H100: the runtime's operands are fp32 and its
// contract is 1e-4 against whole-graph evaluation, so the products run as
// plain fp32 FMAs (no TF32, no tensor cores).  At prefill (M = 64) the
// ceiling is the 67 TFLOP/s fp32 SIMT rate; at decode (M = 1) it is the
// 3.35 TB/s memory rate for the weight read, where every weight byte is
// used once.  The runtime's B is a column slice of a weight (row stride
// wider than N, N down to 48) and M is a shape bucket (1 ... 64), so one
// output tile per block leaves most of the 132 SMs idle.
//
// Design: three routes, which the wrapper picks from the shapes and
// strides (kernels/matmul/matmul.py, route()):
//   gemv   (M <= 8, B 16-byte readable): A's rows for the block's K chunk
//          sit in shared memory; a block's 256 threads are 128 columns of
//          16-byte column lanes (32 fp32, 16 bf16) times 8 or 16 k lanes,
//          so a warp reads 512 contiguous bytes of a row per load.  They
//          stream B once with read-only loads (L2 256-byte prefetch hint),
//          the next 8 rows of a thread in flight while the current 8 feed
//          the FMAs, and only for the M real rows (MR = M rounded up to 1,
//          2, 4 or 8).
//   tile   (A and B 16-byte readable): 128 threads own a BM x BN tile
//          (the wrapper picks BM 16, 32 or 64 by M, BN 64 or 128 by N),
//          each a TM x TN register tile (2 x 4, 4 x 4, 8 x 4 or 8 x 8) of
//          rows ty + 8i and columns 4tx + j of each 64-wide half.  A ring
//          of 16-deep K steps in shared memory (4 stages, 3 at BN 128) is
//          filled by 16-byte cp.async.cg (zero-filled past the ragged
//          edges), so the next steps' loads fly while the current step's
//          FMAs run.  A is kept m-major at a pitch of 16 + 4 words, so rows
//          r and r + 1 fall on other banks and each 16-byte read of 4 k
//          values is conflict-free; B is k-major, and a warp's 16-byte
//          reads of a B row are contiguous.
//   scalar the tile kernel with element copies (4-byte cp.async for fp32,
//          plain loads for bf16): any strides, e.g. the transposed kT of
//          batch_matmul or a column slice at an odd offset.
// Both kernels split K into chunks, so that every shape puts enough blocks
// on the card (N 48 is one tile; 64 x 2560 x 1280 is 10 tiles of 64 x 128).
// The wrapper owns every choice that shapes the grid: the route, the tile
// (TM x TN, or gemv's MR) and the number of chunks and their length, a
// function of (M, N, K) and the card's SM count alone (the wrapper's
// plan()); this file checks them and launches.  Each chunk's partial sums
// go to a workspace that the wrapper allocates, and a second kernel adds
// them in chunk order 0, 1, 2, ... spread over every SM (electing each
// output tile's last block to add them would leave one block reading all
// of a tile's chunks).  No floating-point atomics anywhere: every output is
// the same chain of FMAs and adds on every call, so the result is
// deterministic and the multi-tenant executor's bitwise invariance holds.
// Every operand is read through its own strides (batch, row, column):
// views go in without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

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

// 16 bytes (4 fp32 or 8 bf16) as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ float2 bf2(uint32_t w) {
  __nv_bfloat162 h;
  h.x = __ushort_as_bfloat16(static_cast<unsigned short>(w & 0xffffu));
  h.y = __ushort_as_bfloat16(static_cast<unsigned short>(w >> 16));
  return __bfloat1622float2(h);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = bf2(w[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// four consecutive shared-memory elements as floats (16 or 8 bytes)
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = bf2(u.x), hi = bf2(u.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

// one element global -> shared for the scalar route: a 4-byte cp.async
// for fp32, a plain load and store for bf16 (cp.async copies 4 bytes or
// more); invalid elements are zeros
__device__ __forceinline__ void copy_elem(float* dst, const float* src,
                                          bool ok) {
  cp_async4(dst, src, ok ? 4 : 0);
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}

// ------------------------------------------------------------------ tile

constexpr int TILE_THREADS = 128;
constexpr int BK = 16;

template <typename T, int TM, int TN, bool VEC>
__global__ void __launch_bounds__(TILE_THREADS)
gemm_tile_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ c, float* __restrict__ ws, int M, int N,
                 int K, long long sab, long long sam, long long sak,
                 long long sbb, long long sbk, long long sbn, int splits,
                 int kchunk) {
  constexpr int BM = 8 * TM;
  constexpr int BN = 16 * TN;
  constexpr int STAGES = TN == 4 ? 4 : 3;   // within 48 KB of shared memory
  constexpr int E = 16 / sizeof(T);   // elements per 16-byte copy
  constexpr int AP = BK + E;          // A's row pitch (elements)
  __shared__ __align__(16) T as[STAGES][BM][AP];
  __shared__ __align__(16) T bs[STAGES][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int ntn = (N + BN - 1) / BN;
  const int s = blockIdx.x / ntn;     // K chunk
  const int col0 = (blockIdx.x % ntn) * BN;
  const int row0 = blockIdx.y * BM;
  const long long z = blockIdx.z;
  a += z * sab;
  b += z * sbb;
  const int kb = s * kchunk;
  const int ke = min(K, kb + kchunk);
  const int steps = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  // scalar route: consecutive threads walk the operand's unit stride
  const bool a_kfast = sak == 1 || sam != 1;
  const bool b_nfast = sbn == 1 || sbk != 1;

  // K step at k0 -> ring slot `buf`; kchunk is a multiple of BK, so a
  // step never crosses into the next chunk, only past K
  auto load = [&](int buf, int k0) {
    if constexpr (VEC) {
      constexpr int AC = BK / E;              // copies per A row
      constexpr int A_COPIES = BM * AC;
#pragma unroll
      for (int r = 0; r < (A_COPIES + TILE_THREADS - 1) / TILE_THREADS;
           ++r) {
        const int i = tid + r * TILE_THREADS;
        if (A_COPIES % TILE_THREADS == 0 || i < A_COPIES) {
          const int row = i / AC, kc = (i % AC) * E;
          const int gm = row0 + row, gk = k0 + kc;
          const int n = gm < M ? max(0, min(E, K - gk)) : 0;
          cp_async16(&as[buf][row][kc], n ? a + gm * sam + gk : a,
                     n * static_cast<int>(sizeof(T)));
        }
      }
      constexpr int BC = BN / E;              // copies per B row
#pragma unroll
      for (int r = 0; r < BK * BC / TILE_THREADS; ++r) {
        const int i = tid + r * TILE_THREADS;
        const int kr = i / BC, nc = (i % BC) * E;
        const int gk = k0 + kr, gn = col0 + nc;
        const int n = gk < K ? max(0, min(E, N - gn)) : 0;
        cp_async16(&bs[buf][kr][nc], n ? b + gk * sbk + gn : b,
                   n * static_cast<int>(sizeof(T)));
      }
    } else {
#pragma unroll
      for (int r = 0; r < BM * BK / TILE_THREADS; ++r) {
        const int i = tid + r * TILE_THREADS;
        const int row = a_kfast ? i / BK : i % BM;
        const int kk = a_kfast ? i % BK : i / BM;
        const int gm = row0 + row, gk = k0 + kk;
        const bool ok = gm < M && gk < K;
        copy_elem(&as[buf][row][kk], ok ? a + gm * sam + gk * sak : a, ok);
      }
#pragma unroll
      for (int r = 0; r < BK * BN / TILE_THREADS; ++r) {
        const int i = tid + r * TILE_THREADS;
        const int kr = b_nfast ? i / BN : i % BK;
        const int nn = b_nfast ? i % BN : i / BK;
        const int gk = k0 + kr, gn = col0 + nn;
        const bool ok = gk < K && gn < N;
        copy_elem(&bs[buf][kr][nn], ok ? b + gk * sbk + gn * sbn : b, ok);
      }
    }
  };

  // a thread's columns: 4tx + j in each 64-wide half of the tile, so a
  // warp's 16-byte reads of a B row are contiguous
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) load(st, kb + st * BK);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();   // step t has landed (this thread's part)
    __syncthreads();               // ... every thread's; slot t-1 is free
    const int nt = t + STAGES - 1;
    if (nt < steps) load(nt % STAGES, kb + nt * BK);
    cp_async_commit();
    const int buf = t % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = lds4(&as[buf][ty + 8 * i][kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[TN];
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 b4 = lds4(&bs[buf][kk + q][64 * h + tx * 4]);
          bv[4 * h] = b4.x;
          bv[4 * h + 1] = b4.y;
          bv[4 * h + 2] = b4.z;
          bv[4 * h + 3] = b4.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float aq = q == 0 ? av[i].x : q == 1 ? av[i].y
                         : q == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(aq, bv[j], acc[i][j]);
        }
      }
    }
  }

  const long long mn = static_cast<long long>(M) * N;
  T* cz = c + z * mn;
  float* wz = ws + (static_cast<long long>(s) * gridDim.z + z) * mn;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty + 8 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + 64 * (j / 4) + tx * 4 + j % 4;
      if (gn >= N) continue;
      const long long o = static_cast<long long>(gm) * N + gn;
      if (splits == 1)
        cz[o] = from_f32<T>(acc[i][j]);
      else
        wz[o] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------ gemv

constexpr int GV_THREADS = 256;
constexpr int GV_BN = 128;         // columns per block
constexpr int GV_U = 8;            // B rows in flight per thread
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_SMEM_FLOATS = 8192;   // A's chunk: kchunk x MR <= 32 KB

// 16 bytes of B through the read-only path, not kept in L1, with a hint
// to fetch the whole 256-byte L2 sector group; a ragged last vector (n < E
// elements in range) element by element
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p, bool full, int n) {
  if (full) {
    uint4 r;
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p));
    return r;
  }
  constexpr int E = 16 / sizeof(T);
  T e[E];
#pragma unroll
  for (int i = 0; i < E; ++i) e[i] = i < n ? p[i] : from_f32<T>(0.f);
  uint4 v;
  memcpy(&v, e, 16);
  return v;
}

// acc[m][e] += A[m][k] * B[k][c + e] for one row k; `ak` holds A[0..MR][k]
template <typename T, int MR>
__device__ __forceinline__ void gemv_row(float (&acc)[MR][16 / sizeof(T)],
                                         const uint4& v,
                                         const float* __restrict__ ak) {
  constexpr int E = 16 / sizeof(T);
  float bv[E];
  unpack(v, bv);
  float am[MR];
  if constexpr (MR >= 4) {
#pragma unroll
    for (int m = 0; m < MR; m += 4) {
      const float4 q = *reinterpret_cast<const float4*>(ak + m);
      am[m] = q.x;
      am[m + 1] = q.y;
      am[m + 2] = q.z;
      am[m + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < MR; ++m) am[m] = ak[m];
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[m][e] = fmaf(am[m], bv[e], acc[m][e]);
}

template <typename T, int MR>
__global__ void __launch_bounds__(GV_THREADS)
gemv_kernel(const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ c, float* __restrict__ ws, int M, int N, int K,
            long long sab, long long sam, long long sak, long long sbb,
            long long sbk, int splits, int kchunk) {
  constexpr int E = 16 / sizeof(T);
  constexpr int LANES = GV_BN / E;    // column lanes: 32 fp32, 16 bf16
  constexpr int KL = GV_THREADS / LANES;   // k lanes: 8 fp32, 16 bf16
  // A's rows for this chunk, k-major (ak[k * MR + m]); afterwards the
  // warps' partial sums
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int cl = tid % LANES;
  const int kl = tid / LANES;
  const int col0 = blockIdx.x * GV_BN;
  const int s = blockIdx.y;
  const long long z = blockIdx.z;
  a += z * sab;
  b += z * sbb;
  const int kb = s * kchunk;
  const int kn = max(0, min(K, kb + kchunk) - kb);

  // the first batch of B's rows is requested before A is staged, so the
  // two loads overlap; afterwards two batches of GV_U rows sit in
  // registers, the next one's loads flying while the current one's FMAs run
  const int col = col0 + cl * E;
  const bool active = col < N;
  const bool full = col + E <= N;
  const int n = N - col;
  const T* bp = b + col + (kb + kl) * sbk;
  const long long step = KL * sbk;
  uint4 v[GV_U];
#pragma unroll
  for (int u = 0; u < GV_U; ++u)
    v[u] = active && kl + u * KL < kn ? load_vec(bp + u * step, full, n)
                                      : make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kn * MR; i += GV_THREADS) {
    const int m = i / kn, k = i % kn;
    smem[k * MR + m] = m < M ? to_f32(a[m * sam + (kb + k) * sak]) : 0.f;
  }
  __syncthreads();

  float acc[MR][E];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[m][e] = 0.f;
  if (active) {
    for (int k = kl; k < kn; k += GV_U * KL) {
      bp += GV_U * step;
      uint4 nv[GV_U];
#pragma unroll
      for (int u = 0; u < GV_U; ++u)
        nv[u] = k + (GV_U + u) * KL < kn ? load_vec(bp + u * step, full, n)
                                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < GV_U; ++u)
        if (k + u * KL < kn)
          gemv_row<T, MR>(acc, v[u], smem + (k + u * KL) * MR);
#pragma unroll
      for (int u = 0; u < GV_U; ++u) v[u] = nv[u];
    }
  }

  // the k lanes of a warp, then the warps in order
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[m][e] += __shfl_xor_sync(0xffffffffu, acc[m][e], off);
  __syncthreads();                    // A is no longer read
  const int warp = tid / 32;
  if ((tid & 31) < LANES) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int e = 0; e < E; ++e)
        smem[(warp * MR + m) * GV_BN + cl * E + e] = acc[m][e];
  }
  __syncthreads();
  const long long mn = static_cast<long long>(M) * N;
  T* cz = c + z * mn;
  float* wz = ws + (static_cast<long long>(s) * gridDim.z + z) * mn;
  for (int i = tid; i < MR * GV_BN; i += GV_THREADS) {
    const int m = i / GV_BN, j = i % GV_BN, gn = col0 + j;
    if (m >= M || gn >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < GV_WARPS; ++w)
      sum += smem[(w * MR + m) * GV_BN + j];
    const long long o = static_cast<long long>(m) * N + gn;
    if (splits == 1)
      cz[o] = from_f32<T>(sum);
    else
      wz[o] = sum;
  }
}

// ---------------------------------------------------------- chunk sums

// c[i] = ws[0][i] + ws[1][i] + ... in chunk order, i over batch x M x N
template <typename T>
__global__ void __launch_bounds__(256)
gemm_sum_kernel(const float* __restrict__ ws, T* __restrict__ c,
                long long total, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  if (total % 4 == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    for (long long i = first; i < total / 4; i += stride) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p = 0; p < splits; ++p) {
        const float4 v = w4[p * (total / 4) + i];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      c[4 * i] = from_f32<T>(acc.x);
      c[4 * i + 1] = from_f32<T>(acc.y);
      c[4 * i + 2] = from_f32<T>(acc.z);
      c[4 * i + 3] = from_f32<T>(acc.w);
    }
  } else {
    for (long long i = first; i < total; i += stride) {
      float acc = 0.f;
      for (int p = 0; p < splits; ++p) acc += ws[p * total + i];
      c[i] = from_f32<T>(acc);
    }
  }
}

// ---------------------------------------------------------------- launch

enum Route { GEMV = 0, TILE = 1, SCALAR = 2 };

template <typename T, int TM, int TN, bool VEC>
void launch_tile(const T* a, const T* b, T* c, float* ws, int batch, int M,
                 int N, int K, long long sab, long long sam, long long sak,
                 long long sbb, long long sbk, long long sbn, int splits,
                 int kchunk, cudaStream_t st) {
  const dim3 grid(((N + 16 * TN - 1) / (16 * TN)) * splits,
                  (M + 8 * TM - 1) / (8 * TM), batch);
  gemm_tile_kernel<T, TM, TN, VEC><<<grid, TILE_THREADS, 0, st>>>(
      a, b, c, ws, M, N, K, sab, sam, sak, sbb, sbk, sbn, splits, kchunk);
}

// the block tile the wrapper picked (kernels/matmul/matmul.py, tile()):
// 16 rows (2 a thread), 32 (4) or 64 (8), 64 columns (4 a thread) or 128
// (8); no other tile is compiled
template <typename T, bool VEC>
bool launch_tile_as(int tm, int tn, const T* a, const T* b, T* c, float* ws,
                    int batch, int M, int N, int K, long long sab,
                    long long sam, long long sak, long long sbb,
                    long long sbk, long long sbn, int splits, int kchunk,
                    cudaStream_t st) {
  if (tm == 2 && tn == 4)
    launch_tile<T, 2, 4, VEC>(a, b, c, ws, batch, M, N, K, sab, sam, sak,
                              sbb, sbk, sbn, splits, kchunk, st);
  else if (tm == 4 && tn == 4)
    launch_tile<T, 4, 4, VEC>(a, b, c, ws, batch, M, N, K, sab, sam, sak,
                              sbb, sbk, sbn, splits, kchunk, st);
  else if (tm == 8 && tn == 4)
    launch_tile<T, 8, 4, VEC>(a, b, c, ws, batch, M, N, K, sab, sam, sak,
                              sbb, sbk, sbn, splits, kchunk, st);
  else if (tm == 8 && tn == 8)
    launch_tile<T, 8, 8, VEC>(a, b, c, ws, batch, M, N, K, sab, sam, sak,
                              sbb, sbk, sbn, splits, kchunk, st);
  else
    return false;
  return true;
}

template <typename T, int MR>
void launch_gemv(const T* a, const T* b, T* c, float* ws, int batch, int M,
                 int N, int K, long long sab, long long sam, long long sak,
                 long long sbb, long long sbk, int splits, int kchunk,
                 cudaStream_t st) {
  const size_t smem = sizeof(float) *
      static_cast<size_t>(std::max(kchunk * MR, GV_WARPS * MR * GV_BN));
  const dim3 grid((N + GV_BN - 1) / GV_BN, splits, batch);
  gemv_kernel<T, MR><<<grid, GV_THREADS, smem, st>>>(
      a, b, c, ws, M, N, K, sab, sam, sak, sbb, sbk, splits, kchunk);
}

template <typename T>
int launch(const void* a_, const void* b_, void* c_, void* ws_, int batch,
           int M, int N, int K, long long sab, long long sam, long long sak,
           long long sbb, long long sbk, long long sbn, int route, int tm,
           int tn, int splits, int kchunk, int sms, void* stream) {
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  T* c = static_cast<T*>(c_);
  float* ws = static_cast<float*>(ws_);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || kchunk < BK || kchunk % BK != 0 || sms < 1 ||
      (splits > 1 && ws == nullptr))
    return invalid;
  if (route == GEMV) {
    // MR (tm) rows held, M <= MR; A's chunk (kchunk x MR floats) lives in
    // 32 KB of shared memory
    if (M > tm || sbn != 1 || kchunk * tm > GV_SMEM_FLOATS) return invalid;
    if (tm == 1)
      launch_gemv<T, 1>(a, b, c, ws, batch, M, N, K, sab, sam, sak, sbb, sbk,
                        splits, kchunk, st);
    else if (tm == 2)
      launch_gemv<T, 2>(a, b, c, ws, batch, M, N, K, sab, sam, sak, sbb, sbk,
                        splits, kchunk, st);
    else if (tm == 4)
      launch_gemv<T, 4>(a, b, c, ws, batch, M, N, K, sab, sam, sak, sbb, sbk,
                        splits, kchunk, st);
    else if (tm == 8)
      launch_gemv<T, 8>(a, b, c, ws, batch, M, N, K, sab, sam, sak, sbb, sbk,
                        splits, kchunk, st);
    else
      return invalid;
  } else if (route == TILE) {
    if (sak != 1 || sbn != 1 ||
        !launch_tile_as<T, true>(tm, tn, a, b, c, ws, batch, M, N, K, sab,
                                 sam, sak, sbb, sbk, sbn, splits, kchunk, st))
      return invalid;
  } else if (route == SCALAR) {
    if (!launch_tile_as<T, false>(tm, tn, a, b, c, ws, batch, M, N, K, sab,
                                  sam, sak, sbb, sbk, sbn, splits, kchunk,
                                  st))
      return invalid;
  } else {
    return invalid;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * M * N;
  const long long work = total % 4 == 0 ? total / 4 : total;
  const int blocks = static_cast<int>(
      std::min<long long>((work + 255) / 256, 8LL * sms));
  gemm_sum_kernel<T><<<blocks, 256, 0, st>>>(ws, c, total, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements; C is
// contiguous (batch, M, N).  `route` is 0 gemv, 1 tile, 2 scalar; `tm`,
// `tn` the thread's register tile (tile, scalar: 2x4, 4x4, 8x4 or 8x8) or
// gemv's rows held (tm 1, 2, 4 or 8); with splits > 1, `ws` holds splits x
// batch x M x N floats of partial sums; `sms` the card's SM count, which
// sizes the chunk-sum grid.  Each returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a choice it does not compile.
extern "C" int repro_matmul_f32(const void* a, const void* b, void* c,
                                void* ws, int batch, int M, int N, int K,
                                long long sab, long long sam, long long sak,
                                long long sbb, long long sbk, long long sbn,
                                int route, int tm, int tn, int splits,
                                int kchunk, int sms, void* stream) {
  return launch<float>(a, b, c, ws, batch, M, N, K, sab, sam, sak, sbb, sbk,
                       sbn, route, tm, tn, splits, kchunk, sms, stream);
}

extern "C" int repro_matmul_bf16(const void* a, const void* b, void* c,
                                 void* ws, int batch, int M, int N, int K,
                                 long long sab, long long sam, long long sak,
                                 long long sbb, long long sbk, long long sbn,
                                 int route, int tm, int tn, int splits,
                                 int kchunk, int sms, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, ws, batch, M, N, K, sab, sam, sak,
                               sbb, sbk, sbn, route, tm, tn, splits, kchunk,
                               sms, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return hopper::error_string(code);
}
