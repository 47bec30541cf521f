// Backward of the WKV6 (RWKV6 / Finch) recurrence for Hopper (sm_90a), from
// a zero state, fp32 arithmetic.  With S_{t-1} the state before step t and
// G_t = dL/dS_t (G_{T-1} the final state's gradient dS):
//   G_{t-1}[i][j] = w_t[i] G_t[i][j] + r_t[i] dy_t[j]
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i][j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j]     + u[i] r_t[i] (v_t . dy_t)
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   dv_t[j] = sum_i k_t[i] G_t[i][j] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   du[i]   = sum_b sum_t r_t[i] k_t[i] (v_t . dy_t)
// r, k, v, w, dy (B,T,H,D) contiguous in fp32 or bf16, u (H,D) and dS
// (B,H,D,D) contiguous fp32 -> dr, dk, dv, dw in the inputs' dtype, du fp32.
//
// Replaces: none.  The JAX package has no backward kernel of
// src/repro/kernels/rwkv_scan/rwkv_scan.py, wkv6_pallas (no custom_vjp): it
// trains through the jnp reference.  This is the backward of the port's
// forward kernel, csrc/wkv6.cu.
//
// What bounds it on an H100: instruction issue and the chains, as in the
// forward.  G runs backward in time and S forward, and dw needs both at the
// same step; S_{t-1} is never rebuilt from S_t by dividing by w_t (a strong
// decay leaves fp32 range, the fault of the TPU's chunked form).  Per
// (b, t, h) the sums run over both axes of the D x D state: over columns
// for dr, dk, dw (and v . dy), over rows for dv.
//
// Design: two launches on one stream, nothing atomic, every sum in a fixed
// order, so two calls give the same bits.
//  1. walk: a block holds ROWS (16) rows of one head's state, all D
//     columns, so D / ROWS blocks a head (160 at B1 H40 D64: every SM
//     busy); a thread keeps 4 columns of one row, a row's D/4 lanes in one
//     warp.  Rows of S and G are independent, so the blocks need nothing
//     of each other.  Time walks in chunks of L (8) steps.
//     Forward: each warp on its own keeps FDEPTH chunks of k, w (the
//     block's rows) and v in flight into a ring of its own (cp.async; no
//     block barrier), and its threads step S through them, writing S
//     before every chunk (fp32 checkpoints, (B, H, T / L, D, D); the last
//     kept in registers).
//     Backward, the chunks last to first: a ring of RING raw chunks of r,
//     k, w, v, dy is filled by cp.async RING - 1 chunks ahead; two chunks
//     ahead, some threads convert r, k, w to fp32 (w = 1 past T) and
//     compute the chunk's per-step scalars once: v . dy and the block's
//     part of the bonus r . (u * k).  A chunk's L states are recomputed
//     from its checkpoint in registers (fmaf(w, S, k * v), the forward's
//     own bits), then G steps back through them, v and dy read from the
//     raw chunk.  A step keeps its three partial row sums (dy . S, G . v,
//     G . S) in registers and writes its partial column sums k * G to
//     shared memory; only G's FMA and the recomputed S are chains from
//     step to step.  After the chunk the 3 L row sums of a row are reduced
//     over its lanes together by recursive halving (each shuffle stage
//     sends half of what a lane holds), the u terms added, and dr, dk, dw
//     leave as 16-byte rows; the column sums are summed over the block's
//     rows in row order into an fp32 partial dv of the block (QB, B, T, H,
//     D), beside the bonus partial (QB, B, T, H).  One block barrier a
//     chunk: the buffers come in threes (staged) and twos (column sums,
//     rows), so one chunk's sums and stores overlap the next chunk's steps
//     in other warps.  Each row keeps its du partial over time.
//  2. sums: dv = the QB partials in block order + the bonus (its partials
//     in block order) * dy; du = the B partials of each (h, i) in batch
//     order.
// Any T (steps past T arrive as zeros with w = 1, leave S and G as they
// are, and are not stored); D is 16, 32, 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int W = 4;               // state columns of one row a thread keeps
constexpr int L = 8;               // steps a chunk: staged, checkpointed
constexpr int ROWS = 16;           // state rows a block
constexpr int RING = 4;            // raw chunks in flight or landed
constexpr int STAGED = 3;          // fp32 chunks: stepped, next, converting
constexpr int SUM_THREADS = 256;   // the sums launch

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

// 4 consecutive elements (16 bytes in fp32, 8 in bf16) as floats, and back
__device__ __forceinline__ void ld4(const float* p, float (&f)[W]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&f)[W]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);         // bf16 is an fp32's top half
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void st4(float* p, const float (&f)[W]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&f)[W]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// 8 consecutive shared-memory elements as floats
__device__ __forceinline__ void ld8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The values a lane holds after row_reduce over ``lanes`` lanes of ``n``
// values each, and the lane bits whose partners end with the same sums
// (the stages where what was left could not be halved).
constexpr int reduced_count(int lanes, int n) {
  for (int o = lanes / 2; o >= 1; o /= 2)
    if (n % 2 == 0) n /= 2;
  return n;
}
constexpr int shared_bits(int lanes, int n) {
  int m = 0;
  for (int o = lanes / 2; o >= 1; o /= 2) {
    if (n % 2 == 0)
      n /= 2;
    else
      m |= o;
  }
  return m;
}

template <typename T, int D>
struct Cfg {
  static constexpr int LANES = D / W;              // a row's threads
  static constexpr int THREADS = ROWS * LANES;     // 4 D
  static constexpr int QB = D / ROWS;              // row blocks a head
  static constexpr int SEGS = D / 8;               // 8-wide segments a v row
  static constexpr int NV = L * SEGS;              // v/dy staging jobs
  static constexpr int NR = L * ROWS / 8;          // r/k/w staging jobs
  static constexpr int NP = 3 * L;                 // a lane's row partials
  static constexpr int KEPT = reduced_count(LANES, NP);
  static constexpr int SHARED = shared_bits(LANES, NP);
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);  // <= 128 regs
  // shared memory: a ring of raw chunks (input dtype; the steps read v and
  // dy there), three staged chunks (fp32: r, k, w of a (step, row) as one
  // float4; v . dy and the bonus part a step), two chunks' column partials
  // and dr, dk, dw rows, u of the block's rows
  static constexpr int RAW_RKW = 3 * L * ROWS;     // elements
  static constexpr size_t RAW = (RAW_RKW + 2 * L * D) * sizeof(T);
  static constexpr int SVDY = 4 * L * ROWS;        // floats: after rkw
  static constexpr int SBONUS = SVDY + L;
  static constexpr size_t STAGE = (SBONUS + L) * sizeof(float);
  static constexpr size_t DVP = static_cast<size_t>(L) * ROWS * D * 4;
  static constexpr size_t OUTS = 3 * L * ROWS * sizeof(T);
  static constexpr size_t SMEM =
      RING * RAW + STAGED * STAGE + 2 * (DVP + OUTS) + ROWS * 4;
  // the forward walk's rings, one a warp, in the room of the backward
  // walk's buffers (not in use yet): a chunk's v (all columns) and k, w
  // (the block's rows) in the input dtype, FDEPTH chunks a warp
  static constexpr int WARPS = THREADS / 32;
  static constexpr int FSLOT = L * (D + 2 * ROWS);          // elements
  static constexpr int FIT =
      (RING * RAW + STAGED * STAGE + 2 * (DVP + OUTS)) /
      (WARPS * FSLOT * sizeof(T));
  static constexpr int FDEPTH = FIT < 8 ? FIT : 8;
  static_assert(FDEPTH >= 2, "the forward walk's ring");
  static_assert(LANES >= 4 && LANES <= 32 && 32 % LANES == 0,
                "a row's lanes share one warp");
  static_assert(NV + NR <= THREADS && NV % 2 == 0 && SEGS <= 32,
                "one staging job a thread; a step's r/k/w pair in a warp");
  static_assert(RAW % 16 == 0 && STAGE % 16 == 0 && OUTS % 16 == 0,
                "16-byte aligned regions");
};

// Sums p[0, N) of each lane over the lanes that differ in bits O, O/2, ..,
// 1 (one row's lanes), ``q`` the lane within the row: while N is even, a
// stage keeps one half (the upper where q has bit O) and adds the other
// half that the partner sends, ``base`` counting where the kept half
// started; where N is odd, every value is summed with the partner's.
template <int O, int N, int P>
__device__ __forceinline__ void row_reduce(float (&p)[P], int q, int& base) {
  if constexpr (O >= 1) {
    if constexpr (N % 2 == 0) {
      const bool up = (q & O) != 0;
#pragma unroll
      for (int m = 0; m < N / 2; ++m) {
        const float lo = p[m], hi = p[m + N / 2];
        p[m] = (up ? hi : lo) +
               __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
      }
      if (up) base += N / 2;
      row_reduce<O / 2, N / 2>(p, q, base);
    } else {
#pragma unroll
      for (int m = 0; m < N; ++m)
        p[m] += __shfl_xor_sync(0xffffffffu, p[m], O);
      row_reduce<O / 2, N>(p, q, base);
    }
  }
}

template <typename T>
struct Inputs {
  const T *r, *k, *v, *w, *dy;
};

// Hands the chunk from step t0 to cp.async, into ``raw``
// ([r, k, w][step][row] for the block's rows from i0, then [v, dy][step]
// [column]): job tid < NV copies a step's 8-wide segment of v and dy, job
// tid - NV < NR 8 rows of a step of r, k and w.  Steps past T are
// zero-filled.
template <typename T, int D>
__device__ __forceinline__ void issue_chunk(T* raw, const Inputs<T>& in,
                                            long long b, int h, int i0,
                                            int t0, int T_len, int H,
                                            int tid) {
  using C = Cfg<T, D>;
  constexpr int PER = 16 / sizeof(T);              // elements a copy
  if (tid < C::NV) {
    const int s = tid / C::SEGS, g = tid % C::SEGS;
    const bool ok = t0 + s < T_len;
    const long long at = ok ? ((b * T_len + t0 + s) * H + h) * D + 8 * g : 0;
    T* dst = raw + C::RAW_RKW + s * D + 8 * g;
#pragma unroll
    for (int n = 0; n < 8; n += PER) {
      hopper::cp_async16(dst + n, in.v + at + n, ok ? 16 : 0);
      hopper::cp_async16(dst + L * D + n, in.dy + at + n, ok ? 16 : 0);
    }
  }
  if (tid >= C::NV && tid < C::NV + C::NR) {
    const int s = (tid - C::NV) / 2, half = (tid - C::NV) % 2;
    const bool ok = t0 + s < T_len;
    const long long at =
        ok ? ((b * T_len + t0 + s) * H + h) * D + i0 + 8 * half : 0;
    T* dst = raw + s * ROWS + 8 * half;
#pragma unroll
    for (int n = 0; n < 8; n += PER) {
      hopper::cp_async16(dst + n, in.r + at + n, ok ? 16 : 0);
      hopper::cp_async16(dst + L * ROWS + n, in.k + at + n, ok ? 16 : 0);
      hopper::cp_async16(dst + 2 * L * ROWS + n, in.w + at + n, ok ? 16 : 0);
    }
  }
}

// ``raw`` (landed) -> ``st``, by the jobs of issue_chunk: r, k, w in fp32
// (v and dy stay in ``raw``); every thread runs both passes (the shuffles
// take whole warps).  A step's v . dy is summed over its SEGS lanes, the
// bonus part r . (u * k) of the block's 16 rows over two lanes, each by a
// fixed butterfly.
template <typename T, int D>
__device__ __forceinline__ void convert_chunk(const T* raw, float* st,
                                              const float* us, int t0,
                                              int T_len, int tid) {
  using C = Cfg<T, D>;
  {
    const bool job = tid < C::NV;
    const int s = tid / C::SEGS, g = tid % C::SEGS;
    float part = 0.f;
    if (job) {
      float vv[8], dd[8];
      ld8(raw + C::RAW_RKW + s * D + 8 * g, vv);
      ld8(raw + C::RAW_RKW + L * D + s * D + 8 * g, dd);
#pragma unroll
      for (int e = 0; e < 8; ++e) part = fmaf(vv[e], dd[e], part);
    }
#pragma unroll
    for (int o = C::SEGS / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (job && g == 0) st[C::SVDY + s] = part;
  }
  {
    const bool job = tid >= C::NV && tid < C::NV + C::NR;
    const int s = (tid - C::NV) / 2, half = (tid - C::NV) % 2;
    float part = 0.f;
    if (job) {
      float rf[8], kf[8], wf[8];
      ld8(raw + s * ROWS + 8 * half, rf);
      ld8(raw + L * ROWS + s * ROWS + 8 * half, kf);
      ld8(raw + 2 * L * ROWS + s * ROWS + 8 * half, wf);
      if (t0 + s >= T_len) {
#pragma unroll
        for (int e = 0; e < 8; ++e) wf[e] = 1.f;
      }
      float4* rkw = reinterpret_cast<float4*>(st) + s * ROWS + 8 * half;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        rkw[e] = make_float4(rf[e], kf[e], wf[e], 0.f);
        part = fmaf(rf[e], us[8 * half + e] * kf[e], part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (job && half == 0) st[C::SBONUS + s] = part;
  }
}

// Hands the forward walk's chunk from step t0 to cp.async, into a warp's
// ring slot ``slot`` ([step][column] of v, then [k, w][step][row] of the
// block's rows from i0), by the warp's 32 lanes; steps past T zero-filled.
template <typename T, int D>
__device__ __forceinline__ void issue_fwd(T* slot, const Inputs<T>& in,
                                          long long base, long long ts,
                                          int i0, int t0, int T_len,
                                          int lane) {
  constexpr int E = 16 / sizeof(T);                // elements a copy
  constexpr int VP = D / E, KP = ROWS / E;         // copies a step
  for (int n = lane; n < L * (VP + 2 * KP); n += 32) {
    const T* src;
    T* dst;
    int s;
    if (n < L * VP) {
      s = n / VP;
      const int o = (n % VP) * E;
      src = in.v + o;
      dst = slot + s * D + o;
    } else {
      const int m = n - L * VP, a = m / (L * KP);
      s = (m % (L * KP)) / KP;
      const int o = (m % KP) * E;
      src = (a == 0 ? in.k : in.w) + i0 + o;
      dst = slot + L * D + a * L * ROWS + s * ROWS + o;
    }
    const bool ok = t0 + s < T_len;
    hopper::cp_async16(dst, src + (ok ? base + (t0 + s) * ts : 0),
                       ok ? 16 : 0);
  }
}

// 1. A block: rows [i0, i0 + ROWS) of head (b, h), all D columns; the
// forward walk writes the checkpoints, the backward walk dr, dk, dw, the
// block's partial dv and bonus, and the rows' du partials.
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::THREADS, Cfg<T, D>::MIN_BLOCKS)
wkv6_bwd_walk_kernel(Inputs<T> in, const float* __restrict__ u,
                     const float* __restrict__ ds, float* __restrict__ ck,
                     T* __restrict__ dr, T* __restrict__ dk,
                     T* __restrict__ dw, float* __restrict__ dv_part,
                     float* __restrict__ bonus_part,
                     float* __restrict__ du_part, int T_len, int H) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  // visit i's raw slot and staged buffer, by arithmetic on the shared base
  // (an array of pointers, indexed at run time, lands in local memory and
  // turns every shared load into a generic one)
  T* const raw0 = reinterpret_cast<T*>(smem);
  float* const stage0 = reinterpret_cast<float*>(smem + RING * C::RAW);
  auto raw_of = [&](int i) {
    return raw0 + (i % RING) * (C::RAW / sizeof(T));
  };
  auto stage_of = [&](int i) {
    return stage0 + (i % STAGED) * (C::STAGE / sizeof(float));
  };
  unsigned char* const tail = smem + RING * C::RAW + STAGED * C::STAGE;
  auto dvp_of = [&](int i) {
    return reinterpret_cast<float*>(tail + (i & 1) * C::DVP);
  };
  auto outs_of = [&](int i) {
    return reinterpret_cast<T*>(tail + 2 * C::DVP + (i & 1) * C::OUTS);
  };
  float* us = reinterpret_cast<float*>(tail + 2 * (C::DVP + C::OUTS));

  const int qb = blockIdx.x;                 // row block of the head
  const int i0 = qb * ROWS;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long B = gridDim.z;
  const long long bh = b * H + h;
  const int tid = threadIdx.x;
  const int row = tid / C::LANES;            // within the block
  const int q = tid % C::LANES;              // lane within the row
  const int j0 = q * W;                      // first column
  const int chunks = (T_len + L - 1) / L;
  // the state of (row, j0..) before chunk c: ckp + c * D * D
  float* ckp = ck + ((bh * chunks) * D + i0 + row) * D + j0;

  if (tid < ROWS) us[tid] = u[h * D + i0 + tid];
  float G[W];
  ld4(ds + (bh * D + i0 + row) * D + j0, G);

  // The forward walk: a thread steps its row's 4 columns through time,
  // each warp on its own: its lanes keep FDEPTH - 1 chunks of v, k, w in
  // flight into the warp's ring (cp.async, one group a chunk) and step the
  // one that landed; S before every chunk but the last goes to the
  // checkpoints, the last is kept.
  float S[W] = {0.f, 0.f, 0.f, 0.f};
  float ckv[W];                              // the next backward checkpoint
  {
    const long long ts = static_cast<long long>(H) * D;   // a step
    const long long base = (b * T_len * H + h) * D;
    const int lane = tid % 32;
    T* const ring = reinterpret_cast<T*>(smem) +
                    (tid / 32) * C::FDEPTH * C::FSLOT;
    auto fslot = [&](int c) { return ring + (c % C::FDEPTH) * C::FSLOT; };
#pragma unroll
    for (int c = 0; c + 1 < C::FDEPTH; ++c) {
      if (c < chunks)
        issue_fwd<T, D>(fslot(c), in, base, ts, i0, c * L, T_len, lane);
      hopper::cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
      __syncwarp();                  // every lane is done with chunk c - 1
      if (c + C::FDEPTH - 1 < chunks)
        issue_fwd<T, D>(fslot(c + C::FDEPTH - 1), in, base, ts, i0,
                        (c + C::FDEPTH - 1) * L, T_len, lane);
      hopper::cp_async_commit();
      hopper::cp_async_wait<C::FDEPTH - 1>();
      __syncwarp();                  // chunk c landed, every lane's copies
      if (c + 1 < chunks) {
        st4(ckp + static_cast<long long>(c) * D * D, S);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) ckv[e] = S[e];
      }
      const T* sl = fslot(c);
#pragma unroll
      for (int s = 0; s < L; ++s) {
        const bool ok = c * L + s < T_len;
        const float ki = to_f32(sl[L * D + s * ROWS + row]);
        const float wi = ok ? to_f32(sl[L * D + L * ROWS + s * ROWS + row])
                            : 1.f;
        float vv[W];
        ld4(sl + s * D + j0, vv);
#pragma unroll
        for (int e = 0; e < W; ++e) S[e] = fmaf(wi, S[e], ki * vv[e]);
      }
    }
  }

  // The backward walk visits the chunks last to first; RING - 1 visits'
  // chunks are in flight ahead of the one being stepped (one cp.async
  // group a visit, empty past the last).
  __syncthreads();                   // every warp is done with its ring
  auto chunk_of = [&](int vi) { return chunks - 1 - vi; };
#pragma unroll
  for (int vi = 0; vi + 1 < RING; ++vi) {
    if (vi < chunks)
      issue_chunk<T, D>(raw_of(vi), in, b, h, i0, chunk_of(vi) * L, T_len,
                        H, tid);
    hopper::cp_async_commit();
  }
  hopper::cp_async_wait<RING - 3>();
  __syncthreads();
  convert_chunk<T, D>(raw_of(0), stage_of(0), us, chunk_of(0) * L, T_len,
                      tid);
  if (chunks > 1)
    convert_chunk<T, D>(raw_of(1), stage_of(1), us, chunk_of(1) * L, T_len,
                        tid);
  __syncthreads();

  float du = 0.f;
  for (int vi = 0; vi < chunks; ++vi) {
    const int c = chunk_of(vi);
    const int t0 = c * L;
    const float* st = stage_of(vi);
    const float4* rkw = reinterpret_cast<const float4*>(st);
    const T* V = raw_of(vi) + C::RAW_RKW;
    const T* DY = V + L * D;
    const float* vdy = st + C::SVDY;
    float* const dvp = dvp_of(vi);
    T* const outs = outs_of(vi);
    if (vi + RING - 1 < chunks)      // into the slot visit vi - 1 freed
      issue_chunk<T, D>(raw_of(vi + RING - 1), in, b, h, i0,
                        chunk_of(vi + RING - 1) * L, T_len, H, tid);
    hopper::cp_async_commit();
    {
      // Ss[s]: the state before step t0 + s, recomputed from the checkpoint
      float Ss[L][W];
#pragma unroll
      for (int e = 0; e < W; ++e) Ss[0][e] = ckv[e];
      if (c > 0) ld4(ckp + static_cast<long long>(c - 1) * D * D, ckv);
#pragma unroll
      for (int s = 0; s + 1 < L; ++s) {
        const float4 x = rkw[s * ROWS + row];
        float vv[W];
        ld4(V + s * D + j0, vv);
#pragma unroll
        for (int e = 0; e < W; ++e)
          Ss[s + 1][e] = fmaf(x.z, Ss[s][e], x.y * vv[e]);
      }
      // p[s], p[L + s], p[2 L + s]: the lane's parts of dy . S, G . v,
      // G . S at step t0 + s
      float p[C::NP];
#pragma unroll
      for (int s = L - 1; s >= 0; --s) {
        const float4 x = rkw[s * ROWS + row];
        float vv[W], dd[W], kg[W];
        ld4(V + s * D + j0, vv);
        ld4(DY + s * D + j0, dd);
        float a = 0.f, g = 0.f, xs = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) {
          a = fmaf(dd[e], Ss[s][e], a);
          g = fmaf(G[e], vv[e], g);
          xs = fmaf(G[e], Ss[s][e], xs);
          kg[e] = x.y * G[e];
        }
        p[s] = a;
        p[L + s] = g;
        p[2 * L + s] = xs;
        st4(dvp + (s * ROWS + row) * D + j0, kg);
#pragma unroll
        for (int e = 0; e < W; ++e) G[e] = fmaf(x.z, G[e], x.x * dd[e]);
      }
      int base = 0;
      row_reduce<C::LANES / 2, C::NP>(p, q, base);
      if ((q & C::SHARED) == 0) {
        const float ui = us[row];
#pragma unroll
        for (int m = 0; m < C::KEPT; ++m) {
          const int n = base + m, which = n / L, s = n % L;
          const float4 x = rkw[s * ROWS + row];
          float val = p[m];
          if (which == 0) {
            val = fmaf(ui * x.y, vdy[s], val);           // dr
            du = fmaf(x.x * x.y, vdy[s], du);
          } else if (which == 1) {
            val = fmaf(ui * x.x, vdy[s], val);           // dk
          }
          outs[(which * L + s) * ROWS + row] = from_f32<T>(val);
        }
      }
    }
    // One barrier a visit: past it, the chunk two visits on has landed
    // (its cp.async group), this visit's outs and column partials are
    // written, and every thread is done with the staged buffer that chunk
    // takes.  What follows overlaps the next visit's steps in other warps
    // (the buffers it reads and writes come in threes and twos).
    hopper::cp_async_wait<RING - 3>();
    __syncthreads();
    if (vi + 2 < chunks)
      convert_chunk<T, D>(raw_of(vi + 2), stage_of(vi + 2), us,
                          chunk_of(vi + 2) * L, T_len, tid);
    {
      // the block's column sums, rows in order, and its bonus parts (by
      // the upper threads, while the lower ones convert a chunk)
      for (int j = tid - (C::THREADS - L * D / 4); j >= 0 && j < L * D / 4;
           j += C::THREADS) {
        const int s = j / (D / 4), c4 = (j % (D / 4)) * 4;
        const float* col = dvp + s * ROWS * D + c4;
        float4 acc = *reinterpret_cast<const float4*>(col);
#pragma unroll
        for (int rr = 1; rr < ROWS; ++rr) {
          const float4 y = *reinterpret_cast<const float4*>(col + rr * D);
          acc.x += y.x;
          acc.y += y.y;
          acc.z += y.z;
          acc.w += y.w;
        }
        if (t0 + s < T_len)
          *reinterpret_cast<float4*>(
              dv_part + (((qb * B + b) * T_len + t0 + s) * H + h) * D + c4) =
              acc;
      }
      if (tid < L && t0 + tid < T_len)
        bonus_part[((qb * B + b) * T_len + t0 + tid) * H + h] =
            st[C::SBONUS + tid];
      // dr, dk, dw: 16-byte pieces of the block's rows
      constexpr int E = 16 / sizeof(T), RV = ROWS / E;
      for (int j = (tid + C::THREADS - C::NV - C::NR) % C::THREADS;
           j < 3 * L * RV; j += C::THREADS) {
        const int which = j / (L * RV), s = (j / RV) % L, e = (j % RV) * E;
        if (t0 + s < T_len) {
          T* dst = which == 0 ? dr : which == 1 ? dk : dw;
          *reinterpret_cast<uint4*>(
              dst + ((b * T_len + t0 + s) * H + h) * D + i0 + e) =
              *reinterpret_cast<const uint4*>(outs + (which * L + s) * ROWS +
                                              e);
        }
      }
    }
  }
#pragma unroll
  for (int o = C::LANES / 2; o > 0; o >>= 1)
    du += __shfl_xor_sync(0xffffffffu, du, o);
  if (q == 0) du_part[bh * D + i0 + row] = du;
}

// 2. dv = the QB block partials in block order + bonus * dy, 4 columns of
// one (b, t, h) row a thread, in the first dv_blocks blocks; du[h, i] =
// the B partials in batch order in the rest.
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
wkv6_bwd_sums_kernel(const float* __restrict__ dv_part,
                     const float* __restrict__ bonus_part,
                     const T* __restrict__ dy, T* __restrict__ dv,
                     const float* __restrict__ du_part,
                     float* __restrict__ du, long long rows, int D, int QB,
                     int B, int HD, int dv_blocks) {
  if (static_cast<int>(blockIdx.x) < dv_blocks) {
    const long long n =
        static_cast<long long>(blockIdx.x) * SUM_THREADS + threadIdx.x;
    const int quads = D / 4;
    if (n >= rows * quads) return;
    const long long rw = n / quads;
    const int c4 = static_cast<int>(n % quads) * 4;
    float acc[W];
    ld4(dv_part + rw * D + c4, acc);
    float bonus = bonus_part[rw];
    for (int qq = 1; qq < QB; ++qq) {
      float y[W];
      ld4(dv_part + (qq * rows + rw) * D + c4, y);
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] += y[e];
      bonus += bonus_part[qq * rows + rw];
    }
    float dd[W];
    ld4(dy + rw * D + c4, dd);
#pragma unroll
    for (int e = 0; e < W; ++e) acc[e] = fmaf(bonus, dd[e], acc[e]);
    st4(dv + rw * D + c4, acc);
    return;
  }
  const int n = (static_cast<int>(blockIdx.x) - dv_blocks) * SUM_THREADS +
                static_cast<int>(threadIdx.x);
  if (n >= HD) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[static_cast<long long>(b) * HD + n];
  du[n] = s;
}

struct Args {
  const void *r, *k, *v, *w, *dy, *u, *ds;
  void *ck, *dr, *dk, *dv, *dw, *dv_part, *bonus_part, *du_part, *du;
  int B, T_len, H;
};

// The walk of the (D) instance on the wrapper's grid: ``blocks`` blocks a
// head of ``threads`` threads (refused where they are not this instance's).
template <typename T, int D>
int walk_d(const Args& a, int blocks, int threads, cudaStream_t s) {
  using C = Cfg<T, D>;
  if (threads != C::THREADS || blocks != C::QB)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_walk_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Inputs<T> in{static_cast<const T*>(a.r), static_cast<const T*>(a.k),
                     static_cast<const T*>(a.v), static_cast<const T*>(a.w),
                     static_cast<const T*>(a.dy)};
  const dim3 grid(blocks, a.H, a.B);
  wkv6_bwd_walk_kernel<T, D><<<grid, threads, C::SMEM, s>>>(
      in, static_cast<const float*>(a.u), static_cast<const float*>(a.ds),
      static_cast<float*>(a.ck), static_cast<T*>(a.dr),
      static_cast<T*>(a.dk), static_cast<T*>(a.dw),
      static_cast<float*>(a.dv_part), static_cast<float*>(a.bonus_part),
      static_cast<float*>(a.du_part), a.T_len, a.H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int stage(int st, const Args& a, int D, int blocks, int threads,
          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (st == 1) {                     // sums: dv rows, then du
    const long long rows = static_cast<long long>(a.B) * a.T_len * a.H;
    const long long dv_blocks =
        (rows * (D / 4) + SUM_THREADS - 1) / SUM_THREADS;
    const int HD = a.H * D;
    const long long grid = dv_blocks + (HD + SUM_THREADS - 1) / SUM_THREADS;
    if (grid > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    wkv6_bwd_sums_kernel<T><<<static_cast<int>(grid), SUM_THREADS, 0, s>>>(
        static_cast<const float*>(a.dv_part),
        static_cast<const float*>(a.bonus_part),
        static_cast<const T*>(a.dy), static_cast<T*>(a.dv),
        static_cast<const float*>(a.du_part), static_cast<float*>(a.du),
        rows, D, D / ROWS, a.B, HD, static_cast<int>(dv_blocks));
    return static_cast<int>(cudaGetLastError());
  }
  if (st != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return walk_d<T, 16>(a, blocks, threads, s);
    case 32: return walk_d<T, 32>(a, blocks, threads, s);
    case 64: return walk_d<T, 64>(a, blocks, threads, s);
    case 128: return walk_d<T, 128>(a, blocks, threads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, bound with ctypes: one launch of stage ``st`` (0 walk,
// 1 sums), in that order on one stream.  r, k, v, w, dy are contiguous
// (B,T,H,D) tensors of one dtype, 16-byte aligned; u (H,D), ds (B,H,D,D),
// the checkpoints ck (B,H,ceil(T/8),D,D), the partials dv_part
// (D/16,B,T,H,D), bonus_part (D/16,B,T,H), du_part (B,H,D) and du (H,D)
// contiguous fp32; dr, dk, dv, dw contiguous (B,T,H,D) of the inputs'
// dtype.  The walk runs ``blocks`` blocks a head (grid x; heads y, batch
// z) of ``threads`` threads: the wrapper's grid_bwd().
extern "C" int repro_wkv6_bwd_f32(int st, const void* r, const void* k,
                                  const void* v, const void* w,
                                  const void* dy, const void* u,
                                  const void* ds, void* ck, void* dr,
                                  void* dk, void* dv, void* dw,
                                  void* dv_part, void* bonus_part,
                                  void* du_part, void* du, int B, int T,
                                  int H, int D, int blocks, int threads,
                                  void* stream) {
  const Args a{r,  k,  v,  w,  dy,      u,          ds,      ck, dr, dk,
               dv, dw, dv_part, bonus_part, du_part, du, B, T, H};
  return stage<float>(st, a, D, blocks, threads, stream);
}

extern "C" int repro_wkv6_bwd_bf16(int st, const void* r, const void* k,
                                   const void* v, const void* w,
                                   const void* dy, const void* u,
                                   const void* ds, void* ck, void* dr,
                                   void* dk, void* dv, void* dw,
                                   void* dv_part, void* bonus_part,
                                   void* du_part, void* du, int B, int T,
                                   int H, int D, int blocks, int threads,
                                   void* stream) {
  const Args a{r,  k,  v,  w,  dy,      u,          ds,      ck, dr, dk,
               dv, dw, dv_part, bonus_part, du_part, du, B, T, H};
  return stage<__nv_bfloat16>(st, a, D, blocks, threads, stream);
}
