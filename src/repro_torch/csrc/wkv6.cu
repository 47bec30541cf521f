// WKV6 (RWKV6 / Finch) recurrence for Hopper (sm_90a), from a zero state,
// fp32 arithmetic:
//   y_t[j]  = sum_i r_t[i] * S[i][j] + (sum_i r_t[i] * u[i] * k_t[i]) * v_t[j]
//   S[i][:] = w_t[i] * S[i][:] + k_t[i] * v_t[:]
// r, k, v, w (B,T,H,D) in fp32 or bf16, u (H,D) in fp32 -> y (B,T,H,D) in
// r's dtype and the final state S (B,H,D,D) in fp32.
//
// Replaces: src/repro/kernels/rwkv_scan/rwkv_scan.py, wkv6_pallas (_wkv_kernel:
// a (B*H, T/L) grid whose sequential chunk axis carries the D x D state in
// VMEM and evaluates each 32-token chunk with MXU matmuls after dividing
// k by the cumulative decay).
//
// What bounds it on an H100: instruction issue, and the chain of steps.
// With the bonus term split out (a scalar per (b, t, h) times v_t: D
// operations, not D^2), a step costs three fp32 instructions per state
// element: acc += r.S, kv = k.v, S = w.S + kv; at B1 H40 D64 the fp32 pipe
// alone would take 3 D^2 H T / (132 SMs x 128 lanes) ~ 0.015 ms per 1000
// tokens (1.98 GHz), the bytes 0.008 ms.  But each thread also loads its
// rows of r, k, w and its columns of v at every step, and the partial y
// of a column must be summed over the threads that hold its rows: those
// loads and shuffles, not the FMAs, fill the schedulers.  The steps of one
// head are a sequential chain, so the card fills only by spreading each
// head's state over many threads.
//
// Design: the exact recurrence (the TPU's chunked form divides by
// cumulative decays, k * exp(-logA), which leaves fp32 range once a
// chunk's summed -log w passes ~88, so it is not copied).  Value columns
// of the state are independent: a consumer thread keeps a 4-row x
// 2-column tile of S in registers, and the D/4 threads of a column pair
// sit in one warp, so B1 H40 D64 runs 640 consumer warps.  A block serves
// CB columns of one head (24 at D 64: three blocks a head, the last of 16
// columns, 120 blocks at B1 H40, so no SM of an H100 holds two) with
// CB/2 * D/4 consumer threads and four producer warps.  Time walks in
// chunks of TC steps (32, 16 at D 128).  The producers keep a ring of
// STAGES chunks of r, k, w, v in shared memory: one producer thread hands
// the TMA unit four boxes a chunk (r, k, w: D rows x TC steps; v: CB
// columns), completed on an mbarrier, or, for strides TMA cannot read,
// all producers copy elements.  While the consumers step chunk c, the
// producers prepare chunk c + 1: r, k, w to fp32 (w = 1 past T, so those
// steps leave S exactly as it is and any T works without a branch in the
// step loop), the bonus scalars r.(u*k) summed by a fixed butterfly, and v
// in fp32 laid out so that one 16-byte load gives a column pair two
// steps; and they write chunk c - 1's y as 16-byte rows.  One block
// barrier a chunk hands over both.  The consumers read r, k, w as 16-byte
// vectors, keep each step's partial y in registers over the unrolled
// chunk, so only S's own FMA carries from step to step, then sum each
// (step, column)'s D/4 partials over the column pair's lanes together
// (recursive halving: at each of log2(D/4) shuffle stages a thread sends
// half of its sums), add bonus * v, and leave y in shared memory.  r/k/v/w
// are read through their (batch, time, head) strides with the last axis
// contiguous.  Every sum runs in a fixed order and nothing is atomic, so
// two calls give the same bits.  D is 16, 32, 64 or 128, each with its
// column block; the rest are refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int RT = 4;              // state rows per thread
constexpr int CT = 2;              // state columns per thread
constexpr int PRODUCERS = 128;     // threads that stage the chunks
constexpr int PRODUCER_BAR = 1;    // named barrier among them

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

// 8 consecutive shared-memory elements as floats, and 8 floats stored
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
  for (int i = 0; i < 4; ++i) {       // bf16 is the top half of an fp32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void st8(float* p, const float (&f)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

template <typename T, int D, int CB>
struct Cfg {
  static constexpr int P = D / RT;                // threads per column pair
  static constexpr int CP = 32 / P;               // column pairs per warp
  static constexpr int CW = CP * CT;              // columns per warp
  static constexpr int CONSUMERS = CB / CT * P;   // threads stepping S
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
  static constexpr int TC = D == 128 ? 16 : 32;   // time steps per chunk
  static constexpr int NY = TC * CT;              // partial y per thread
  static constexpr int STAGES = 3;                // ring slots
  static constexpr int G = D / 8;                 // 8-wide row segments
  static constexpr int ROW = 3 * D + CB;          // r, k, w rows; v's CB
  static constexpr int SLOT = TC * ROW;           // elements of a chunk
  static constexpr int E = 16 / sizeof(T);        // elements in 16 bytes
  static constexpr int VP = TC * CT + 4;          // a column pair's v pitch
  static constexpr int VSLOT = CB / CT * VP;      // a chunk's v in fp32
  static constexpr int FSLOT = 3 * TC * D;        // its r, k, w in fp32
  static constexpr size_t SMEM =
      STAGES * SLOT * sizeof(T)                   // the ring (input dtype)
      + 2 * (VSLOT + FSLOT) * sizeof(float)       // two chunks in fp32
      + 2 * TC * CB * sizeof(T)                   // two chunks' y rows
      + 2 * TC * sizeof(float)                    // their bonus scalars
      + STAGES * sizeof(uint64_t);                // the ring's mbarriers
  static_assert(P >= 4 && P <= 32 && CB % CW == 0 && CB <= D,
                "a column pair's threads share a warp; whole warps a block");
  static_assert(NY % P == 0, "the halving reduction ends at NY/P sums");
  static_assert(CB % E == 0, "v and y rows are whole 16-byte vectors");
  static_assert((TC * G) % 32 == 0 && 32 % G == 0 && PRODUCERS % G == 0,
                "whole warps of the producers' bonus passes");
};

// One halving of the column's partial sums: a lane keeps yp[0, HALF) or
// yp[HALF, 2 HALF) (``up``), sends the other half to lane ^ ``lane_xor``
// and adds what that lane sent, into yp[0, HALF).
template <int HALF, int N>
__device__ __forceinline__ void halve(float (&yp)[N], bool up, int lane_xor) {
#pragma unroll
  for (int m = 0; m < HALF; ++m) {
    const float lo = yp[m], hi = yp[m + HALF];
    const float send = up ? lo : hi;
    const float keep = up ? hi : lo;
    yp[m] = keep + __shfl_xor_sync(0xffffffffu, send, lane_xor);
  }
}

struct Strides {
  long long v[12];                 // (batch, time, head) of r, k, v, w
};

// One array's TC rows of ``width`` elements from ``src`` (time stride
// ``ts``) -> ``dst`` (rows packed), element by element, for the chunk from
// step t0 and strides 16-byte copies cannot read: 4-byte cp.async in fp32,
// plain loads in bf16 (which cp.async cannot copy alone).  Steps past T
// and columns past ``cols`` are zeros.
template <typename T, int TC, int width>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ts,
                                          int t0, int T_len, int pt,
                                          int cols = width) {
  for (int i = pt; i < TC * width; i += PRODUCERS) {
    const int s = i / width, e = i % width;
    const bool ok = t0 + s < T_len && e < cols;
    const T* at = src + (ok ? (t0 + s) * ts : 0) + e;
    if constexpr (sizeof(T) == 4)
      hopper::cp_async4(dst + i, at, ok ? 4 : 0);
    else
      dst[i] = ok ? *at : from_f32<T>(0.f);
  }
}

// The tensor maps of r, k, w, v for the TMA unit (CUtensorMaps are
// 64-byte aligned kernel parameters): (D, H, T, B) each, boxes of a
// chunk's D rows (r, k, w) or CB columns (v) of TC steps.
struct Maps {
  CUtensorMap m[4];
};

// Chunk c's r, k, w rows (D wide) and v's columns (CB wide) -> ring slot
// ``slot``, laid out [array][step][element].  ``vec`` (every stride and
// base 16-byte aligned): four TMA boxes issued by producer thread 0,
// complete on ``bar`` (steps past T arrive as zeros); else element copies
// by all producers (committed as a cp.async group).
template <typename T, int D, int CB>
__device__ __forceinline__ void load_chunk(T* slot, uint64_t* bar,
                                           const Maps& maps, int col0,
                                           int cols, int h, int b,
                                           const T* const (&base)[4],
                                           const long long (&ts)[4], int t0,
                                           int T_len, bool vec, int pt) {
  constexpr int TC = Cfg<T, D, CB>::TC;
  if (vec) {
    if (pt == 0) {
      hopper::mbar_arrive_expect_tx(
          bar, (3 * D + CB) * TC * static_cast<uint32_t>(sizeof(T)));
      for (int a = 0; a < 3; ++a)
        hopper::tma_load_4d(slot + a * TC * D, &maps.m[a], bar, 0, h, t0, b);
      hopper::tma_load_4d(slot + 3 * TC * D, &maps.m[3], bar, col0, h, t0,
                          b);
    }
    return;
  }
  load_rows<T, TC, D>(slot, base[0], ts[0], t0, T_len, pt);
  load_rows<T, TC, D>(slot + TC * D, base[1], ts[1], t0, T_len, pt);
  load_rows<T, TC, D>(slot + 2 * TC * D, base[2], ts[2], t0, T_len, pt);
  load_rows<T, TC, CB>(slot + 3 * TC * D, base[3], ts[3], t0, T_len, pt,
                       cols);
}

// The producers' preparation of a landed chunk in ring slot ``slot``:
// r, k, w in fp32 (``cf``, [array][step][row]), w = 1 past T (so those
// steps leave S as it is); each step's bonus r.(u*k), summed over the
// row's 8-wide segments by a fixed butterfly (the thread's segment of u
// in ``uu``); and v in fp32 as [column pair][step][2] at pitch VP, so a
// consumer reads two steps of its pair at once.  By producer thread
// ``pt``; the G threads of a step are neighbours in one warp.
template <typename T, int D, int CB>
__device__ __forceinline__ void prepare_chunk(const T* slot, float* cf,
                                              float* vp, float* bonus,
                                              int t0, int T_len, int cols,
                                              int pt,
                                              const float (&uu)[8]) {
  using C = Cfg<T, D, CB>;
  constexpr int TC = C::TC, G = C::G, NP = PRODUCERS;
  const int g = pt % G;
#pragma unroll
  for (int n = 0; n < (TC * G + NP - 1) / NP; ++n) {
    const int it = pt + n * NP;                 // whole warps drop out
    if ((TC * G) % NP != 0 && it >= TC * G) break;
    const int s = it / G;
    float rf[8], kf[8], wf[8];
    ld8(slot + s * D + 8 * g, rf);
    ld8(slot + TC * D + s * D + 8 * g, kf);
    ld8(slot + 2 * TC * D + s * D + 8 * g, wf);
    if (t0 + s >= T_len) {
#pragma unroll
      for (int e = 0; e < 8; ++e) wf[e] = 1.f;
    }
    st8(cf + s * D + 8 * g, rf);
    st8(cf + TC * D + s * D + 8 * g, kf);
    st8(cf + 2 * TC * D + s * D + 8 * g, wf);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) part = fmaf(rf[e], uu[e] * kf[e], part);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (g == 0) bonus[s] = part;
  }
#pragma unroll
  for (int n = 0; n < (TC * CB / CT + NP - 1) / NP; ++n) {
    const int i = pt + n * NP;
    if ((TC * CB / CT) % NP != 0 && i >= TC * CB / CT) break;
    const int s = i / (CB / CT), jp = i % (CB / CT);
    if (jp * CT >= cols) continue;
    const T* vs = slot + 3 * TC * D + s * CB + jp * CT;
    *reinterpret_cast<float2*>(vp + jp * C::VP + s * CT) =
        make_float2(to_f32(vs[0]), to_f32(vs[1]));
  }
}

// 4 consecutive shared-memory floats
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A block: CB columns of one head's state, stepped by the consumer warps
// (CB/2 column pairs, D/4 threads each) straight from the ring, and four
// producer warps that keep STAGES - 1 chunks of r/k/w/v in flight,
// prepare chunk c + 1 (bonus, v, w past T) while the consumers step chunk
// c, and write chunk c - 1's y.  One block barrier a chunk.
template <typename T, int D, int CB>
__global__ void __launch_bounds__(Cfg<T, D, CB>::THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ s_out, int T_len, int H, Strides st,
            int vec, const __grid_constant__ Maps maps) {
  using C = Cfg<T, D, CB>;
  constexpr int P = C::P, CP = C::CP, TC = C::TC, NY = C::NY;
  constexpr int SLOT = C::SLOT, STAGES = C::STAGES, VSLOT = C::VSLOT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* vps = reinterpret_cast<float*>(ring + STAGES * SLOT);  // 2 chunks
  float* cfs = vps + 2 * VSLOT;                                 // 2 chunks
  T* yss = reinterpret_cast<T*>(cfs + 2 * C::FSLOT);           // 2 chunks
  float* bonuses = reinterpret_cast<float*>(yss + 2 * TC * CB);
  uint64_t* bars = reinterpret_cast<uint64_t*>(bonuses + 2 * TC);

  const int col0 = blockIdx.x * CB;
  const int cols = min(CB, D - col0);      // the last block may be narrower
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int chunks = (T_len + TC - 1) / TC;

  if (tid >= C::CONSUMERS) {            // a producer
    const int pt = tid - C::CONSUMERS;
    const T* const base[4] = {r + b * st.v[0] + h * st.v[2],
                              k + b * st.v[3] + h * st.v[5],
                              w + b * st.v[9] + h * st.v[11],
                              v + b * st.v[6] + h * st.v[8] + col0};
    const long long ts[4] = {st.v[1], st.v[4], st.v[10], st.v[7]};
    float uu[8];                        // u of this thread's segment
#pragma unroll
    for (int e = 0; e < 8; ++e) uu[e] = u[h * D + 8 * (pt % C::G) + e];
    if (pt == 0) {
      for (int n = 0; n < STAGES; ++n) hopper::mbar_init(&bars[n], 1);
      hopper::fence_barrier_init();
    }
    hopper::named_bar_sync(PRODUCER_BAR, PRODUCERS);
    // chunk c lands in slot c % STAGES, as phase c / STAGES of its
    // mbarrier (TMA) or as the c-th cp.async group (element copies: one
    // group a chunk, empty ones too, so the wait count is fixed)
    auto load = [&](int c) {
      load_chunk<T, D, CB>(ring + (c % STAGES) * SLOT, &bars[c % STAGES],
                           maps, col0, cols, h, static_cast<int>(b), base, ts,
                           c * TC, T_len, vec, pt);
    };
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) {
      if (c < chunks) load(c);
      hopper::cp_async_commit();
    }
    auto prepare = [&](int c) {
      if (vec) hopper::mbar_wait(&bars[c % STAGES], (c / STAGES) & 1);
      hopper::cp_async_wait<STAGES - 2>();
      hopper::named_bar_sync(PRODUCER_BAR, PRODUCERS);   // all copies in
      prepare_chunk<T, D, CB>(ring + (c % STAGES) * SLOT,
                              cfs + (c % 2) * C::FSLOT,
                              vps + (c % 2) * VSLOT, bonuses + (c % 2) * TC,
                              c * TC, T_len, cols, pt, uu);
    };
    auto store = [&](int c) {          // chunk c's y rows, 16-byte vectors
      constexpr int YV = CB / C::E;
      const T* ys = yss + (c % 2) * TC * CB;
      for (int i = pt; i < TC * YV; i += PRODUCERS) {
        const int s = i / YV, e = (i % YV) * C::E;
        if (c * TC + s < T_len && e < cols)
          *reinterpret_cast<uint4*>(
              y + ((b * T_len + c * TC + s) * H + h) * D + col0 + e) =
              *reinterpret_cast<const uint4*>(ys + s * CB + e);
      }
    };
    if (chunks > 0) prepare(0);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      // the slot of chunk c - 1, which the consumers are done with
      if (c + STAGES - 1 < chunks) load(c + STAGES - 1);
      hopper::cp_async_commit();
      if (c + 1 < chunks) prepare(c + 1);
      if (c > 0) store(c - 1);
      __syncthreads();
    }
    if (chunks > 0) store(chunks - 1);
    return;
  }

  const int p = lane / CP;                 // which rows of the column pair
  const int jl = ((tid / 32) * CP + lane % CP) * CT;  // first column (block)
  const int i0 = p * RT;                   // first state row
  // whole warps past the last block's columns only keep the barriers
  const bool active = jl < cols;
  float S[RT][CT];
#pragma unroll
  for (int ii = 0; ii < RT; ++ii) {
#pragma unroll
    for (int c = 0; c < CT; ++c) S[ii][c] = 0.f;
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (!active) {
      __syncthreads();
      continue;
    }
    const float* cr = cfs + (c % 2) * C::FSLOT;  // r, k, w of the chunk
    const float* ck = cr + TC * D;
    const float* cw = cr + 2 * TC * D;
    const float* cv = vps + (c % 2) * VSLOT + (jl / CT) * C::VP;  // v
    // TC steps: partial y of rows [i0, i0 + RT) in columns jl, jl + 1 per
    // step, S updated; yp[s * CT + c] is step s, column jl + c
    float yp[NY];
#pragma unroll
    for (int s = 0; s < TC; s += 2) {
      const float4 v4 = *reinterpret_cast<const float4*>(cv + s * CT);
      const float vv[2][CT] = {{v4.x, v4.y}, {v4.z, v4.w}};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 r4 = ld4(cr + (s + q) * D + i0);
        const float4 k4 = ld4(ck + (s + q) * D + i0);
        const float4 w4 = ld4(cw + (s + q) * D + i0);
        const float rr[RT] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[RT] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[RT] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int cc = 0; cc < CT; ++cc) {
          float acc = 0.f;
#pragma unroll
          for (int ii = 0; ii < RT; ++ii) acc = fmaf(rr[ii], S[ii][cc], acc);
          yp[(s + q) * CT + cc] = acc;
        }
#pragma unroll
        for (int ii = 0; ii < RT; ++ii) {
#pragma unroll
          for (int cc = 0; cc < CT; ++cc)
            S[ii][cc] = fmaf(ww[ii], S[ii][cc], kk[ii] * vv[q][cc]);
        }
      }
    }
    // sum the P partials of each (step, column) over the column pair's
    // lanes (lane ^ o * CP for o = P/2, P/4, ..., 1): at each halving a
    // lane keeps one half of its sums and sends the other, so lane p ends
    // with sums [p * NY/P, (p+1) * NY/P)
    halve<NY / 2>(yp, (p & (P / 2)) != 0, P / 2 * CP);
    halve<NY / 4>(yp, (p & (P / 4)) != 0, P / 4 * CP);
    if constexpr (P >= 8) halve<NY / 8>(yp, (p & (P / 8)) != 0, P / 8 * CP);
    if constexpr (P >= 16)
      halve<NY / 16>(yp, (p & (P / 16)) != 0, P / 16 * CP);
    if constexpr (P >= 32)
      halve<NY / 32>(yp, (p & (P / 32)) != 0, P / 32 * CP);
    T* ys = yss + (c % 2) * TC * CB;
    const float* bonus = bonuses + (c % 2) * TC;
#pragma unroll
    for (int m = 0; m < NY / P; ++m) {
      const int n = p * (NY / P) + m;     // step n / CT, column jl + n % CT
      ys[(n / CT) * CB + jl + n % CT] =
          from_f32<T>(yp[m] + bonus[n / CT] * cv[n]);
    }
    __syncthreads();
  }
  if (!active) return;
  float* so = s_out + ((b * H + h) * D + i0) * D + col0 + jl;
#pragma unroll
  for (int ii = 0; ii < RT; ++ii)
    *reinterpret_cast<float2*>(so + ii * D) = make_float2(S[ii][0], S[ii][1]);
}

// One launch of the (D, CB) instance on the wrapper's grid: ``blocks``
// column blocks a head of ``threads`` threads each, refused where they
// are not this instance's.
template <typename T, int D, int CB>
int launch_cb(const void* r, const void* k, const void* v, const void* w,
              const void* u, void* y, void* s, int B, int T_len, int H,
              int blocks, int threads, const Strides& st, int vec,
              cudaStream_t stream) {
  using C = Cfg<T, D, CB>;
  if (threads != C::THREADS || blocks != (D + CB - 1) / CB)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<T, D, CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Maps maps = {};
  if (vec && T_len > 0) {  // (D, H, T, B) views: r, k, w by D, v by CB
    const void* src[4] = {r, k, w, v};
    const int at[4] = {0, 3, 9, 6};                // their strides in st
    // a dimension of size 1 is never stepped: any 16-byte stride will do
    auto stride = [](long long s, int n) {
      return n == 1 ? static_cast<long long>(16 / sizeof(T)) : s;
    };
    for (int a = 0; a < 4; ++a) {
      const int rc = hopper::encode_4d(
          &maps.m[a], src[a], sizeof(T), D, H, T_len, B,
          stride(st.v[at[a] + 2], H), stride(st.v[at[a] + 1], T_len),
          stride(st.v[at[a]], B), a < 3 ? D : CB, 1, C::TC, 1);
      if (rc != 0) return rc;
    }
  }
  const dim3 grid(blocks, H, B);
  wkv6_kernel<T, D, CB><<<grid, threads, C::SMEM, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<T*>(y),
      static_cast<float*>(s), T_len, H, st, vec, maps);
  return static_cast<int>(cudaGetLastError());
}

// the instances: (D, CB) with whole warps per block and at most 256
// stepping threads -- kernels/rwkv_scan/rwkv_scan.py's COLUMN_BLOCK, which
// picks one for each D
template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, void* s, int B, int T_len, int H, int D,
           int cb, int blocks, int threads, const long long* st, int vec,
           void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  Strides strides;
  for (int n = 0; n < 12; ++n) strides.v[n] = st[n];
#define REPRO_WKV6_CASE(DD, CC)                                            \
  if (D == DD && cb == CC)                                                 \
    return launch_cb<T, DD, CC>(r, k, v, w, u, y, s, B, T_len, H, blocks, \
                                threads, strides, vec, cs);
  REPRO_WKV6_CASE(16, 16)
  REPRO_WKV6_CASE(32, 32)
  REPRO_WKV6_CASE(64, 24)
  REPRO_WKV6_CASE(128, 16)
#undef REPRO_WKV6_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements: st holds
// the (batch, time, head) strides of r, then k, then v, then w; the last
// axis of each is contiguous.  u is a contiguous fp32 (H,D) tensor, y a
// contiguous (B,T,H,D) tensor of r's dtype, s a contiguous fp32 (B,H,D,D).
// The wrapper's grid (its plan() and grid()): cb columns per block,
// ``blocks`` blocks a head (x; heads are y, batch z) of ``threads``
// threads.  vec: 1 when every stride and base is 16-byte aligned.
extern "C" int repro_wkv6_f32(const void* r, const void* k, const void* v,
                              const void* w, const void* u, void* y, void* s,
                              int B, int T, int H, int D, int cb, int blocks,
                              int threads, const long long* st, int vec,
                              void* stream) {
  return launch<float>(r, k, v, w, u, y, s, B, T, H, D, cb, blocks, threads,
                       st, vec, stream);
}

extern "C" int repro_wkv6_bf16(const void* r, const void* k, const void* v,
                               const void* w, const void* u, void* y, void* s,
                               int B, int T, int H, int D, int cb, int blocks,
                               int threads, const long long* st, int vec,
                               void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, y, s, B, T, H, D, cb, blocks,
                               threads, st, vec, stream);
}
