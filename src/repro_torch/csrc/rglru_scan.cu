// RG-LRU scan for Hopper (sm_90a): the diagonal linear recurrence of
// Griffin / RecurrentGemma, h_t = a_t * h_{t-1} + b_t per channel, from a
// zero state, fp32 arithmetic.  a, b (B,T,D) in fp32 or bf16 -> h (B,T,D)
// in a's dtype and h_T (B,D) in fp32.
//
// Replaces: src/repro/kernels/rglru_scan/rglru_scan.py, rglru_pallas
// (_rglru_kernel: a (B * D/bd, T/L) grid whose sequential chunk axis
// carries the state of a 256-channel block in VMEM and steps each 64-token
// chunk with a fori_loop of vector FMAs).
//
// What bounds it on an H100: bytes, then the chains.  Two operations per
// element against a and b read and h written (6 bytes per element in
// bf16), so the least time is the 3.35 TB/s memory rate: 0.0046 ms at
// recurrentgemma-2b's B1 T1000 D2560, 0.019 ms at T4096.  A channel's
// steps are a sequential chain of one multiply and one add (~8 cycles a
// step, ~0.004 ms per 1000 steps at 1.98 GHz); the warp that walks them
// must get each step's a and b without waiting and hand h on without
// stalling, while the card keeps ~24 KB of reads in flight on every SM to
// near the memory rate.
//
// Design: a block is a strip of SW = 16 channels (D 2560 makes 160
// blocks), with one chain warp (lane c walks channel c) and three mover
// warps.  Time walks in chunks of TCH steps (8 KB of a and b a chunk).
// The movers keep a ring of STAGES chunks filled by 16-byte cp.async
// copies (4-byte or element copies for strides that 16-byte copies cannot
// read), 24 KB ahead; turn each landed chunk into the chain warp's layout,
// a row of steps per channel, one chunk ahead, by 16-byte tiles of E steps
// x E channels transposed in registers; and write h out, transposed back,
// as 16-byte rows one chunk behind.  One block barrier a chunk hands over
// both.  The chain lanes read 8 steps of a and b with one 16-byte load
// each, two batches ahead of their use, and write 8 steps of h with one;
// they round the product and the sum separately (no fused multiply-add),
// as the plain torch version does, so fp32 results equal it bitwise; the
// chain is never split across time, which would change the rounding.  Any
// T (the last chunk's tail of fewer than 8 steps is stepped alone) and any
// D (the last strip's channels past D read zeros and store nothing); a
// and b are read through their (batch, time) strides with channels
// contiguous.  No lane reads another's chain, so the result is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int STAGES = 4;          // ring slots
constexpr int STAGE_BYTES = 8192;  // a and b of one chunk
constexpr int MOVERS = 3;          // warps that copy a, b in and h out
constexpr int MOVER_THREADS = 32 * MOVERS;
constexpr int THREADS = 32 + MOVER_THREADS;
constexpr int MOVER_BAR = 1;       // named barrier among the movers

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

// 8 consecutive steps of one channel, as loaded (16 or 32 bytes): the
// chain converts them a batch after the load, so no instruction waits on
// a load that is still in flight
template <typename T> struct Raw8;
template <> struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float at(int n) const {   // n a constant
    const uint32_t w = n < 2 ? u.x : n < 4 ? u.y : n < 6 ? u.z : u.w;
    return __uint_as_float(n % 2 ? w & 0xffff0000u : w << 16);
  }
  __device__ __forceinline__ void to_f32(float (&f)[8]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {     // bf16 is the top half of an fp32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ float at(int n) const {   // n a constant
    const float4& q = n < 4 ? a : b;
    const int m = n % 4;
    return m == 0 ? q.x : m == 1 ? q.y : m == 2 ? q.z : q.w;
  }
  __device__ __forceinline__ void to_f32(float (&f)[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// 8 floats stored as 8 consecutive elements (one or two 16-byte stores)
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h2);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int SW>
struct Cfg {
  static constexpr int E = 16 / sizeof(T);        // elements per copy
  static constexpr int PR = SW / E;               // copies per row
  static constexpr int TCH = STAGE_BYTES / (2 * SW * sizeof(T));
  static constexpr int TP = TCH + E;              // a channel's row pitch
  // ring: STAGES x (a, b) x [TCH][SW]; the chain's chunk, two of them:
  // (a, b) x [SW][TP]; its h, two chunks: [SW][TP]
  static constexpr int RING = STAGES * 2 * TCH * SW;
  static constexpr int TR = 2 * SW * TP;
  static constexpr size_t SMEM = (RING + 2 * TR + 2 * SW * TP) * sizeof(T);
  static_assert(SW <= 32 && SW % E == 0, "a strip is whole 16-byte rows");
  static_assert(TCH % 8 == 0, "a chunk is whole batches of 8 steps");
};

// One array's TCH rows of the strip from ``src`` (time stride ``ts``) ->
// ``dst`` (rows of SW), for the chunk from step t0, by mover thread
// ``t``; rows past T and channels past D are zeros.  ``vec``: 16-byte
// cp.async copies (stride and base 16-byte aligned); else element copies
// (4-byte cp.async in fp32, plain loads in bf16).  ``cols``: the strip's
// channels inside D.
template <typename T, int SW>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ts,
                                          int t0, int T_len, int cols,
                                          bool vec, int t) {
  using C = Cfg<T, SW>;
  if (vec) {
    for (int i = t; i < C::TCH * C::PR; i += MOVER_THREADS) {
      const int s = i / C::PR, e = (i % C::PR) * C::E;
      const int n = t0 + s < T_len ? max(0, min(C::E, cols - e)) : 0;
      hopper::cp_async16(dst + s * SW + e,
                         n ? src + (t0 + s) * ts + e : src,
                         n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i = t; i < C::TCH * SW; i += MOVER_THREADS) {
      const int s = i / SW, e = i % SW;
      const bool ok = t0 + s < T_len && e < cols;
      const T* at = ok ? src + (t0 + s) * ts + e : src;
      if constexpr (sizeof(T) == 4)
        hopper::cp_async4(dst + i, at, ok ? 4 : 0);
      else
        dst[i] = ok ? *at : from_f32<T>(0.f);
    }
  }
}

// A tile of E steps x E channels (E rows of 16 bytes) transposed in
// registers: row j of ``out`` holds element j of every row of ``in``.
__device__ __forceinline__ void transpose_tile(const uint4 (&in)[4],
                                               uint4 (&out)[4]) {  // fp32
  const uint32_t* x = reinterpret_cast<const uint32_t*>(in);
  uint32_t* y = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j * 4 + i] = x[i * 4 + j];
  }
}
__device__ __forceinline__ void transpose_tile(const uint4 (&in)[8],
                                               uint4 (&out)[8]) {  // bf16
  const uint32_t* x = reinterpret_cast<const uint32_t*>(in);
  uint32_t* y = reinterpret_cast<uint32_t*>(out);
  // word k of row i holds elements 2k, 2k + 1; word m of output row j
  // holds element j of rows 2m, 2m + 1
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t lo = x[2 * m * 4 + k], hi = x[(2 * m + 1) * 4 + k];
      y[(2 * k) * 4 + m] = __byte_perm(lo, hi, 0x5410);
      y[(2 * k + 1) * 4 + m] = __byte_perm(lo, hi, 0x7632);
    }
  }
}

// A landed ring slot (a, b as [step][channel]) -> the chain's layout
// [channel][step] (pitch TP), by mover thread ``t``, an E x E tile a
// thread.
template <typename T, int SW>
__device__ __forceinline__ void transpose_in(const T* slot, T* tr, int t) {
  using C = Cfg<T, SW>;
  constexpr int E = C::E, TS = C::TCH / E, CS = SW / E;   // tiles
  for (int i = t; i < 2 * TS * CS; i += MOVER_THREADS) {
    const int a = i / (TS * CS), s0 = i % (TS * CS) / CS * E,
              e0 = i % CS * E;
    uint4 in[E], out[E];
#pragma unroll
    for (int r = 0; r < E; ++r)
      in[r] = *reinterpret_cast<const uint4*>(
          slot + (a * C::TCH + s0 + r) * SW + e0);
    transpose_tile(in, out);
#pragma unroll
    for (int r = 0; r < E; ++r)
      *reinterpret_cast<uint4*>(tr + (a * SW + e0 + r) * C::TP + s0) =
          out[r];
  }
}

// Steps [0, steps) of chunk from the chain's layout: h as [step][channel]
// rows -> device memory, by mover thread ``t``.  ``hvec``: 16-byte stores
// of E x E tiles transposed back (D keeps rows 16-byte aligned; a tail of
// fewer than E steps goes element by element); else element stores.
template <typename T, int SW>
__device__ __forceinline__ void store_out(const T* hr, T* hp, int t0,
                                          int steps, int D, int cols,
                                          bool hvec, int t) {
  using C = Cfg<T, SW>;
  constexpr int E = C::E, CS = SW / E;
  const int full = hvec ? steps / E * E : 0;     // steps stored by tiles
  for (int i = t; i < full / E * CS; i += MOVER_THREADS) {
    const int s0 = i / CS * E, e0 = i % CS * E;
    if (e0 >= cols) continue;
    uint4 in[E], out[E];
#pragma unroll
    for (int r = 0; r < E; ++r)
      in[r] = *reinterpret_cast<const uint4*>(hr + (e0 + r) * C::TP + s0);
    transpose_tile(in, out);
#pragma unroll
    for (int r = 0; r < E; ++r)
      *reinterpret_cast<uint4*>(
          hp + static_cast<long long>(t0 + s0 + r) * D + e0) = out[r];
  }
  for (int i = full * SW + t; i < steps * SW; i += MOVER_THREADS) {
    const int s = i / SW, e = i % SW;
    if (e < cols)
      hp[static_cast<long long>(t0 + s) * D + e] = hr[e * C::TP + s];
  }
}

// 8 steps of the chain from h = ``hc`` over a, b in ``xa``, ``xb``, h
// stored to ``out`` (8 steps of one channel's row); returns h.  Between
// its steps it turns the next 8 steps' raw a, b (``ra``, ``rb``) into
// floats (``ya``, ``yb``): the issue slots the chain's latency leaves
// free, taken in program order.  The product and the sum are rounded
// separately, as the plain version rounds them.
template <typename T>
__device__ __forceinline__ float chain8(const float (&xa)[8],
                                        const float (&xb)[8],
                                        const Raw8<T>& ra, const Raw8<T>& rb,
                                        float (&ya)[8], float (&yb)[8],
                                        float hc, T* out) {
  float hv[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    hc = __fadd_rn(__fmul_rn(xa[n], hc), xb[n]);
    hv[n] = hc;
    ya[n] = ra.at(n);
    yb[n] = rb.at(n);
  }
  store8(out, hv);
  return hc;
}

// Channel ``lane``'s chain over ``steps`` steps of one chunk (a, b in the
// chain's layout, rows of pitch TP) from h = ``hc``, h into ``hr``;
// returns h.  Whole batches of 8 steps go two at a time through two
// register buffers: while the chain walks one batch, the next (loaded a
// batch earlier) turns to floats and the one after is loaded, so the
// chain waits on no load and no conversion.  Loads run up to three
// batches past the chunk's rows, into other rows of shared memory, and
// are not used.  The tail of fewer than 8 steps goes one step at a time.
template <typename T, int SW>
__device__ __forceinline__ float scan_chunk(const T* ta, const T* tb, T* hr,
                                            int steps, float hc) {
  const int nb = steps / 8;
  Raw8<T> r0a, r0b, r1a, r1b;
  float x0a[8], x0b[8], x1a[8], x1b[8];
  r0a.load(ta);
  r0b.load(tb);
  r1a.load(ta + 8);
  r1b.load(tb + 8);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    x0a[n] = r0a.at(n);
    x0b[n] = r0b.at(n);
  }
  int j = 0;
#pragma unroll 1
  for (; j + 2 <= nb; j += 2) {
    r0a.load(ta + 8 * (j + 2));
    r0b.load(tb + 8 * (j + 2));
    hc = chain8(x0a, x0b, r1a, r1b, x1a, x1b, hc, hr + 8 * j);
    r1a.load(ta + 8 * (j + 3));
    r1b.load(tb + 8 * (j + 3));
    hc = chain8(x1a, x1b, r0a, r0b, x0a, x0b, hc, hr + 8 * (j + 1));
  }
  if (j < nb) hc = chain8(x0a, x0b, r1a, r1b, x1a, x1b, hc, hr + 8 * j);
  for (int s = nb * 8; s < steps; ++s) {
    hc = __fadd_rn(__fmul_rn(to_f32(ta[s]), hc), to_f32(tb[s]));
    hr[s] = from_f32<T>(hc);
  }
  return hc;
}

// Warp 0 walks the strip's chains (lane c, channel c); the other warps
// (the movers) keep STAGES chunks of a and b in flight, turn each landed
// chunk into the chain's layout one chunk ahead, and write h out one
// chunk behind.  One barrier a chunk.
template <typename T, int SW>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ h, float* __restrict__ h_last, int T_len, int D,
             long long sab, long long sat, long long sbb, long long sbt,
             int vec) {
  using C = Cfg<T, SW>;
  constexpr int TCH = C::TCH, TP = C::TP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* trs = ring + C::RING;               // two chunks, chain's layout
  T* hrs = trs + 2 * C::TR;              // two chunks of h

  const int col0 = blockIdx.x * SW;
  const long long bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int cols = min(SW, D - col0);    // channels inside D
  const int chunks = (T_len + TCH - 1) / TCH;

  if (tid >= 32) {                       // a mover
    const int mt = tid - 32;
    const T* ap = a + bi * sab + col0;
    const T* bp = b + bi * sbb + col0;
    T* hp = h + bi * T_len * D + col0;
    const bool hvec = (D * sizeof(T)) % 16 == 0;
    auto load = [&](int c) {
      T* slot = ring + (c % STAGES) * 2 * TCH * SW;
      load_rows<T, SW>(slot, ap, sat, c * TCH, T_len, cols, vec, mt);
      load_rows<T, SW>(slot + TCH * SW, bp, sbt, c * TCH, T_len, cols, vec,
                       mt);
    };
    // one commit group per chunk: chunk n has landed at a fixed count
    auto advance = [&](int c) {          // chunk c -> the chain's layout
      hopper::cp_async_wait<STAGES - 1>();
      hopper::named_bar_sync(MOVER_BAR, MOVER_THREADS);
      transpose_in<T, SW>(ring + (c % STAGES) * 2 * TCH * SW,
                          trs + (c % 2) * C::TR, mt);
      hopper::named_bar_sync(MOVER_BAR, MOVER_THREADS);
      if (c + STAGES < chunks) load(c + STAGES);
      hopper::cp_async_commit();
    };
    auto store = [&](int c) {
      store_out<T, SW>(hrs + (c % 2) * SW * TP, hp, c * TCH,
                       min(TCH, T_len - c * TCH), D, cols, hvec, mt);
    };
#pragma unroll
    for (int c = 0; c < STAGES; ++c) {
      if (c < chunks) load(c);
      hopper::cp_async_commit();
    }
    if (chunks > 0) advance(0);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) advance(c + 1);
      if (c > 0) store(c - 1);
      __syncthreads();
    }
    if (chunks > 0) store(chunks - 1);
    return;
  }

  float hc = 0.f;
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (tid < SW) {
      const T* tr = trs + (c % 2) * C::TR;
      hc = scan_chunk<T, SW>(tr + tid * TP, tr + (SW + tid) * TP,
                             hrs + (c % 2) * SW * TP + tid * TP,
                             min(TCH, T_len - c * TCH), hc);
    }
    __syncthreads();
  }
  if (tid < cols) h_last[bi * D + col0 + tid] = hc;
}

// One launch of the SW instance on the wrapper's grid: ``strips`` blocks
// a batch row of ``threads`` threads each, refused where they are not
// this instance's.
template <typename T, int SW>
int launch_sw(const void* a, const void* b, void* h, void* h_last, int B,
              int T_len, int D, int strips, int threads, long long sab,
              long long sat, long long sbb, long long sbt, int vec,
              cudaStream_t stream) {
  using C = Cfg<T, SW>;
  if (threads != THREADS || strips != (D + SW - 1) / SW)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rglru_kernel<T, SW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(strips, B);
  rglru_kernel<T, SW><<<grid, threads, C::SMEM, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      static_cast<float*>(h_last), T_len, D, sab, sat, sbb, sbt, vec);
  return static_cast<int>(cudaGetLastError());
}

// the instance: strips of 16 channels -- kernels/rglru_scan/
// rglru_scan.py's STRIP
template <typename T>
int launch(const void* a, const void* b, void* h, void* h_last, int B,
           int T_len, int D, int strips, int threads, long long sab,
           long long sat, long long sbb, long long sbt, int vec,
           void* stream) {
  return launch_sw<T, 16>(a, b, h, h_last, B, T_len, D, strips, threads, sab,
                          sat, sbb, sbt, vec,
                          static_cast<cudaStream_t>(stream));
}

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements: (batch,
// time) of a, then of b; channels are contiguous.  h is a contiguous
// (B,T,D) tensor of a's dtype, h_last a contiguous fp32 (B,D).  The
// wrapper's grid (its grid()): ``strips`` blocks a batch row (x; batch is
// y) of ``threads`` threads.  vec: 1 when both strides and bases are
// 16-byte aligned.
extern "C" int repro_rglru_f32(const void* a, const void* b, void* h,
                               void* h_last, int B, int T, int D, int strips,
                               int threads, long long sab, long long sat,
                               long long sbb, long long sbt, int vec,
                               void* stream) {
  return launch<float>(a, b, h, h_last, B, T, D, strips, threads, sab, sat,
                       sbb, sbt, vec, stream);
}

extern "C" int repro_rglru_bf16(const void* a, const void* b, void* h,
                                void* h_last, int B, int T, int D, int strips,
                                int threads, long long sab, long long sat,
                                long long sbb, long long sbt, int vec,
                                void* stream) {
  return launch<__nv_bfloat16>(a, b, h, h_last, B, T, D, strips, threads, sab,
                               sat, sbb, sbt, vec, stream);
}
