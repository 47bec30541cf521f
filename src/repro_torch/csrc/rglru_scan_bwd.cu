// Backward of the RG-LRU scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// from a zero state.  The reverse scan
//   g_t = dh_t + a_{t+1} g_{t+1}     (the last step's g adds dh_T)
// gives da_t = g_t h_{t-1} and db_t = g_t.  a, b, dh (B,T,D) in fp32 or
// bf16, read through their (batch, time) strides with channels
// contiguous; dh_T (B,D) contiguous fp32 -> da, db contiguous (B,T,D) in
// a's dtype; fp32 arithmetic.
//
// Replaces: none.  The JAX package has no backward kernel of
// src/repro/kernels/rglru_scan/rglru_scan.py, rglru_pallas (no custom_vjp):
// it trains through the jnp reference.  This is the backward of the port's
// forward kernel, csrc/rglru_scan.cu.
//
// What bounds it on an H100: bytes.  The least is a, b and dh read once
// and da, db written once, 10 bytes an element in bf16: 0.031 ms at
// recurrentgemma-2b's training B4 T1024 D2560 at 3.35 TB/s.  This kernel
// reads a and b twice (the forward pass that finds the checkpoints, then
// the backward pass), 14 bytes an element, 0.044 ms; the chains (a
// multiply and an add a step, three walks of T steps) take ~15 us a
// block, inside that.
//
// Design: a block is a strip of SW = 32 channels of one batch row (a
// 64-byte row of a step in bf16, 128 bytes in fp32; D 2560 at B4 makes 320
// blocks, all resident at once), one chain warp (lane c walks channel c)
// and three mover warps.  Time walks in chunks of TCH steps (4 KB of one
// array: 64 steps in bf16, 32 in fp32).  The movers keep a ring of STAGES
// chunks filled by 16-byte cp.async copies (4-byte or element copies where
// strides or bases are not 16-byte aligned), zeros past T and D; the chain
// reads each landed chunk in place, a step's row of the strip with one
// conflict-free shared load an array (nothing to transpose).  Pass 1 walks
// the chunks forward over a and b, h in fp32, and keeps h at each chunk's
// start as a checkpoint: in shared memory (CKPT_BYTES, 64 chunks), or past
// that in a global (B, chunks, D) fp32 tensor that the wrapper allocates.
// Pass 2 walks the chunks backward over a, b and dh: the chain recomputes
// the chunk's h_{t-1} from its checkpoint into registers (the chunk
// unrolled, the same rounding, so the same bits), then walks g backward
// through the chunk, da and db into one of two shared chunk buffers,
// which the movers store a chunk behind as 16-byte rows (element stores
// where D or the strip's edge do not allow them), so the chain issues no
// global store.  Both passes are one sequence of 2 x chunks ring loads,
// handed over by one block barrier a chunk (and one more for the last
// chunk's stores).  Products and sums
// are rounded separately (no fused multiply-add), as the plain torch
// version rounds them, so fp32 and bf16 results equal it bitwise; the
// chains are never split across time.  No lane reads another's chain and
// there are no atomics: deterministic.  Measured slower on the card:
// strips of 64 bf16 channels (128-byte rows, two chain warps, 160 blocks:
// half the bytes in flight an SM), 8-slot rings, 64-step chunks, and the
// chain storing da and db itself, a step's row at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int SW = 32;               // channels a block: a lane a channel
constexpr int CHUNK_BYTES = 4096;    // one array's chunk
constexpr int STAGES = 4;            // ring slots, each a, b and dh
constexpr int MOVERS = 3;            // warps that copy a, b, dh in
constexpr int MOVER_THREADS = 32 * MOVERS;
constexpr int THREADS = 32 + MOVER_THREADS;
constexpr int CKPT_BYTES = 8192;     // checkpoints kept in shared memory

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

template <typename T>
struct Cfg {
  static constexpr int E = 16 / sizeof(T);            // elements a copy
  static constexpr int PR = SW / E;                   // copies a row
  static constexpr int TCH = CHUNK_BYTES / (SW * sizeof(T));
  static constexpr int ARR = TCH * SW;                // one array's chunk
  static constexpr int SLOT = 3 * ARR;                // a, b, dh
  static constexpr int CKPT = CKPT_BYTES / (SW * 4);  // chunks kept
  static constexpr int OUT = 2 * ARR;                 // da, db of a chunk
  static constexpr size_t SMEM =
      (STAGES * SLOT + 2 * OUT) * sizeof(T) + CKPT_BYTES;
  static_assert(SW % E == 0, "a strip is whole 16-byte rows");
};

// One array's TCH steps of the strip from ``src`` (time stride ``ts``)
// -> ``dst`` (rows of SW), for the chunk from step t0, by mover thread
// ``t``; rows past T and channels past D are zeros.  ``vec``: 16-byte
// cp.async copies; else element copies (4-byte cp.async in fp32, plain
// loads in bf16).  ``cols``: the strip's channels inside D.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ts,
                                          int t0, int T_len, int cols,
                                          bool vec, int t) {
  using C = Cfg<T>;
  if (vec) {
    for (int i = t; i < C::TCH * C::PR; i += MOVER_THREADS) {
      const int s = i / C::PR, e = (i % C::PR) * C::E;
      const int n = t0 + s < T_len ? max(0, min(C::E, cols - e)) : 0;
      hopper::cp_async16(dst + s * SW + e,
                         n ? src + (t0 + s) * ts + e : src,
                         n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i = t; i < C::ARR; i += MOVER_THREADS) {
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

// One chunk's da and db (rows of SW in ``out``: da, then db) -> the
// strip's rows from step t0 of the (B,T,D) outputs ``da``, ``db``, by
// mover thread ``t``: 16-byte stores where the row's piece is whole and
// D keeps rows 16-byte aligned, else element stores; rows past T and
// channels past D are not written.
template <typename T>
__device__ __forceinline__ void store_rows(const T* out, T* da, T* db,
                                           int t0, int T_len, int D,
                                           int cols, int t) {
  using C = Cfg<T>;
  const int steps = min(C::TCH, T_len - t0);
  const bool vec = D % C::E == 0;
  for (int i = t; i < 2 * steps * C::PR; i += MOVER_THREADS) {
    const int arr = i / (steps * C::PR), r = i % (steps * C::PR);
    const int s = r / C::PR, e = (r % C::PR) * C::E;
    const T* src = out + arr * C::ARR + s * SW + e;
    T* dst = (arr ? db : da) + static_cast<long long>(t0 + s) * D + e;
    if (vec && e + C::E <= cols) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int c = 0; c < C::E && e + c < cols; ++c) dst[c] = src[c];
    }
  }
}

// Pass 2 on one chunk of ``steps`` steps for lane ``lane``: h_{t-1}
// recomputed from the checkpoint ``h`` into registers, then the reverse
// scan from ``carry``, da and db into ``out`` (rows of SW: da, then db)
// for the movers to store; returns the carry into the chunk before.
// FULL: steps == TCH, no step is masked.
template <typename T, bool FULL>
__device__ __forceinline__ float backward_chunk(const T* slot, int steps,
                                                float h, float carry, T* out,
                                                int lane) {
  using C = Cfg<T>;
  const T* av = slot + lane;
  const T* bv = slot + C::ARR + lane;
  const T* dv = slot + 2 * C::ARR + lane;
  float hv[C::TCH];
#pragma unroll
  for (int s = 0; s < C::TCH; ++s) {
    if (FULL || s < steps) {
      hv[s] = h;
      h = __fadd_rn(__fmul_rn(to_f32(av[s * SW]), h), to_f32(bv[s * SW]));
    }
  }
#pragma unroll
  for (int s = C::TCH - 1; s >= 0; --s) {
    if (FULL || s < steps) {
      const float g = __fadd_rn(to_f32(dv[s * SW]), carry);
      out[C::ARR + s * SW + lane] = from_f32<T>(g);
      out[s * SW + lane] = from_f32<T>(__fmul_rn(g, hv[s]));
      carry = __fmul_rn(to_f32(av[s * SW]), g);
    }
  }
  return carry;
}

// Warp 0 walks the strip's chains; the other warps (the movers) keep the
// ring full: item j < chunks is pass 1's chunk j (a, b),
// item j >= chunks pass 2's chunk 2 chunks - 1 - j (a, b, dh).  One
// barrier an item.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ dh, const float* __restrict__ dh_last,
                 float* __restrict__ ckg, T* __restrict__ da,
                 T* __restrict__ db, int T_len, int D, long long sab,
                 long long sat, long long sbb, long long sbt, long long sdb,
                 long long sdt, int vec) {
  using C = Cfg<T>;
  constexpr int TCH = C::TCH;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* outs = ring + STAGES * C::SLOT;     // two chunks' da, db
  float* cks = reinterpret_cast<float*>(outs + 2 * C::OUT);

  const int col0 = blockIdx.x * SW;
  const long long bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int cols = min(SW, D - col0);    // channels inside D
  const int chunks = (T_len + TCH - 1) / TCH;
  const int items = 2 * chunks;

  if (tid >= 32) {                       // a mover
    const int mt = tid - 32;
    const T* ap = a + bi * sab + col0;
    const T* bp = b + bi * sbb + col0;
    const T* dp = dh + bi * sdb + col0;
    auto load = [&](int j) {
      T* slot = ring + (j % STAGES) * C::SLOT;
      const bool fwd = j < chunks;
      const int t0 = (fwd ? j : items - 1 - j) * TCH;
      load_rows<T>(slot, ap, sat, t0, T_len, cols, vec, mt);
      load_rows<T>(slot + C::ARR, bp, sbt, t0, T_len, cols, vec, mt);
      if (!fwd) load_rows<T>(slot + 2 * C::ARR, dp, sdt, t0, T_len, cols,
                             vec, mt);
    };
    T* dap = da + bi * T_len * static_cast<long long>(D) + col0;
    T* dbp = db + bi * T_len * static_cast<long long>(D) + col0;
    // pass 2's item j's da and db, a chunk behind the chain
    auto store = [&](int j) {
      if (j >= chunks)
        store_rows<T>(outs + (j % 2) * C::OUT, dap, dbp,
                      (items - 1 - j) * TCH, T_len, D, cols, mt);
    };
    // one commit group an item: item j has landed at a fixed count
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < items) load(j);
      hopper::cp_async_commit();
    }
    for (int j = 0; j < items; ++j) {
      hopper::cp_async_wait<STAGES - 2>();
      __syncthreads();   // item j landed; j - 1's slot and outputs done
      if (j + STAGES - 1 < items) load(j + STAGES - 1);
      hopper::cp_async_commit();
      if (j > 0) store(j - 1);
    }
    __syncthreads();     // the last item's outputs
    store(items - 1);
    return;
  }

  const int lane = tid;
  const bool live = lane < cols;
  // checkpoint c of this lane: shared memory, or the global tensor
  float* ck = ckg ? ckg + bi * chunks * D + col0 + lane : cks + lane;
  const long long cstep = ckg ? D : SW;
  float h = 0.f;
  float carry = live ? dh_last[bi * D + col0 + lane] : 0.f;
  for (int j = 0; j < items; ++j) {
    __syncthreads();
    const T* slot = ring + (j % STAGES) * C::SLOT;
    if (j < chunks) {                    // pass 1: h forward, checkpoints
      const int steps = min(TCH, T_len - j * TCH);
      if (live || !ckg) ck[j * cstep] = h;
      const T* av = slot + lane;
      const T* bv = slot + C::ARR + lane;
#pragma unroll 8
      for (int s = 0; s < steps; ++s)
        h = __fadd_rn(__fmul_rn(to_f32(av[s * SW]), h), to_f32(bv[s * SW]));
    } else {                             // pass 2: the reverse scan
      const int c = items - 1 - j;
      const int steps = min(TCH, T_len - c * TCH);
      const float h0 = live || !ckg ? ck[c * cstep] : 0.f;
      T* out = outs + (j % 2) * C::OUT;
      carry = steps == TCH
          ? backward_chunk<T, true>(slot, steps, h0, carry, out, lane)
          : backward_chunk<T, false>(slot, steps, h0, carry, out, lane);
    }
  }
  __syncthreads();                       // the movers store the last item
}

template <typename T>
int launch(const void* a, const void* b, const void* dh, const void* dh_last,
           void* ckg, void* da, void* db, int B, int T_len, int D,
           int strips, int threads, long long sab, long long sat,
           long long sbb, long long sbt, long long sdb, long long sdt,
           int vec, void* stream) {
  using C = Cfg<T>;
  const int chunks = (T_len + C::TCH - 1) / C::TCH;
  if (threads != THREADS || strips != (D + SW - 1) / SW)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (ckg == nullptr && chunks > C::CKPT)   // checkpoints that do not fit
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      rglru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(strips, B);
  rglru_bwd_kernel<T><<<grid, threads, C::SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(dh), static_cast<const float*>(dh_last),
      static_cast<float*>(ckg), static_cast<T*>(da), static_cast<T*>(db),
      T_len, D, sab, sat, sbb, sbt, sdb, sdt, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements: (batch,
// time) of a, b, then dh; channels are contiguous.  dh_last (B,D) fp32
// and da, db (B,T,D) of a's dtype are contiguous.  ckpt: the global
// (B, chunks, D) fp32 checkpoint tensor, or null where the checkpoints
// fit in shared memory (the wrapper's bwd_workspace(); null where they do
// not is refused).  The wrapper's grid_bwd(): ``strips`` strips of 32
// channels (grid x; batch y) of ``threads`` threads.  vec: 1 when every
// stride and base is 16-byte aligned.
extern "C" int repro_rglru_bwd_f32(const void* a, const void* b,
                                   const void* dh, const void* dh_last,
                                   void* ckpt, void* da, void* db, int B,
                                   int T, int D, int strips, int threads,
                                   long long sab, long long sat,
                                   long long sbb, long long sbt,
                                   long long sdb, long long sdt, int vec,
                                   void* stream) {
  return launch<float>(a, b, dh, dh_last, ckpt, da, db, B, T, D, strips,
                       threads, sab, sat, sbb, sbt, sdb, sdt, vec, stream);
}

extern "C" int repro_rglru_bwd_bf16(const void* a, const void* b,
                                    const void* dh, const void* dh_last,
                                    void* ckpt, void* da, void* db, int B,
                                    int T, int D, int strips, int threads,
                                    long long sab, long long sat,
                                    long long sbb, long long sbt,
                                    long long sdb, long long sdt, int vec,
                                    void* stream) {
  return launch<__nv_bfloat16>(a, b, dh, dh_last, ckpt, da, db, B, T, D,
                               strips, threads, sab, sat, sbb, sbt, sdb, sdt,
                               vec, stream);
}
