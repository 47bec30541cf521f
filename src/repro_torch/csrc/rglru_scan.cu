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
// What bounds it on an H100: bytes.  Two operations per element against
// a and b read and h written (6 bytes per element in bf16), so the least
// time is the 3.35 TB/s memory rate.  The time steps of a channel are a
// sequential chain, so what sets this kernel's pace is how many loads are
// in flight while a thread walks it.
//
// Design: one thread per (batch, channel), 128 channels per block, so the
// loads and stores of a warp are 32 neighbouring channels (coalesced).
// Each thread walks time in chunks of U steps: the next chunk's a and b
// are loaded into registers (in the input dtype) while the current chunk
// computes, so 2*U loads are in flight behind U steps of arithmetic.  The
// product and the sum are rounded separately (no fused multiply-add), as
// the plain torch version rounds them, so fp32 results equal it bitwise.
// Any T (the ragged last chunk is masked) and any D (the last block's
// channels past D idle); a and b are read through their (batch, time)
// strides with channels contiguous.  No thread talks to another, so the
// result is deterministic.  A warp scan within a chunk plus a carry, for
// more parallelism at B = 1, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;       // channels per block
constexpr int U = 16;              // time steps per prefetched chunk

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
__device__ __forceinline__ void load_chunk(T (&pa)[U], T (&pb)[U],
                                           const T* ap, const T* bp,
                                           long long sat, long long sbt,
                                           int t0, int T_len) {
#pragma unroll
  for (int n = 0; n < U; ++n) {
    const bool in = t0 + n < T_len;
    pa[n] = in ? ap[(t0 + n) * sat] : from_f32<T>(0.f);
    pb[n] = in ? bp[(t0 + n) * sbt] : from_f32<T>(0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ h, float* __restrict__ h_last, int T_len, int D,
             long long sab, long long sat, long long sbb, long long sbt) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const long long bi = blockIdx.y;
  if (d >= D) return;
  const T* ap = a + bi * sab + d;
  const T* bp = b + bi * sbb + d;
  T* hp = h + bi * T_len * D + d;

  float hc = 0.f;
  T pa[U], pb[U];
  load_chunk<T>(pa, pb, ap, bp, sat, sbt, 0, T_len);
  for (int t0 = 0; t0 < T_len; t0 += U) {
    T ca[U], cb[U];
#pragma unroll
    for (int n = 0; n < U; ++n) {
      ca[n] = pa[n];
      cb[n] = pb[n];
    }
    if (t0 + U < T_len) load_chunk<T>(pa, pb, ap, bp, sat, sbt, t0 + U, T_len);
#pragma unroll
    for (int n = 0; n < U; ++n) {
      if (t0 + n < T_len) {
        hc = __fadd_rn(__fmul_rn(to_f32(ca[n]), hc), to_f32(cb[n]));
        hp[static_cast<long long>(t0 + n) * D] = from_f32<T>(hc);
      }
    }
  }
  h_last[bi * D + d] = hc;
}

template <typename T>
int launch(const void* a, const void* b, void* h, void* h_last, int B,
           int T_len, int D, long long sab, long long sat, long long sbb,
           long long sbt, void* stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      static_cast<float*>(h_last), T_len, D, sab, sat, sbb, sbt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements: (batch,
// time) of a, then of b; channels are contiguous.  h is a contiguous
// (B,T,D) tensor of a's dtype, h_last a contiguous fp32 (B,D).
extern "C" int repro_rglru_f32(const void* a, const void* b, void* h,
                               void* h_last, int B, int T, int D,
                               long long sab, long long sat, long long sbb,
                               long long sbt, void* stream) {
  return launch<float>(a, b, h, h_last, B, T, D, sab, sat, sbb, sbt, stream);
}

extern "C" int repro_rglru_bf16(const void* a, const void* b, void* h,
                                void* h_last, int B, int T, int D,
                                long long sab, long long sat, long long sbb,
                                long long sbt, void* stream) {
  return launch<__nv_bfloat16>(a, b, h, h_last, B, T, D, sab, sat, sbb, sbt,
                               stream);
}
