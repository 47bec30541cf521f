// Backward of the RG-LRU scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// from a zero state.  The reverse scan
//   g_t = dh_t + a_{t+1} g_{t+1}     (the last step's g adds dh_T)
// gives da_t = g_t h_{t-1} and db_t = g_t.  a, b, dh (B,T,D) contiguous in
// fp32 or bf16, dh_T (B,D) contiguous fp32 -> da, db (B,T,D) in a's dtype;
// fp32 arithmetic.
//
// Replaces: none.  The JAX package has no backward kernel of
// src/repro/kernels/rglru_scan/rglru_scan.py, rglru_pallas (no custom_vjp):
// it trains through the jnp reference.  This is the backward of the port's
// forward kernel, csrc/rglru_scan.cu.
//
// What bounds it on an H100: the chains' latency at these sizes.  The
// bytes are a, b and dh read, da and db written, plus an fp32 copy of h
// written and read back: 18 bytes an element in bf16, 0.014 ms at
// recurrentgemma-2b's B1 T1000 D2560 at 3.35 TB/s.  Each channel is two
// sequential chains (h forward, g backward) of a multiply and an add a
// step.
//
// Design: the forward's strip layout (kernels/rglru_scan/rglru_scan.py,
// STRIP, grid()): a block is a strip of 16 channels of one batch row, lane
// c walks channel c.  The forward returns h in a's dtype, but da needs
// h_{t-1} in fp32, so the lane first recomputes h forward, rounding the
// product and the sum separately as the forward kernel and the plain
// version do (the same fp32 bits), and keeps each h_{t-1} in an fp32
// workspace (B,T,D); then it walks g backward.  Loads run 8 steps ahead of
// the chain.  Nothing is shared between lanes: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int STRIP = 16;          // channels a block (the forward's strip)
constexpr int AHEAD = 8;           // steps loaded at once

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
__global__ void __launch_bounds__(STRIP)
rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ dh, const float* __restrict__ dh_last,
                 float* __restrict__ hws, T* __restrict__ da,
                 T* __restrict__ db, int T_len, int D) {
  const int c = blockIdx.x * STRIP + threadIdx.x;
  if (c >= D) return;
  const long long bb = blockIdx.y;
  const long long base = bb * T_len * D + c;
  float h = 0.f;
  for (int t0 = 0; t0 < T_len; t0 += AHEAD) {
    float av[AHEAD], bv[AHEAD];
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
      const int t = t0 + s;
      av[s] = t < T_len ? to_f32(a[base + static_cast<long long>(t) * D]) : 0.f;
      bv[s] = t < T_len ? to_f32(b[base + static_cast<long long>(t) * D]) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
      const int t = t0 + s;
      if (t >= T_len) break;
      hws[base + static_cast<long long>(t) * D] = h;   // h_{t-1}
      h = __fadd_rn(__fmul_rn(av[s], h), bv[s]);
    }
  }
  float carry = dh_last[bb * D + c];               // a_{t+1} g_{t+1}
  for (int t1 = T_len - 1; t1 >= 0; t1 -= AHEAD) {
    float av[AHEAD], dv[AHEAD], hv[AHEAD];
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
      const int t = t1 - s;
      const long long at = base + static_cast<long long>(t) * D;
      av[s] = t >= 0 ? to_f32(a[at]) : 0.f;
      dv[s] = t >= 0 ? to_f32(dh[at]) : 0.f;
      hv[s] = t >= 0 ? hws[at] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
      const int t = t1 - s;
      if (t < 0) break;
      const long long at = base + static_cast<long long>(t) * D;
      const float g = __fadd_rn(dv[s], carry);
      db[at] = from_f32<T>(g);
      da[at] = from_f32<T>(__fmul_rn(g, hv[s]));
      carry = __fmul_rn(av[s], g);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* dh, const void* dh_last,
           void* hws, void* da, void* db, int B, int T_len, int D,
           int strips, int threads, void* stream) {
  if (threads != STRIP || strips != (D + STRIP - 1) / STRIP)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(strips, B);
  rglru_bwd_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(dh), static_cast<const float*>(dh_last),
      static_cast<float*>(hws), static_cast<T*>(da), static_cast<T*>(db),
      T_len, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes.  a, b, dh, da, db contiguous (B,T,D)
// of one dtype; dh_last (B,D) and the workspace hws (B,T,D) contiguous
// fp32.  The wrapper's grid_bwd(): ``strips`` strips of 16 channels (grid
// x; batch y) of ``threads`` (16) threads.
extern "C" int repro_rglru_bwd_f32(const void* a, const void* b,
                                   const void* dh, const void* dh_last,
                                   void* hws, void* da, void* db, int B,
                                   int T, int D, int strips, int threads,
                                   void* stream) {
  return launch<float>(a, b, dh, dh_last, hws, da, db, B, T, D, strips,
                       threads, stream);
}

extern "C" int repro_rglru_bwd_bf16(const void* a, const void* b,
                                    const void* dh, const void* dh_last,
                                    void* hws, void* da, void* db, int B,
                                    int T, int D, int strips, int threads,
                                    void* stream) {
  return launch<__nv_bfloat16>(a, b, dh, dh_last, hws, da, db, B, T, D,
                               strips, threads, stream);
}
