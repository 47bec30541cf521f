// Fused row RMSNorm for Hopper (sm_90a):
//   y = x * rsqrt(mean(x^2) + eps) [* g], fp32 math, output in x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py, rmsnorm_pallas (one row
// block per grid step, reduction and scale fused in VMEM).
//
// What bounds it on an H100: bytes.  It does about four operations per
// element against four to eight bytes moved, far below the card's ratio
// of compute to the 3.35 TB/s memory rate, so the floor is one read of x,
// one read of g and one write of y.  The served rows are narrow (64 for
// rwkv6's per-head ln_x, 128 for qwen3's q/k-norm, up to 163840 rows) or
// wide (2048-4096), so the design is picked by width.
//
// Design: three routes, picked by the wrapper from the width, the dtype
// and the alignment (kernels/rmsnorm/rmsnorm.py, route()), never from the
// row count:
//   warp   (16-byte vectors, a row fits one warp's registers: width <= 512
//          fp32, <= 1024 bf16): G lanes per row (G the power of two that
//          covers the row's vectors, at most 32; up to 4 vectors a lane),
//          32 / G rows per warp, 8 warps a block; a lane loads 4 vectors
//          at once (of 4, 2 or 1 rows).  Warps walk their rows grid-stride,
//          so each lane loads its slice of g once.  The sum of squares is
//          a butterfly of warp shuffles over the G lanes: no shared memory
//          and no __syncthreads.
//   block  (16-byte vectors, wider rows): one block per row, its thread
//          count sized by the width so each thread holds 1, 2, 4 or 8 of
//          the row's vectors in registers (a row within 128 threads where
//          8 vectors a thread allow it); one cross-warp reduction.
//   scalar (any width, stride or base): one 256-thread block per row, the
//          threads striding the row twice (sum, then scale; the second
//          read hits L1/L2).
// On the two vector routes every element is read once and written once,
// 16 bytes at a time, and stays in registers between the sum and the
// scale.  A row's sum runs in an order fixed by its width and route, so a
// row gives the same bits alone (decode) as among 32000 others (prefill),
// and the result is deterministic.  A null g means no gain (the runtime's
// rmsnorm without a scale input).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // warp and scalar routes

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

// 16 bytes <-> 4 fp32 or 8 bf16 as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    h.x = __ushort_as_bfloat16(static_cast<unsigned short>(w[i] & 0xffffu));
    h.y = __ushort_as_bfloat16(static_cast<unsigned short>(w[i] >> 16));
    const float2 p = __bfloat1622float2(h);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(f[2 * i]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A row's vectors `idx = first + step * v` (v < VPT, idx < nvec) into
// registers, and their sum of squares in order v, e
template <typename T, int VPT>
__device__ __forceinline__ float load_row(const T* __restrict__ xr, int first,
                                          int step, int nvec, bool ok,
                                          float (&xv)[VPT][16 / sizeof(T)]) {
  constexpr int E = 16 / sizeof(T);
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int idx = first + step * v;
    if (ok && idx < nvec) {
      unpack(__ldg(reinterpret_cast<const uint4*>(xr) + idx), xv[v]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) xv[v][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) ss = fmaf(xv[v][e], xv[v][e], ss);
  }
  return ss;
}

// y = x * r [* g] for the row's vectors, 16-byte stores
template <typename T, int VPT>
__device__ __forceinline__ void store_row(
    T* __restrict__ yr, int first, int step, int nvec, float r,
    const float (&xv)[VPT][16 / sizeof(T)],
    const float (&gv)[VPT][16 / sizeof(T)], bool gain) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int idx = first + step * v;
    if (idx >= nvec) continue;
    float o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      o[e] = xv[v][e] * r;
      if (gain) o[e] *= gv[v][e];
    }
    reinterpret_cast<uint4*>(yr)[idx] = pack(o);
  }
}

template <typename T, int VPT>
__device__ __forceinline__ void load_gain(const T* __restrict__ g, int first,
                                          int step, int nvec,
                                          float (&gv)[VPT][16 / sizeof(T)]) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int idx = first + step * v;
    if (g != nullptr && idx < nvec) {
      unpack(__ldg(reinterpret_cast<const uint4*>(g) + idx), gv[v]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) gv[v][e] = 1.f;
    }
  }
}

// ------------------------------------------------------------------ warp

template <typename T, int G, int VPT>
__global__ void __launch_bounds__(THREADS)
rms_warp_kernel(const T* __restrict__ x, const T* __restrict__ g,
                T* __restrict__ y, long long rows, int d, long long sx,
                float eps) {
  constexpr int E = 16 / sizeof(T);
  constexpr int RPW = 32 / G;         // rows per warp at a time
  constexpr int R = 4 / VPT;          // ... times R, loaded together
  const int nvec = d / E;
  const int lane = threadIdx.x % 32;
  const int sub = lane % G;
  float gv[VPT][E];
  load_gain<T, VPT>(g, sub, G, nvec, gv);
  const long long warp0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / 32;
  const long long wstride = static_cast<long long>(gridDim.x) * THREADS / 32;
  // the loop runs alike in every lane of a warp, so the shuffles see all
  // 32 lanes; rows past the end only skip their loads and stores
  for (long long base = warp0 * RPW * R; base < rows;
       base += wstride * RPW * R) {
    float xv[R][VPT][E];
    float ss[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + r * RPW + lane / G;
      ss[r] = load_row<T, VPT>(x + row * sx, sub, G, nvec, row < rows,
                               xv[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], off);
      const long long row = base + r * RPW + lane / G;
      const float rs = rsqrtf(ss[r] / static_cast<float>(d) + eps);
      if (row < rows)
        store_row<T, VPT>(y + row * d, sub, G, nvec, rs, xv[r], gv,
                          g != nullptr);
    }
  }
}

// ----------------------------------------------------------------- block

template <typename T, int VPT>
__global__ void __launch_bounds__(512)
rms_block_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 T* __restrict__ y, int d, long long sx, float eps) {
  constexpr int E = 16 / sizeof(T);
  __shared__ float warp_sums[32];
  const int nvec = d / E;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  // g's vectors are requested with the row's, kept packed (4 registers a
  // vector) until the scale
  uint4 graw[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int idx = tid + blockDim.x * v;
    if (g != nullptr && idx < nvec)
      graw[v] = __ldg(reinterpret_cast<const uint4*>(g) + idx);
  }
  float xv[VPT][E];
  float ss = load_row<T, VPT>(x + row * sx, tid, blockDim.x, nvec, true, xv);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tid % 32 == 0) warp_sums[tid / 32] = ss;
  __syncthreads();
  float t = 0.f;                      // every thread, the same order
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w)
    t += warp_sums[w];
  const float r = rsqrtf(t / static_cast<float>(d) + eps);
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int idx = tid + blockDim.x * v;
    if (idx >= nvec) continue;
    float o[E], gv[E];
    if (g != nullptr) unpack(graw[v], gv);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      o[e] = xv[v][e] * r;
      if (g != nullptr) o[e] *= gv[e];
    }
    reinterpret_cast<uint4*>(y + row * d)[idx] = pack(o);
  }
}

// ---------------------------------------------------------------- scalar

template <typename T>
__global__ void __launch_bounds__(THREADS)
rms_scalar_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  T* __restrict__ y, int d, long long sx, float eps) {
  __shared__ float warp_sums[THREADS / 32];
  __shared__ float scale;
  const long long row = blockIdx.x;
  const T* xr = x + row * sx;
  T* yr = y + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < THREADS / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) scale = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = scale;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    float v = to_f32(xr[i]) * r;
    if (g != nullptr) v *= to_f32(g[i]);
    yr[i] = from_f32<T>(v);
  }
}

// ---------------------------------------------------------------- launch

enum Route { WARP = 0, BLOCK = 1, SCALAR = 2 };

// at most 8 blocks an SM; they walk their rows grid-stride
template <typename T, int G, int VPT>
void launch_warp(const T* x, const T* g, T* y, long long rows, int d,
                 long long sx, float eps, int sms, cudaStream_t st) {
  constexpr long long ROWS_PER_BLOCK = THREADS / 32 * (32 / G) * (4 / VPT);
  const long long need = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const long long cap = 8LL * sms;
  const int blocks = static_cast<int>(need < cap ? need : cap);
  rms_warp_kernel<T, G, VPT><<<blocks, THREADS, 0, st>>>(x, g, y, rows, d,
                                                         sx, eps);
}

template <typename T, int VPT>
void launch_block(const T* x, const T* g, T* y, int rows, int d,
                  long long sx, float eps, cudaStream_t st) {
  const int nvec = d / (16 / static_cast<int>(sizeof(T)));
  const int threads = ((nvec + VPT - 1) / VPT + 31) / 32 * 32;
  rms_block_kernel<T, VPT><<<rows, threads, 0, st>>>(x, g, y, d, sx, eps);
}

template <typename T>
int launch(const void* x_, const void* g_, void* y_, int rows, int d,
           long long sx, float eps, int route, int sms, void* stream) {
  const T* x = static_cast<const T*>(x_);
  const T* g = static_cast<const T*>(g_);
  T* y = static_cast<T*>(y_);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int E = 16 / sizeof(T);
  const int nvec = d / E;
  // the vector routes' widths, as the wrapper's route() reckons them
  if (sms < 1 || (route != SCALAR && (d % E != 0 || sx % E != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == WARP) {
    if (nvec <= 1)
      launch_warp<T, 1, 1>(x, g, y, rows, d, sx, eps, sms, st);
    else if (nvec <= 2)
      launch_warp<T, 2, 1>(x, g, y, rows, d, sx, eps, sms, st);
    else if (nvec <= 4)
      launch_warp<T, 4, 1>(x, g, y, rows, d, sx, eps, sms, st);
    else if (nvec <= 8)
      launch_warp<T, 8, 1>(x, g, y, rows, d, sx, eps, sms, st);
    else if (nvec <= 16)
      launch_warp<T, 16, 1>(x, g, y, rows, d, sx, eps, sms, st);
    else if (nvec <= 32)
      launch_warp<T, 32, 1>(x, g, y, rows, d, sx, eps, sms, st);
    else if (nvec <= 64)
      launch_warp<T, 32, 2>(x, g, y, rows, d, sx, eps, sms, st);
    else if (nvec <= 128)
      launch_warp<T, 32, 4>(x, g, y, rows, d, sx, eps, sms, st);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else if (route == BLOCK) {
    // VPT vectors a thread, the fewest that keep a row within 128 threads
    // (up to 8, then up to 512 threads): a thread has several loads in
    // flight, and 16 blocks fit an SM
    if (nvec <= 128) launch_block<T, 1>(x, g, y, rows, d, sx, eps, st);
    else if (nvec <= 256) launch_block<T, 2>(x, g, y, rows, d, sx, eps, st);
    else if (nvec <= 512) launch_block<T, 4>(x, g, y, rows, d, sx, eps, st);
    else if (nvec <= 4096) launch_block<T, 8>(x, g, y, rows, d, sx, eps, st);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else if (route == SCALAR) {
    rms_scalar_kernel<T><<<rows, THREADS, 0, st>>>(x, g, y, d, sx, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes.  x rows are sx elements apart with
// unit column stride; y is contiguous (rows, d); g is null or (d,).
// `route` is 0 warp, 1 block, 2 scalar; the vector routes need d, sx and
// the bases of x and g in 16-byte units.  `sms` is the card's SM count,
// which caps the warp route's grid.
extern "C" int repro_rmsnorm_f32(const void* x, const void* g, void* y,
                                 int rows, int d, long long sx, float eps,
                                 int route, int sms, void* stream) {
  return launch<float>(x, g, y, rows, d, sx, eps, route, sms, stream);
}

extern "C" int repro_rmsnorm_bf16(const void* x, const void* g, void* y,
                                  int rows, int d, long long sx, float eps,
                                  int route, int sms, void* stream) {
  return launch<__nv_bfloat16>(x, g, y, rows, d, sx, eps, route, sms,
                               stream);
}
