// Backward of the fused row RMSNorm for Hopper (sm_90a).  For
//   y = x * r * g,  r = rsqrt(mean(x^2) + eps)
// over rows of width d, given dy:
//   dx = r * (dy * g) - x * r^3 * mean(dy * g * x)      (per row)
//   dg = sum over rows of dy * x * r                    (per column)
// in fp32 arithmetic, dx written in x's dtype and dg in g's.
//
// Backward of: src/repro/kernels/rmsnorm/rmsnorm.py, rmsnorm_pallas.  The
// JAX package has no backward kernel (no custom_vjp): it trains by
// differentiating its jnp reference.  The port's forward runs the CUDA
// kernel of csrc/rmsnorm.cu, so its gradient is this kernel, reached
// through the torch.autograd.Function in kernels/rmsnorm/rmsnorm.py.
//
// What bounds it on an H100: bytes.  Per element it reads x and dy and
// writes dx, some ten operations against six (bf16) to twelve (fp32)
// bytes; g and dg are one row each.  The floor at 3.35 TB/s: 0.0150 ms at
// the training path's 4096 x 2048 bf16, 0.0188 at rwkv6-3b's ln_x
// (163840 x 64), 0.0300 at qwen3's q-norm width (131072 x 128), 0.0188 at
// recurrentgemma-2b's 4096 x 2560.  Reaching it takes ~2-3 MB of loads in
// flight over the card (Little's law at ~700 ns), ~20 KB an SM.
//
// Design: three routes, picked by the wrapper from the dtype, the width,
// the row strides and the data pointers (kernels/rmsnorm/rmsnorm.py,
// route_bwd()), never from the row count; the grid (grid_bwd() there) is
// a function of the rows, the width, the route and the SM count alone,
// every block resident at once, so the order of dg's sum is fixed.
//   warp   (16-byte vectors, rows of at most 128 vectors: 1024 bf16, 512
//          fp32): G lanes a row (the power of two that covers its
//          vectors, at most 32), VPT = 1, 2 or 4 vectors a lane, 32 / G
//          rows a warp, two such row sets loaded together where VPT is 1;
//          8 warps a block, 4 / VPT blocks an SM, the warps walking row
//          groups grid-stride, so no two warps differ by more than one
//          group.  x and dy come as 16-byte vectors, 64-128 bytes a lane
//          in flight (32-64 KB an SM); a row's two sums (x^2 and dy*g*x)
//          are one butterfly of shuffles over its G lanes: no shared
//          memory, no __syncthreads.  Each lane keeps its columns' partial
//          dg in registers over all its warp's rows.
//   block  (16-byte vectors, wider rows up to 8192): each block takes a
//          balanced contiguous run of rows (runs differ by at most one
//          row).  A thread owns vectors tid + threads * v (v < VPT, VPT 2,
//          4 or 8, the fewest that keep a row within 128 threads, up to
//          256 at 8192 fp32).  A ring of `stages` row slots in shared
//          memory (x's row, then dy's) keeps the next stages - 1 rows in
//          flight by cp.async, stages = 1 + ceil(24 KB / row bytes) within
//          [2, 8]: 24-32 KB a block, against ~1 row of the kernel before;
//          up to 4 blocks an SM, as the ring and the registers allow.  A
//          thread copies exactly the vectors it reads, so its own
//          cp.async.wait_group is all that guards the ring; one cross-warp
//          reduction a row, through double-buffered shared memory (one
//          __syncthreads).  A thread keeps its columns' partial dg in
//          registers.
//   scalar (what 16-byte vectors cannot read: a width or row stride not a
//          multiple of 16 bytes, a misaligned base): the kernel before
//          the routes, element loads, CPT columns a thread (neighbouring
//          threads on neighbouring elements) with the next row's loads in
//          flight; 2 blocks an SM, balanced contiguous runs of rows.
// dg: each block reduces its lanes' and warps' partials in a fixed order
// (shuffle butterflies, then the warps in order through shared memory) and
// writes one fp32 partial row of a workspace (blocks x d); a second
// launch, rms_bwd_dg_kernel, sums the partial rows in block order.  It is
// a programmatic dependent launch: the row kernel's blocks release it
// once past their rows, so its launch overlaps their tail, and it waits
// (griddepcontrol.wait) for the row kernel to complete before reading.
// No floating-point atomics: two calls give the same bits.  A null g
// means no gain (g = 1): no workspace, no second launch.
//
// Estimated before the first chip call (H100 SXM at 700 W, cold L2, both
// launches): 4096 x 2048 bf16 0.021-0.026 ms (target <= 0.030, floor <=
// 0.040 and faster than F.rms_norm's backward); 163840 x 64 bf16
// 0.024-0.030 (target <= 0.038); 131072 x 128 bf16 0.036-0.042 (target
// <= 0.060); 4096 x 2560 bf16 0.024-0.029 (target <= 0.038); 256 x 2048
// fp32, one row a block, latency-bound: 0.008-0.011 (the kernel before:
// 0.0119-0.0127).  The row kernels at 2.7-3.0 TB/s, plus ~2-4 us for the
// dg sum's launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int WARP_THREADS = 256;          // warp route: 8 warps a block
constexpr int WARP_WARPS = WARP_THREADS / 32;
constexpr int WARP_MAX_VECS = 128;
constexpr int BLOCK_MAX_THREADS = 256;
constexpr int RING_BYTES = 24 * 1024;      // block route: bytes in flight
constexpr int MAX_STAGES = 8;
constexpr int MAX_WIDTH = 8192;
constexpr int SCALAR_THREADS = 256;        // at most, a row a block
constexpr int SUM_WARPS = 32;
constexpr int MAX_DEVICES = 16;

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
    // a bf16 is the high half of the fp32 of the same value
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
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

// g's vector `idx`, or 16 bytes of 1.0 without a gain
template <typename T>
__device__ __forceinline__ uint4 gain_vec(const T* __restrict__ g, int idx) {
  if (g != nullptr) return __ldg(reinterpret_cast<const uint4*>(g) + idx);
  const uint32_t one = sizeof(T) == 4 ? 0x3f800000u : 0x3f803f80u;
  return make_uint4(one, one, one, one);
}

// Programmatic dependent launch (Hopper): a row kernel lets dg's sum be
// launched once every block is past its rows; the sum waits for the row
// kernel to complete, and its writes to be visible, before it reads them
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// One row's part in a thread: the sums x^2 and dy*g*x over its vectors
template <int E>
__device__ __forceinline__ void row_sums(const uint4& xu, const uint4& du,
                                         const uint4& gu, float& ss,
                                         float& sd) {
  float xv[E], dv[E], gv[E];
  unpack(xu, xv);
  unpack(du, dv);
  unpack(gu, gv);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    ss = fmaf(xv[e], xv[e], ss);
    sd = fmaf(dv[e] * gv[e], xv[e], sd);
  }
}

// dx = r dy g - x coef for one vector, and its dy x r into acc
template <int E>
__device__ __forceinline__ uint4 row_grad(const uint4& xu, const uint4& du,
                                          const uint4& gu, float r,
                                          float coef, float (&acc)[E]) {
  float xv[E], dv[E], gv[E], o[E];
  unpack(xu, xv);
  unpack(du, dv);
  unpack(gu, gv);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    o[e] = r * (dv[e] * gv[e]) - xv[e] * coef;
    acc[e] = fmaf(dv[e] * xv[e], r, acc[e]);
  }
  return pack(o);
}

// ------------------------------------------------------------------ warp

template <typename T, int G, int VPT>
__global__ void __launch_bounds__(WARP_THREADS, 4 / VPT)
rms_bwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const T* __restrict__ dy, T* __restrict__ dx,
                    float* __restrict__ ws, long long rows, int d,
                    long long sx, long long sdy, float eps) {
  constexpr int E = 16 / sizeof(T);
  constexpr int RPW = 32 / G;               // rows a warp takes at once
  constexpr int R = VPT == 1 ? 2 : 1;       // ... R times: a row group
  constexpr int GROUP = RPW * R;
  const int nvec = d / E;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int sub = lane % G;                 // the lane's vectors sub + G v
  const int slot = lane / G;                // its row among the RPW
  const float inv_d = 1.f / static_cast<float>(d);
  uint4 gu[VPT];
  float acc[VPT][E];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int idx = sub + G * v;
    gu[v] = idx < nvec ? gain_vec(g, idx) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[v][e] = 0.f;
  }
  const long long groups = (rows + GROUP - 1) / GROUP;
  const long long nwarps = static_cast<long long>(gridDim.x) * WARP_WARPS;
  // the loop runs alike in every lane of a warp, so the shuffles see all
  // 32 lanes; rows past the end load zeros and store nothing
  for (long long grp = static_cast<long long>(blockIdx.x) * WARP_WARPS +
                       warp;
       grp < groups; grp += nwarps) {
    uint4 xu[R][VPT], du[R][VPT];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = grp * GROUP + r * RPW + slot;
      const uint4* xr = reinterpret_cast<const uint4*>(x + row * sx);
      const uint4* dr = reinterpret_cast<const uint4*>(dy + row * sdy);
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const int idx = sub + G * v;
        const bool ok = row < rows && idx < nvec;
        xu[r][v] = ok ? __ldg(xr + idx) : make_uint4(0, 0, 0, 0);
        du[r][v] = ok ? __ldg(dr + idx) : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float ss = 0.f, sd = 0.f;
#pragma unroll
      for (int v = 0; v < VPT; ++v)
        row_sums<E>(xu[r][v], du[r][v], gu[v], ss, sd);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
        sd += __shfl_xor_sync(0xffffffffu, sd, off);
      }
      const float rs = rsqrtf(ss * inv_d + eps);
      const float coef = rs * rs * rs * sd * inv_d;
      const long long row = grp * GROUP + r * RPW + slot;
      if (row < rows) {
        uint4* out = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          const int idx = sub + G * v;
          if (idx < nvec)
            out[idx] = row_grad<E>(xu[r][v], du[r][v], gu[v], rs, coef,
                                   acc[v]);
        }
      }
    }
  }
  launch_dependents();
  if (ws == nullptr) return;                // uniform: no gain, no dg
  // the warp's RPW row slots: a butterfly over the lane bits above G's
#pragma unroll
  for (int off = 16; off >= G; off >>= 1) {
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[v][e] += __shfl_xor_sync(0xffffffffu, acc[v][e], off);
    }
  }
  // then the warps in order, through shared memory (WARP_WARPS x d)
  extern __shared__ float part[];
  if (slot == 0) {
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int idx = sub + G * v;
      if (idx < nvec) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          part[warp * d + idx * E + e] = acc[v][e];
      }
    }
  }
  __syncthreads();
  float* wr = ws + static_cast<long long>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += WARP_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARP_WARPS; ++w) s += part[w * d + c];
    wr[c] = s;
  }
}

// ----------------------------------------------------------------- block

// waits until at most n (< MAX_STAGES) of this thread's committed
// cp.async groups are in flight; the clobber keeps the ring's reads after
// it
__device__ __forceinline__ void wait_groups(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

template <typename T, int VPT>
__global__ void __launch_bounds__(BLOCK_MAX_THREADS, VPT == 8 ? 1 : 2)
rms_bwd_block_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ ws, long long rows, int d,
                     long long sx, long long sdy, int stages, float eps) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ uint4 ring[];           // stages x (x's row, dy's row)
  __shared__ float2 warp_sums[2][BLOCK_MAX_THREADS / 32];
  const int nvec = d / E;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warps = nt / 32;
  const float inv_d = 1.f / static_cast<float>(d);
  // a balanced contiguous run of rows
  const long long r0 = rows * blockIdx.x / gridDim.x;
  const long long r1 = rows * (blockIdx.x + 1) / gridDim.x;
  uint4 gu[VPT];
  float acc[VPT][E];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int idx = tid + nt * v;
    gu[v] = idx < nvec ? gain_vec(g, idx) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[v][e] = 0.f;
  }
  // row `row` into its slot: this thread's vectors of x, then of dy
  auto fill = [&](long long row) {
    uint4* s = ring + ((row - r0) % stages) * 2 * nvec;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * sx);
    const uint4* dr = reinterpret_cast<const uint4*>(dy + row * sdy);
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int idx = tid + nt * v;
      if (idx < nvec) {
        hopper::cp_async16(s + idx, xr + idx, 16);
        hopper::cp_async16(s + nvec + idx, dr + idx, 16);
      }
    }
  };
  // one group a row, empty past the run, so that stages - 1 groups stay
  // committed ahead of the row being reduced
  for (int k = 0; k < stages - 1; ++k) {
    if (r0 + k < r1) fill(r0 + k);
    hopper::cp_async_commit();
  }
  for (long long row = r0; row < r1; ++row) {
    // this thread's reads of the slot refilled here were the row before's
    asm volatile("" ::: "memory");
    if (row + stages - 1 < r1) fill(row + stages - 1);
    hopper::cp_async_commit();
    wait_groups(stages - 1);                // this row's group has landed
    const uint4* xs = ring + ((row - r0) % stages) * 2 * nvec;
    const uint4* ds = xs + nvec;
    float ss = 0.f, sd = 0.f;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int idx = tid + nt * v;
      if (idx < nvec) row_sums<E>(xs[idx], ds[idx], gu[v], ss, sd);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sd += __shfl_xor_sync(0xffffffffu, sd, off);
    }
    // alternate buffers: a row's reads finish before the row after next
    // writes the same buffer (one barrier a row)
    float2* sums = warp_sums[row & 1];
    if (tid % 32 == 0) sums[tid / 32] = make_float2(ss, sd);
    __syncthreads();
    float tss = 0.f, tsd = 0.f;             // every thread, the same order
    for (int w = 0; w < warps; ++w) {
      tss += sums[w].x;
      tsd += sums[w].y;
    }
    const float rs = rsqrtf(tss * inv_d + eps);
    const float coef = rs * rs * rs * tsd * inv_d;
    uint4* out = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int idx = tid + nt * v;
      if (idx < nvec)
        out[idx] = row_grad<E>(xs[idx], ds[idx], gu[v], rs, coef, acc[v]);
    }
  }
  hopper::cp_async_wait<0>();               // nothing in flight at exit
  launch_dependents();
  if (ws == nullptr) return;
  float4* wr = reinterpret_cast<float4*>(ws + static_cast<long long>(
                                                  blockIdx.x) * d);
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int idx = tid + nt * v;
    if (idx < nvec) {
#pragma unroll
      for (int k = 0; k < E / 4; ++k)
        wr[idx * (E / 4) + k] = make_float4(acc[v][4 * k], acc[v][4 * k + 1],
                                            acc[v][4 * k + 2],
                                            acc[v][4 * k + 3]);
    }
  }
}

// ---------------------------------------------------------------- scalar

template <typename T, int CPT>
__device__ __forceinline__ void load_cols(const T* __restrict__ row, int tid,
                                          int nt, int d, float (&v)[CPT]) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = tid + nt * c;
    v[c] = col < d ? to_f32(row[col]) : 0.f;
  }
}

template <typename T, int CPT>
__global__ void __launch_bounds__(SCALAR_THREADS)
rms_bwd_scalar_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ ws, long long rows, int d,
                      long long sx, long long sdy, float eps) {
  __shared__ float2 warp_sums[2][SCALAR_THREADS / 32];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid % 32;
  const int warps = nt / 32;
  float gv[CPT], acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = tid + nt * c;
    gv[c] = (g != nullptr && col < d) ? to_f32(g[col]) : 1.f;
    acc[c] = 0.f;
  }
  const long long r0 = rows * blockIdx.x / gridDim.x;
  const long long r1 = rows * (blockIdx.x + 1) / gridDim.x;
  float xv[CPT], dv[CPT];
  if (r0 < r1) {
    load_cols<T, CPT>(x + r0 * sx, tid, nt, d, xv);
    load_cols<T, CPT>(dy + r0 * sdy, tid, nt, d, dv);
  }
  const float inv_d = 1.f / static_cast<float>(d);
  for (long long row = r0; row < r1; ++row) {
    // the next row's loads are in flight during this row's reduction
    float xn[CPT], dn[CPT];
    if (row + 1 < r1) {
      load_cols<T, CPT>(x + (row + 1) * sx, tid, nt, d, xn);
      load_cols<T, CPT>(dy + (row + 1) * sdy, tid, nt, d, dn);
    }
    float ss = 0.f, sd = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      ss = fmaf(xv[c], xv[c], ss);
      sd = fmaf(dv[c] * gv[c], xv[c], sd);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sd += __shfl_xor_sync(0xffffffffu, sd, off);
    }
    float2* sums = warp_sums[row & 1];
    if (lane == 0) sums[tid / 32] = make_float2(ss, sd);
    __syncthreads();
    float tss = 0.f, tsd = 0.f;
    for (int w = 0; w < warps; ++w) {
      tss += sums[w].x;
      tsd += sums[w].y;
    }
    const float r = rsqrtf(tss * inv_d + eps);
    const float coef = r * r * r * tsd * inv_d;
    T* dxr = dx + row * d;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tid + nt * c;
      if (col < d) {
        dxr[col] = from_f32<T>(r * (dv[c] * gv[c]) - xv[c] * coef);
        acc[c] = fmaf(dv[c] * xv[c], r, acc[c]);
      }
    }
    if (row + 1 < r1) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        xv[c] = xn[c];
        dv[c] = dn[c];
      }
    }
  }
  launch_dependents();
  if (ws != nullptr) {
    float* wr = ws + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tid + nt * c;
      if (col < d) wr[col] = acc[c];
    }
  }
}

// -------------------------------------------------------------- dg's sum

template <typename T>
__global__ void __launch_bounds__(SUM_WARPS * 32)
rms_bwd_dg_kernel(const float* __restrict__ ws, T* __restrict__ dg,
                  int blocks, int d) {
  __shared__ float part[SUM_WARPS][33];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  wait_prerequisites();                     // the row kernel's partials
  float s = 0.f;
  if (col < d) {
#pragma unroll 8
    for (int b = warp; b < blocks; b += SUM_WARPS)
      s += ws[static_cast<long long>(b) * d + col];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = 0.f;
    for (int w = 0; w < SUM_WARPS; ++w) t += part[w][lane];
    dg[col] = from_f32<T>(t);
  }
}

// ---------------------------------------------------------------- launch

enum Route { WARP = 0, BLOCK = 1, SCALAR = 2 };

template <typename T>
struct Args {
  const T* x;
  const T* g;
  const T* dy;
  T* dx;
  float* ws;
  long long rows, sx, sdy;
  int d, blocks;
  float eps;
  cudaStream_t st;
};

template <typename T, int G, int VPT>
int launch_warp(const Args<T>& a) {
  // the warps' partial dg rows, summed in warp order
  const size_t smem =
      a.ws == nullptr ? 0 : sizeof(float) * WARP_WARPS * a.d;
  rms_bwd_warp_kernel<T, G, VPT><<<a.blocks, WARP_THREADS, smem, a.st>>>(
      a.x, a.g, a.dy, a.dx, a.ws, a.rows, a.d, a.sx, a.sdy, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VPT>
int launch_block(const Args<T>& a, int nvec) {
  static bool ready[MAX_DEVICES] = {};
  const int threads = ((nvec + VPT - 1) / VPT + 31) / 32 * 32;
  const int row_bytes = 2 * a.d * static_cast<int>(sizeof(T));
  const int stages = std::min(
      MAX_STAGES, std::max(2, 1 + (RING_BYTES + row_bytes - 1) / row_bytes));
  const int smem = stages * row_bytes;
  // the most any width takes (two slots of 8192 fp32 rows), opted into
  // once per device
  constexpr int MAX_SMEM = 2 * 2 * MAX_WIDTH * 4;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(rms_bwd_block_kernel<T, VPT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  rms_bwd_block_kernel<T, VPT><<<a.blocks, threads, smem, a.st>>>(
      a.x, a.g, a.dy, a.dx, a.ws, a.rows, a.d, a.sx, a.sdy, stages, a.eps);
  return static_cast<int>(cudaGetLastError());
}

// the fewest columns a thread (a power of two) that keep a row within
// SCALAR_THREADS threads; threads a whole number of warps
template <typename T, int CPT>
int launch_scalar(const Args<T>& a) {
  const int threads = ((a.d + CPT - 1) / CPT + 31) / 32 * 32;
  rms_bwd_scalar_kernel<T, CPT><<<a.blocks, threads, 0, a.st>>>(
      a.x, a.g, a.dy, a.dx, a.ws, a.rows, a.d, a.sx, a.sdy, a.eps);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* x, const void* g, const void* dy, void* dx, void* ws,
           int rows, int d, long long sx, long long sdy, int blocks,
           float eps, int route, void* stream) {
  const Args<T> a{static_cast<const T*>(x), static_cast<const T*>(g),
                  static_cast<const T*>(dy), static_cast<T*>(dx),
                  static_cast<float*>(ws), rows, sx, sdy, d, blocks, eps,
                  static_cast<cudaStream_t>(stream)};
  if (rows < 1 || d < 1 || d > MAX_WIDTH || blocks < 1 || blocks > rows ||
      (g != nullptr) != (ws != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int E = 16 / sizeof(T);
  const int nvec = d / E;
  // the vector routes read 16-byte vectors of x, dy and g and write dx's
  if (route != SCALAR &&
      (d % E != 0 || sx % E != 0 || sdy % E != 0 || !aligned16(x) ||
       !aligned16(dy) || !aligned16(dx) || (g != nullptr && !aligned16(g))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == WARP) {
    if (nvec <= 1) return launch_warp<T, 1, 1>(a);
    if (nvec <= 2) return launch_warp<T, 2, 1>(a);
    if (nvec <= 4) return launch_warp<T, 4, 1>(a);
    if (nvec <= 8) return launch_warp<T, 8, 1>(a);
    if (nvec <= 16) return launch_warp<T, 16, 1>(a);
    if (nvec <= 32) return launch_warp<T, 32, 1>(a);
    if (nvec <= 64) return launch_warp<T, 32, 2>(a);
    if (nvec <= WARP_MAX_VECS) return launch_warp<T, 32, 4>(a);
  } else if (route == BLOCK) {
    // VPT vectors a thread, the fewest that keep a row within 128 threads
    if (nvec <= WARP_MAX_VECS) return static_cast<int>(cudaErrorInvalidValue);
    if (nvec <= 256) return launch_block<T, 2>(a, nvec);
    if (nvec <= 512) return launch_block<T, 4>(a, nvec);
    return launch_block<T, 8>(a, nvec);     // up to 256 threads
  } else if (route == SCALAR) {
    const int per = (d + SCALAR_THREADS - 1) / SCALAR_THREADS;
    if (per <= 1) return launch_scalar<T, 1>(a);
    if (per <= 2) return launch_scalar<T, 2>(a);
    if (per <= 4) return launch_scalar<T, 4>(a);
    if (per <= 8) return launch_scalar<T, 8>(a);
    if (per <= 16) return launch_scalar<T, 16>(a);
    return launch_scalar<T, 32>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// launched as a programmatic dependent of the row kernel before it on the
// stream: its blocks may be resident before the row kernel ends, and wait
template <typename T>
int launch_dg(const void* ws, void* dg, int blocks, int d, void* stream) {
  if (blocks < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d + 31) / 32);
  cfg.blockDim = dim3(SUM_WARPS * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, rms_bwd_dg_kernel<T>,
                         static_cast<const float*>(ws), static_cast<T*>(dg),
                         blocks, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes.  x rows are sx elements apart and dy
// rows sdy apart, both with unit column stride; dx is contiguous (rows,
// d); g is null or (d,).  `route` is 0 warp, 1 block, 2 scalar; the
// vector routes need d, sx, sdy and the bases of x, dy, dx and g in
// 16-byte units, and the warp route at most 128 vectors a row, the block
// route more.  The first pair launches the route's row kernel with
// `blocks` blocks (1 <= blocks <= rows), writing dx and, when g is not
// null, each block's partial dg into ws (fp32, blocks x d); ws is null
// exactly when g is.  The second pair sums ws over the blocks into dg
// (d,) in g's dtype.  d is at most 8192.  Each returns cudaGetLastError()
// after its launch, or the error that kept it from launching.
extern "C" int repro_rmsnorm_bwd_f32(const void* x, const void* g,
                                     const void* dy, void* dx, void* ws,
                                     int rows, int d, long long sx,
                                     long long sdy, int blocks, float eps,
                                     int route, void* stream) {
  return launch<float>(x, g, dy, dx, ws, rows, d, sx, sdy, blocks, eps,
                       route, stream);
}

extern "C" int repro_rmsnorm_bwd_bf16(const void* x, const void* g,
                                      const void* dy, void* dx, void* ws,
                                      int rows, int d, long long sx,
                                      long long sdy, int blocks, float eps,
                                      int route, void* stream) {
  return launch<__nv_bfloat16>(x, g, dy, dx, ws, rows, d, sx, sdy, blocks,
                               eps, route, stream);
}

extern "C" int repro_rmsnorm_bwd_dg_f32(const void* ws, void* dg, int blocks,
                                        int d, void* stream) {
  return launch_dg<float>(ws, dg, blocks, d, stream);
}

extern "C" int repro_rmsnorm_bwd_dg_bf16(const void* ws, void* dg,
                                         int blocks, int d, void* stream) {
  return launch_dg<__nv_bfloat16>(ws, dg, blocks, d, stream);
}
