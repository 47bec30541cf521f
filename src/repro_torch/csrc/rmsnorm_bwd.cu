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
// bytes; g and dg are one row each.  The floor at the training path's
// shape (4096 x 2048 bf16) is ~50 MB at 3.35 TB/s, 15 us.
//
// Design: two launches, no floating-point atomics, so two calls give the
// same bits.
//   rms_bwd_kernel: `blocks` blocks, each taking a contiguous run of rows
//     in order.  A block has as many threads as cover the row with CPT
//     columns a thread (columns tid + k * threads: neighbouring threads
//     read neighbouring elements); it keeps g and its columns' partial dg
//     in registers and loads the next row's x and dy while it reduces
//     this one.  A row's two sums (x^2 and dy*g*x) are one reduction:
//     warp shuffles, then the warps' partials summed in warp order by
//     every thread.  At the end each block writes its partial dg row into
//     an fp32 workspace (blocks x d).
//   rms_bwd_dg_kernel: dg[c] = the workspace's column c summed over the
//     blocks in a fixed order: 32 columns a block, its 32 warps taking the
//     partial rows w, w + 32, ... in order, then warp 0 adding the 32 warp
//     sums in order.
// A null g means no gain (g = 1): no workspace, no second launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int SUM_WARPS = 32;

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
__global__ void __launch_bounds__(MAX_THREADS)
rms_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
               const T* __restrict__ dy, T* __restrict__ dx,
               float* __restrict__ ws, int rows, int d, int rows_per_block,
               float eps) {
  __shared__ float2 warp_sums[2][MAX_THREADS / 32];
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
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(static_cast<long long>(rows), r0 + rows_per_block);
  float xv[CPT], dv[CPT];
  if (r0 < r1) {
    load_cols<T, CPT>(x + r0 * d, tid, nt, d, xv);
    load_cols<T, CPT>(dy + r0 * d, tid, nt, d, dv);
  }
  const float inv_d = 1.f / static_cast<float>(d);
  for (long long row = r0; row < r1; ++row) {
    // the next row's loads are in flight during this row's reduction
    float xn[CPT], dn[CPT];
    if (row + 1 < r1) {
      load_cols<T, CPT>(x + (row + 1) * d, tid, nt, d, xn);
      load_cols<T, CPT>(dy + (row + 1) * d, tid, nt, d, dn);
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
    // alternate buffers: a row's reads finish before the row after next
    // writes the same buffer (one barrier a row)
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
        dxr[col] = from_f32<T>(r * dv[c] * gv[c] - xv[c] * coef);
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
  if (ws != nullptr) {
    float* wr = ws + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tid + nt * c;
      if (col < d) wr[col] = acc[c];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(SUM_WARPS * 32)
rms_bwd_dg_kernel(const float* __restrict__ ws, T* __restrict__ dg,
                  int blocks, int d) {
  __shared__ float part[SUM_WARPS][33];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < d) {
#pragma unroll 4
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

// the fewest columns a thread (a power of two) that keep a row within
// MAX_THREADS threads; threads a whole number of warps
template <typename T, int CPT>
int launch_rows(const T* x, const T* g, const T* dy, T* dx, float* ws,
                int rows, int d, int blocks, float eps, cudaStream_t st) {
  const int threads = ((d + CPT - 1) / CPT + 31) / 32 * 32;
  const int rpb = (rows + blocks - 1) / blocks;
  rms_bwd_kernel<T, CPT><<<blocks, threads, 0, st>>>(x, g, dy, dx, ws, rows,
                                                     d, rpb, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x_, const void* g_, const void* dy_, void* dx_,
           void* ws, int rows, int d, int blocks, float eps, void* stream) {
  const T* x = static_cast<const T*>(x_);
  const T* g = static_cast<const T*>(g_);
  const T* dy = static_cast<const T*>(dy_);
  T* dx = static_cast<T*>(dx_);
  float* w = static_cast<float*>(ws);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 1 || blocks < 1 || blocks > rows ||
      (g != nullptr) != (w != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (d + MAX_THREADS - 1) / MAX_THREADS;
  if (per <= 1) return launch_rows<T, 1>(x, g, dy, dx, w, rows, d, blocks, eps, st);
  if (per <= 2) return launch_rows<T, 2>(x, g, dy, dx, w, rows, d, blocks, eps, st);
  if (per <= 4) return launch_rows<T, 4>(x, g, dy, dx, w, rows, d, blocks, eps, st);
  if (per <= 8) return launch_rows<T, 8>(x, g, dy, dx, w, rows, d, blocks, eps, st);
  if (per <= 16) return launch_rows<T, 16>(x, g, dy, dx, w, rows, d, blocks, eps, st);
  if (per <= 32) return launch_rows<T, 32>(x, g, dy, dx, w, rows, d, blocks, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);   // d > 8192
}

template <typename T>
int launch_dg(const void* ws, void* dg, int blocks, int d, void* stream) {
  if (blocks < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  rms_bwd_dg_kernel<T><<<(d + 31) / 32, SUM_WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<T*>(dg), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes.  x, dy and dx are contiguous (rows,
// d); g is null or (d,).  The first pair launches rms_bwd_kernel with
// `blocks` blocks (1 <= blocks <= rows), writing dx and, when g is not
// null, each block's partial dg into ws (fp32, blocks x d); ws is null
// exactly when g is.  The second pair sums ws over the blocks into dg
// (d,) in g's dtype.  d is at most 8192.  Each returns cudaGetLastError()
// after its launch, or the error that kept it from launching.
extern "C" int repro_rmsnorm_bwd_f32(const void* x, const void* g,
                                     const void* dy, void* dx, void* ws,
                                     int rows, int d, int blocks, float eps,
                                     void* stream) {
  return launch<float>(x, g, dy, dx, ws, rows, d, blocks, eps, stream);
}

extern "C" int repro_rmsnorm_bwd_bf16(const void* x, const void* g,
                                      const void* dy, void* dx, void* ws,
                                      int rows, int d, int blocks, float eps,
                                      void* stream) {
  return launch<__nv_bfloat16>(x, g, dy, dx, ws, rows, d, blocks, eps,
                               stream);
}

extern "C" int repro_rmsnorm_bwd_dg_f32(const void* ws, void* dg, int blocks,
                                        int d, void* stream) {
  return launch_dg<float>(ws, dg, blocks, d, stream);
}

extern "C" int repro_rmsnorm_bwd_dg_bf16(const void* ws, void* dg,
                                         int blocks, int d, void* stream) {
  return launch_dg<__nv_bfloat16>(ws, dg, blocks, d, stream);
}
