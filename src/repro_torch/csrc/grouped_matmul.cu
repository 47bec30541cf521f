// Grouped (per-expert) GEMM for Hopper (sm_90a): out[e] = x[e] @ w[e] for
// every expert e, x (E,C,D) and w (E,D,F) in fp32 or bf16, an fp32
// accumulator, out (E,C,F) in x's dtype.  The MoE layer's capacity-padded
// dispatch: C rows per expert (a multiple of 8, most of them the zero pad
// row at decode), the expert weights read once each.
//
// Replaces: src/repro/kernels/grouped_matmul/grouped_matmul.py,
// grouped_matmul_pallas (an (E, C/bc, F/bf, D/bd) grid with the
// contraction innermost, accumulating into an fp32 VMEM tile; it asserts
// that the 128-row block divides C, which the serving shapes break).
//
// What bounds it on an H100: at decode (C = 8) the weight read, every
// expert's D x F matrix once, at the 3.35 TB/s memory rate; at prefill
// (C = 160-648 for olmoe) the products, which run here as plain fp32 FMAs
// on the 67 TFLOP/s SIMT units (tensor cores, TMA and skipping experts
// that received no token are later work).
//
// Design: the expert rides grid axis z and the row tiles grid axis x, so
// the blocks that share one expert's weight column tile run next to each
// other and the tile is read from device memory about once.  One block
// per BM x 64 output tile: BM = 64 rows with 256 threads in general, BM =
// 16 rows with 64 threads when C <= 16 (decode), so a decode step does not
// multiply 56 pad rows per expert.  The contraction walks in BK-wide steps
// through two shared tiles held in fp32; each thread keeps a 4x4 register
// tile and reads its 4 rows and 4 columns with one 16-byte shared load
// each per k.  The next step's operands are loaded into registers, in
// their own type and all at once, while the current step's FMAs run; they
// are converted to fp32 as they are stored to the shared tiles.  x and w are
// read through their (expert, row, column) strides; the ragged edges of C,
// D and F are masked, so no dimension needs to be a multiple of a tile.
// Each output is one thread's FMA chain in a fixed order: no split-K and
// no atomics, so the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;                       // output columns per block
constexpr int TM = 4;                        // rows per thread
constexpr int TN = 4;                        // columns per thread
constexpr int CS = BN / TN;                  // threads across a row (16)

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
__device__ __forceinline__ T zero() { return from_f32<T>(0.f); }

template <int BM, int BK>
struct Tile {
  static constexpr int THREADS = (BM / TM) * CS;
  static constexpr int X_LOADS = BM * BK / THREADS;   // per thread, per step
  static constexpr int W_LOADS = BK * BN / THREADS;
};

// Global -> registers for the step at k0, in the operands' own type: the
// conversion to fp32 waits for the load, so it happens at the shared
// store of the next step, after this step's FMAs, and the loads stay in
// flight meanwhile.  Consecutive threads walk the contraction along a row
// of x, and the columns along a row of w.
template <typename T, int BM, int BK>
__device__ __forceinline__ void load_step(
    const T* __restrict__ x, const T* __restrict__ w, int tid, int row0,
    int col0, int k0, int C, int D, int F, long long sxc, long long sxd,
    long long swd, long long swf, T (&rx)[Tile<BM, BK>::X_LOADS],
    T (&rw)[Tile<BM, BK>::W_LOADS]) {
  using Tl = Tile<BM, BK>;
#pragma unroll
  for (int r = 0; r < Tl::X_LOADS; ++r) {
    const int i = tid + r * Tl::THREADS;
    const int gc = row0 + i / BK, gd = k0 + i % BK;
    rx[r] = (gc < C && gd < D) ? x[gc * sxc + gd * sxd] : zero<T>();
  }
#pragma unroll
  for (int r = 0; r < Tl::W_LOADS; ++r) {
    const int i = tid + r * Tl::THREADS;
    const int gd = k0 + i / BN, gf = col0 + i % BN;
    rw[r] = (gd < D && gf < F) ? w[gd * swd + gf * swf] : zero<T>();
  }
}

template <typename T, int BM, int BK>
__global__ void __launch_bounds__(Tile<BM, BK>::THREADS)
grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int C, int D, int F,
                    long long sxe, long long sxc, long long sxd,
                    long long swe, long long swd, long long swf) {
  using Tl = Tile<BM, BK>;
  // x tile k-major; rows padded by 4 floats so they stay 16-byte aligned
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % CS;
  const int ty = tid / CS;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const long long e = blockIdx.z;
  x += e * sxe;
  w += e * swe;
  out += e * static_cast<long long>(C) * F;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  T rx[Tl::X_LOADS], rw[Tl::W_LOADS];
  load_step<T, BM, BK>(x, w, tid, row0, col0, 0, C, D, F, sxc, sxd, swd, swf,
                       rx, rw);
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int r = 0; r < Tl::X_LOADS; ++r) {
      const int i = tid + r * Tl::THREADS;
      xs[i % BK][i / BK] = to_f32(rx[r]);
    }
#pragma unroll
    for (int r = 0; r < Tl::W_LOADS; ++r) {
      const int i = tid + r * Tl::THREADS;
      ws[i / BN][i % BN] = to_f32(rw[r]);
    }
    __syncthreads();
    // the next step's loads are in flight while this step's FMAs run
    if (k0 + BK < D)
      load_step<T, BM, BK>(x, w, tid, row0, col0, k0 + BK, C, D, F, sxc, sxd,
                           swd, swf, rx, rw);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 x4 = *reinterpret_cast<const float4*>(&xs[k][ty * TM]);
      const float4 w4 = *reinterpret_cast<const float4*>(&ws[k][tx * TN]);
      const float xv[TM] = {x4.x, x4.y, x4.z, x4.w};
      const float wv[TN] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gc = row0 + ty * TM + i;
    if (gc >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gf = col0 + tx * TN + j;
      if (gf < F)
        out[static_cast<long long>(gc) * F + gf] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BK>
void launch_tile(const void* x, const void* w, void* out, int E, int C, int D,
                 int F, long long sxe, long long sxc, long long sxd,
                 long long swe, long long swd, long long swf,
                 cudaStream_t stream) {
  const dim3 grid((C + BM - 1) / BM, (F + BN - 1) / BN, E);
  grouped_gemm_kernel<T, BM, BK>
      <<<grid, Tile<BM, BK>::THREADS, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<T*>(out), C, D, F, sxe, sxc, sxd, swe, swd, swf);
}

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, long long sxe, long long sxc, long long sxd, long long swe,
           long long swd, long long swf, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (C <= 16)
    launch_tile<T, 16, 32>(x, w, out, E, C, D, F, sxe, sxc, sxd, swe, swd,
                           swf, s);
  else
    launch_tile<T, 64, 64>(x, w, out, E, C, D, F, sxe, sxc, sxd, swe, swd,
                           swf, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements: (expert,
// row, column) of x, then of w; out is a contiguous (E,C,F) tensor of x's
// dtype.  Each returns cudaGetLastError() after launch.
extern "C" int repro_grouped_matmul_f32(const void* x, const void* w,
                                        void* out, int E, int C, int D, int F,
                                        long long sxe, long long sxc,
                                        long long sxd, long long swe,
                                        long long swd, long long swf,
                                        void* stream) {
  return launch<float>(x, w, out, E, C, D, F, sxe, sxc, sxd, swe, swd, swf,
                       stream);
}

extern "C" int repro_grouped_matmul_bf16(const void* x, const void* w,
                                         void* out, int E, int C, int D,
                                         int F, long long sxe, long long sxc,
                                         long long sxd, long long swe,
                                         long long swd, long long swf,
                                         void* stream) {
  return launch<__nv_bfloat16>(x, w, out, E, C, D, F, sxe, sxc, sxd, swe,
                               swd, swf, stream);
}
