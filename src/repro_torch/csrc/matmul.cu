// Tiled GEMM for Hopper (sm_90a): C[b] = A[b] @ B[b], fp32 accumulator,
// output in the operands' dtype (fp32 or bf16).
//
// Replaces: src/repro/kernels/matmul/matmul.py, matmul_pallas (the Pallas
// TPU kernel with K innermost accumulating into an fp32 VMEM tile).
//
// What bounds it on an H100: the runtime's operands are fp32 and its
// contract is 1e-4 against whole-graph evaluation, so the products run as
// plain fp32 FMAs (no TF32, no tensor cores): the ceiling is the 67 TFLOP/s
// fp32 SIMT rate at prefill (M = 64) and the 3.35 TB/s memory rate for the
// weight read at decode (M = 1), where every weight byte is used once.
//
// Design: one 256-thread block per 64x64 output tile; K walks in steps of
// 64 through two shared-memory tiles that are converted to fp32 on load;
// each thread keeps a contiguous 4x4 register tile and reads its 4 rows of
// A and 4 columns of B with one 16-byte shared load each per k, so the
// FMAs, not shared-memory bandwidth, set the pace.  A block has few siblings on the card at these
// shapes (20 blocks at N = 1280), so it hides device-memory latency itself:
// the next K step's operands are loaded into registers, all at once, while
// the current step's FMAs run.  Every operand is read through its own strides
// (batch, row, column): the runtime's column slice of a weight (a neuron
// tile) and the transposed kT of batch_matmul are passed as views, never
// copied.  Ragged M/N/K edges are masked, so M = 1 and N = 48 need no
// padding.  Each output is one thread's FMA chain in a fixed K order: no
// split-K and no atomics, so the result is deterministic and the
// multi-tenant executor's bitwise invariance holds.  wgmma/TMA pipelines
// and an M = 1 GEMV path are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int CS = BN / TN;                  // threads across a row (16)
constexpr int THREADS = (BM / TM) * CS;      // 256
constexpr int A_LOADS = BM * BK / THREADS;   // per thread, per K step (16)
constexpr int B_LOADS = BK * BN / THREADS;   // (16)

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

// Global -> registers for the K step at k0.  The trip counts are
// compile-time constants, so every load of a step is issued before any is
// waited on.  Consecutive threads walk k along a row of A, and n along a
// row of B: contiguous for row-major operands.
template <typename T>
__device__ __forceinline__ void load_step(
    const T* __restrict__ a, const T* __restrict__ b, int tid, int row0,
    int col0, int k0, int M, int N, int K, long long sam, long long sak,
    long long sbk, long long sbn, float (&ra)[A_LOADS],
    float (&rb)[B_LOADS]) {
#pragma unroll
  for (int r = 0; r < A_LOADS; ++r) {
    const int i = tid + r * THREADS;
    const int gm = row0 + i / BK, gk = k0 + i % BK;
    ra[r] = (gm < M && gk < K) ? to_f32(a[gm * sam + gk * sak]) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < B_LOADS; ++r) {
    const int i = tid + r * THREADS;
    const int gk = k0 + i / BN, gn = col0 + i % BN;
    rb[r] = (gk < K && gn < N) ? to_f32(b[gk * sbk + gn * sbn]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ c, int M, int N, int K,
            long long sab, long long sam, long long sak,
            long long sbb, long long sbk, long long sbn) {
  // A tile k-major; rows padded to 68 floats so they stay 16-byte aligned
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % CS;
  const int ty = tid / CS;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  a += z * sab;
  b += z * sbb;
  c += z * static_cast<long long>(M) * N;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float ra[A_LOADS], rb[B_LOADS];
  load_step(a, b, tid, row0, col0, 0, M, N, K, sam, sak, sbk, sbn, ra, rb);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < A_LOADS; ++r) {
      const int i = tid + r * THREADS;
      as[i % BK][i / BK] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < B_LOADS; ++r) {
      const int i = tid + r * THREADS;
      bs[i / BN][i % BN] = rb[r];
    }
    __syncthreads();
    // the next step's loads are in flight while this step's FMAs run
    if (k0 + BK < K)
      load_step(a, b, tid, row0, col0, k0 + BK, M, N, K, sam, sak, sbk, sbn,
                ra, rb);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      // one 16-byte shared load each for the thread's 4 rows and 4 columns
      const float4 a4 = *reinterpret_cast<const float4*>(&as[k][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[k][tx * TN]);
      const float av[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx * TN + j;
      if (gn < N) c[static_cast<long long>(gm) * N + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int batch, int M, int N,
           int K, long long sab, long long sam, long long sak, long long sbb,
           long long sbk, long long sbn, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  gemm_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K, sab, sam, sak, sbb, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements; C is
// contiguous (batch, M, N).  Each returns cudaGetLastError() after launch.
extern "C" int repro_matmul_f32(const void* a, const void* b, void* c,
                                int batch, int M, int N, int K,
                                long long sab, long long sam, long long sak,
                                long long sbb, long long sbk, long long sbn,
                                void* stream) {
  return launch<float>(a, b, c, batch, M, N, K, sab, sam, sak, sbb, sbk, sbn,
                       stream);
}

extern "C" int repro_matmul_bf16(const void* a, const void* b, void* c,
                                 int batch, int M, int N, int K,
                                 long long sab, long long sam, long long sak,
                                 long long sbb, long long sbk, long long sbn,
                                 void* stream) {
  return launch<__nv_bfloat16>(a, b, c, batch, M, N, K, sab, sam, sak, sbb,
                               sbk, sbn, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
