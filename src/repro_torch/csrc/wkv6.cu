// WKV6 (RWKV6 / Finch) recurrence for Hopper (sm_90a), from a zero state,
// fp32 arithmetic:
//   y_t[j]   = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][:]  = w_t[i] * S[i][:] + k_t[i] * v_t[:]
// r, k, v, w (B,T,H,D) in fp32 or bf16, u (H,D) in fp32 -> y (B,T,H,D) in
// r's dtype and the final state S (B,H,D,D) in fp32.
//
// Replaces: src/repro/kernels/rwkv_scan/rwkv_scan.py, wkv6_pallas (_wkv_kernel:
// a (B*H, T/L) grid whose sequential chunk axis carries the D x D state in
// VMEM and evaluates each 32-token chunk with MXU matmuls after dividing
// k by the cumulative decay).
//
// What bounds it on an H100: operations, and in practice the time chain.
// A step needs at least 5*D*D operations per head (r.S, and S <- w S + k v)
// against 4*D inputs read and D outputs written, about 30 operations per
// byte at D = 64 in bf16, above the card's fp32-rate to memory-rate ratio
// (67 TFLOP/s / 3.35 TB/s = 20).  The steps of one head are a sequential
// chain, which this kernel walks as it is (7 fp32 operations per state
// element per step, no tensor cores), so the chain, not either rate, sets
// its pace.
//
// Design: the recurrent form, as a GPU computes WKV naturally; the TPU's
// chunked-matmul form divides by cumulative decays (k * exp(-logA)), which
// leaves fp32 range once a chunk's summed -log w passes ~88 (w <= 0.05 over
// 32 tokens), so it is not copied.  Value columns j of the state are
// independent: thread (j, p) keeps rows [p*R, p*R + R) of column j in fp32
// registers, and the P = D/R threads of a column are neighbouring lanes
// that add their partial y_j with a fixed butterfly of warp shuffles.  A
// block serves one (column block, head, batch): CB columns, CB*P threads.
// Time walks in chunks of TC steps: r, k, w (all D rows) and v (the block's
// columns) of a chunk are staged in shared memory as fp32; the next chunk's
// values are loaded into registers (in the input dtype, converted only when
// stored) while the current chunk computes, so device-memory latency hides
// behind TC steps of FMAs.  There is no 1/A rescaling, so every decay in
// (0,1] is exact, and any T works (the ragged last chunk is masked).
// r/k/v/w are read through their (batch, time, head) strides with the
// last axis contiguous, so the projections' (B,T,H,D) views go in without
// a transposed copy.  Every sum runs in a fixed order and nothing is
// atomic, so results are deterministic.  D is a template parameter (16,
// 32, 64, 128); other widths are refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TC = 16;             // time steps per staged chunk

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

template <int D>
struct Dims {
  static constexpr int R = D < 16 ? D : 16;        // state rows per thread
  static constexpr int P = D / R;                  // threads per column
  static constexpr int CB = D < 128 / P ? D : 128 / P;   // columns per block
  static constexpr int NCB = D / CB;               // column blocks per head
  static constexpr int THREADS = CB * P;
  // shared row stride: part p's rows start at p*(R+4), so the P parts of
  // a warp read P different banks
  static constexpr int LD = D + 4 * P;
  // staging: r, k, w rows of D values take RP time steps per pass of the
  // block's threads; v rows of CB values take P steps per pass
  static constexpr int RP = THREADS / D;
  static constexpr int NR = TC / RP;               // passes per array
  static constexpr int NV = TC / P;
  static constexpr int LPT = 3 * NR + NV;          // loads per thread
  static_assert(P <= 32 && 32 % P == 0, "a column's parts share a warp");
  static_assert(D % CB == 0, "column blocks tile the head");
  static_assert(THREADS % D == 0 && TC % RP == 0 && TC % P == 0,
                "the staging passes tile a chunk");
};

struct Strides {
  long long v[12];                 // (batch, time, head) of r, k, v, w
};

// One thread's share of a chunk's staging: values ``pre`` in the input
// dtype (the conversion waits for the load, so it happens at the store
// into shared memory), loaded from pointers fixed per thread.  Trip
// counts are compile-time constants, so all loads issue before any is
// used.
template <typename T, int D>
struct Stage {
  using G = Dims<D>;
  const T* p[4];                   // r, k, w at (t_sub, i); v at (t_v, jl_v)
  long long ts[4];                 // their time strides
  int t_sub, t_v;                  // first step of this thread's passes

  __device__ __forceinline__ void load(T (&pre)[G::LPT], int t0,
                                       int T_len) const {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int n = 0; n < G::NR; ++n) {
        const int t = t0 + n * G::RP + t_sub;
        pre[a * G::NR + n] =
            t < T_len ? p[a][t * ts[a]] : from_f32<T>(0.f);
      }
    }
#pragma unroll
    for (int n = 0; n < G::NV; ++n) {
      const int t = t0 + n * G::P + t_v;
      pre[3 * G::NR + n] = t < T_len ? p[3][t * ts[3]] : from_f32<T>(0.f);
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(Dims<D>::THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ s_out, int T_len, int H, Strides st) {
  using G = Dims<D>;
  constexpr int R = G::R, P = G::P, CB = G::CB, LD = G::LD;
  __shared__ float srkw[3][TC][LD];            // r, k, w of the chunk
  __shared__ float sv[TC][CB];                 // v of the block's columns

  const int col0 = blockIdx.x * CB;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int jl = tid / P;                      // column within the block
  const int p = tid % P;                       // which rows of the column
  const int j = col0 + jl;
  const int i0 = p * R;                        // first state row
  const int ps = p * (R + 4);                  // its offset in a shared row

  // staging roles: row element si of steps t_sub + RP*n (r, k, w) and
  // column vl of steps t_v + P*n (v)
  const int si = tid % D, vl = tid % CB;
  Stage<T, D> stage;
  stage.t_sub = tid / D;
  stage.t_v = tid / CB;
  stage.p[0] = r + b * st.v[0] + h * st.v[2] + si;
  stage.p[1] = k + b * st.v[3] + h * st.v[5] + si;
  stage.p[2] = w + b * st.v[9] + h * st.v[11] + si;
  stage.p[3] = v + b * st.v[6] + h * st.v[8] + col0 + vl;
  stage.ts[0] = st.v[1];
  stage.ts[1] = st.v[4];
  stage.ts[2] = st.v[10];
  stage.ts[3] = st.v[7];
  const int scol = (si / R) * (R + 4) + si % R;   // si's shared column

  float S[R], uu[R];
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    S[ii] = 0.f;
    uu[ii] = u[h * D + i0 + ii];
  }

  T pre[G::LPT];
  stage.load(pre, 0, T_len);
  for (int t0 = 0; t0 < T_len; t0 += TC) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int n = 0; n < G::NR; ++n)
        srkw[a][n * G::RP + stage.t_sub][scol] = to_f32(pre[a * G::NR + n]);
    }
#pragma unroll
    for (int n = 0; n < G::NV; ++n)
      sv[n * P + stage.t_v][vl] = to_f32(pre[3 * G::NR + n]);
    __syncthreads();
    if (t0 + TC < T_len) stage.load(pre, t0 + TC, T_len);
    const int steps = T_len - t0 < TC ? T_len - t0 : TC;
    for (int s = 0; s < steps; ++s) {
      const float vj = sv[s][jl];
      float acc = 0.f;
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const float ri = srkw[0][s][ps + ii];
        const float ki = srkw[1][s][ps + ii];
        const float wi = srkw[2][s][ps + ii];
        const float kv = ki * vj;
        acc = fmaf(ri, fmaf(uu[ii], kv, S[ii]), acc);
        S[ii] = fmaf(wi, S[ii], kv);
      }
      if constexpr (P > 1) {
#pragma unroll
        for (int off = P / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (p == 0)
        y[((b * T_len + t0 + s) * H + h) * D + j] = from_f32<T>(acc);
    }
    __syncthreads();
  }
  float* so = s_out + ((b * H + h) * D + i0) * D + j;
#pragma unroll
  for (int ii = 0; ii < R; ++ii) so[ii * D] = S[ii];
}

template <typename T, int D>
int launch_d(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, void* s, int B, int T_len, int H,
             const long long* st, cudaStream_t stream) {
  using G = Dims<D>;
  Strides strides;
  for (int n = 0; n < 12; ++n) strides.v[n] = st[n];
  const dim3 grid(G::NCB, H, B);
  wkv6_kernel<T, D><<<grid, G::THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<T*>(y),
      static_cast<float*>(s), T_len, H, strides);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, void* s, int B, int T_len, int H, int D,
           const long long* st, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(r, k, v, w, u, y, s, B, T_len, H, st, cs);
    case 32: return launch_d<T, 32>(r, k, v, w, u, y, s, B, T_len, H, st, cs);
    case 64: return launch_d<T, 64>(r, k, v, w, u, y, s, B, T_len, H, st, cs);
    case 128: return launch_d<T, 128>(r, k, v, w, u, y, s, B, T_len, H, st, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements: st holds
// the (batch, time, head) strides of r, then k, then v, then w; the last
// axis of each is contiguous.  u is a contiguous fp32 (H,D) tensor, y a
// contiguous (B,T,H,D) tensor of r's dtype, s a contiguous fp32 (B,H,D,D).
extern "C" int repro_wkv6_f32(const void* r, const void* k, const void* v,
                              const void* w, const void* u, void* y, void* s,
                              int B, int T, int H, int D,
                              const long long* st, void* stream) {
  return launch<float>(r, k, v, w, u, y, s, B, T, H, D, st, stream);
}

extern "C" int repro_wkv6_bf16(const void* r, const void* k, const void* v,
                               const void* w, const void* u, void* y, void* s,
                               int B, int T, int H, int D,
                               const long long* st, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, y, s, B, T, H, D, st, stream);
}
