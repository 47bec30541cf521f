// Backward of the WKV6 (RWKV6 / Finch) recurrence for Hopper (sm_90a), from
// a zero state, fp32 arithmetic.  With S_{t-1} the state before step t and
// G_t = dL/dS_t (G_{T-1} the final state's gradient dS):
//   G_{t-1}[i][j] = w_t[i] G_t[i][j] + r_t[i] dy_t[j]
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i][j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j]     + u[i] r_t[i] (v_t . dy_t)
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   dv_t[j] = sum_i k_t[i] (G_t[i][j] + r_t[i] u[i] dy_t[j])
//   du[i]   = sum_b sum_t r_t[i] k_t[i] (v_t . dy_t)
// r, k, v, w, dy (B,T,H,D) contiguous in fp32 or bf16, u (H,D) and dS
// (B,H,D,D) contiguous fp32 -> dr, dk, dv, dw in the inputs' dtype, du fp32.
//
// Replaces: none.  The JAX package has no backward kernel of
// src/repro/kernels/rwkv_scan/rwkv_scan.py, wkv6_pallas (no custom_vjp): it
// trains through the jnp reference.  This is the backward of the port's
// forward kernel, csrc/wkv6.cu.
//
// What bounds it on an H100: instruction issue and the chains, as in the
// forward.  G runs backward in time and S forward, and dw needs both at the
// same step; S_{t-1} is never rebuilt from S_t by dividing by w_t (a strong
// decay leaves fp32 range, the fault of the TPU's chunked form).  Per
// (b, t, h) the sums run over both axes of the D x D state: over columns
// for dr, dk, dw and v . dy, over rows for dv.
//
// Design: four launches on one stream, nothing atomic, every sum in a fixed
// order, so two calls give the same bits.
//  1. states: a thread steps 4 columns of one state row forward in time
//     (the forward's own fmaf(w, S, k * v), so the states are the forward
//     kernel's bits) and writes the state before every L-th step, an fp32
//     checkpoint of (B, H, T / L, D, D).
//  2. rows: the same threads walk the L-step chunks backward: each reloads
//     its checkpoint, recomputes the chunk's L (8) states in registers, then
//     steps G backward through the chunk.  A row's D/4 lanes sit in one
//     warp, so the four column sums of a step (dy . S, v . G, G . S,
//     v . dy) are shuffles: two halvings leave each lane one of the four,
//     summed by a butterfly (log2(D/4) + 2 shuffles a step, not
//     4 log2(D/4)); lanes 0, D/16 and D/8 of the row write dr, dk, dw.  Each row keeps its du partial over time, written per (b, h).
//  3. cols: a thread steps 4 rows of one column of G backward in time (G's
//     columns are independent) and sums k . (G + r u dy) over the column's
//     D/4 lanes: dv.
//  4. du: the B partials of each (h, i) summed in batch order.
// Launches 1-3 cover a head with D * D/4 threads in blocks of
// min(128, D * D/4) (whole lines a block; at ~156 registers a thread the
// rows kernel fits three such blocks an SM, one of 256); any T (steps past T in the last
// chunk change nothing and are not stored; the loads of every step are
// unconditional, clamped to T, so they issue ahead of the chains); D is
// 16, 32, 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int W = 4;               // columns (rows) of a line a thread keeps
constexpr int L = 8;               // steps between checkpoints
constexpr int MAX_THREADS = 128;   // a block
constexpr int DU_THREADS = 256;

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

// 4 consecutive elements (16 bytes in fp32, 8 in bf16) as floats
__device__ __forceinline__ void ld4(const float* p, float (&f)[W]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&f)[W]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);         // bf16 is an fp32's top half
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}

template <int D>
struct Cfg {
  static constexpr int LANES = D / W;                  // a line's threads
  static constexpr int PER_HEAD = D * LANES;           // threads a head
  static constexpr int THREADS =
      PER_HEAD < MAX_THREADS ? PER_HEAD : MAX_THREADS;
  static constexpr int BLOCKS = PER_HEAD / THREADS;    // blocks a head
  static_assert(LANES >= 4 && LANES <= 32 && 32 % LANES == 0,
                "a line's lanes share one warp; sum4 halves twice");
  static_assert(PER_HEAD % THREADS == 0 && THREADS % 32 == 0,
                "whole lines and whole warps a block");
};

// the sum of ``v`` over the ``lanes`` lanes of a line (neighbours in a warp)
template <int LANES>
__device__ __forceinline__ float line_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sums over a line's ``LANES`` lanes of four values a lane: lane q of
// the line gets the sum of a (q's two top bits 00), b (01), c (10) or d
// (11).  A halving at LANES/2 (each lane sends two values, keeps two) and
// one at LANES/4 (sends one, keeps one), then a butterfly of the one
// value: log2(LANES) + 1 shuffles, not 4 log2(LANES).
template <int LANES>
__device__ __forceinline__ float sum4(float a, float b, float c, float d,
                                      int q) {
  const bool hi = (q & (LANES / 2)) != 0;
  float k0 = hi ? c : a, k1 = hi ? d : b;
  const float s0 = hi ? a : c, s1 = hi ? b : d;
  k0 += __shfl_xor_sync(0xffffffffu, s0, LANES / 2);
  k1 += __shfl_xor_sync(0xffffffffu, s1, LANES / 2);
  const bool lo = (q & (LANES / 4)) != 0;
  float keep = lo ? k1 : k0;
  keep += __shfl_xor_sync(0xffffffffu, lo ? k0 : k1, LANES / 4);
  return line_sum<LANES / 4>(keep);
}

// The thread's line (a row i of the state, or a column j), its first column
// (row) and the (b, h) of its head, from the launch's grid.
template <int D>
struct Line {
  int line, first;
  long long bh;                    // b * H + h
  __device__ __forceinline__ Line(int H) {
    using C = Cfg<D>;
    const int tid = blockIdx.x * C::THREADS + threadIdx.x;
    line = tid / C::LANES;
    first = (tid % C::LANES) * W;
    bh = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  }
};

// 1. The state before every L-th step of row ``line``, columns
// [first, first + 4): ck[(bh, t / L, line, first..)].
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
wkv6_bwd_states_kernel(const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ w, float* __restrict__ ck,
                       int T_len, int H) {
  const Line<D> ln(H);
  const int chunks = (T_len + L - 1) / L;
  const long long b = blockIdx.z, h = blockIdx.y;
  float S[W] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < chunks; ++c) {
    *reinterpret_cast<float4*>(
        ck + ((ln.bh * chunks + c) * D + ln.line) * D + ln.first) =
        make_float4(S[0], S[1], S[2], S[3]);
#pragma unroll
    for (int s = 0; s < L; ++s) {
      // past T: w = 1, k = 0 leave S as it is (the loads stay in bounds)
      const bool ok = c * L + s < T_len;
      const long long row =
          ((b * T_len + min(c * L + s, T_len - 1)) * H + h) * D;
      float wi = to_f32(w[row + ln.line]);
      float ki = to_f32(k[row + ln.line]);
      float vv[W];
      ld4(v + row + ln.first, vv);
      if (!ok) wi = 1.f, ki = 0.f;
#pragma unroll
      for (int e = 0; e < W; ++e) S[e] = fmaf(wi, S[e], ki * vv[e]);
    }
  }
}

// 2. dr, dk, dw of row ``line`` and its du partial, chunks walked
// backward: the chunk's states recomputed from its checkpoint into
// registers, then G stepped backward through it.
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
wkv6_bwd_rows_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ w,
                     const T* __restrict__ dy, const float* __restrict__ u,
                     const float* __restrict__ ds,
                     const float* __restrict__ ck, T* __restrict__ dr,
                     T* __restrict__ dk, T* __restrict__ dw,
                     float* __restrict__ du_part, int T_len, int H) {
  using C = Cfg<D>;
  const Line<D> ln(H);
  const int chunks = (T_len + L - 1) / L;
  const long long b = blockIdx.z, h = blockIdx.y;
  const int q = threadIdx.x % C::LANES;          // lane within the line
  const float ui = u[h * D + ln.line];
  float G[W];
  {
    const float4 g4 = *reinterpret_cast<const float4*>(
        ds + (ln.bh * D + ln.line) * D + ln.first);
    G[0] = g4.x; G[1] = g4.y; G[2] = g4.z; G[3] = g4.w;
  }
  float du = 0.f;
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * L;
    float S[L][W];                   // S[s]: the state before step t0 + s
    {
      const float4 s4 = *reinterpret_cast<const float4*>(
          ck + ((ln.bh * chunks + c) * D + ln.line) * D + ln.first);
      S[0][0] = s4.x; S[0][1] = s4.y; S[0][2] = s4.z; S[0][3] = s4.w;
    }
#pragma unroll
    for (int s = 0; s + 1 < L; ++s) {
      const bool ok = t0 + s < T_len;
      const long long row = ((b * T_len + min(t0 + s, T_len - 1)) * H + h) * D;
      float wi = to_f32(w[row + ln.line]);
      float ki = to_f32(k[row + ln.line]);
      float vv[W];
      ld4(v + row + ln.first, vv);
      if (!ok) wi = 1.f, ki = 0.f;
#pragma unroll
      for (int e = 0; e < W; ++e) S[s + 1][e] = fmaf(wi, S[s][e], ki * vv[e]);
    }
#pragma unroll
    for (int s = L - 1; s >= 0; --s) {
      // past T: r = 0, w = 1, dy = 0 leave G and du as they are; nothing
      // is stored (the loads stay in bounds, so they need no branch)
      const bool ok = t0 + s < T_len;
      const long long row = ((b * T_len + min(t0 + s, T_len - 1)) * H + h) * D;
      float ri = to_f32(r[row + ln.line]);
      const float ki = to_f32(k[row + ln.line]);
      float wi = to_f32(w[row + ln.line]);
      float vv[W], dd[W];
      ld4(v + row + ln.first, vv);
      ld4(dy + row + ln.first, dd);
      if (!ok) {
        ri = 0.f;
        wi = 1.f;
#pragma unroll
        for (int e = 0; e < W; ++e) dd[e] = 0.f;
      }
      float a = 0.f, g = 0.f, x = 0.f, p = 0.f;   // dy.S, v.G, G.S, v.dy
#pragma unroll
      for (int e = 0; e < W; ++e) {
        a = fmaf(dd[e], S[s][e], a);
        g = fmaf(vv[e], G[e], g);
        x = fmaf(G[e], S[s][e], x);
        p = fmaf(vv[e], dd[e], p);
      }
      // the four sums over the line's lanes: two halvings leave lane q
      // one quantity (a, g, x, p by its two top bits), then a butterfly
      // of that one value; p is fetched from the line's lane 3 LANES/4
      const float sum = sum4<C::LANES>(a, g, x, p, q);
      p = __shfl_sync(0xffffffffu, sum,
                      (threadIdx.x & 31 & ~(C::LANES - 1)) + 3 * C::LANES / 4);
      if (ok && q == 0) dr[row + ln.line] = from_f32<T>(fmaf(ui * ki, p, sum));
      if (ok && q == C::LANES / 4)
        dk[row + ln.line] = from_f32<T>(fmaf(ui * ri, p, sum));
      if (ok && q == C::LANES / 2) dw[row + ln.line] = from_f32<T>(sum);
      du = fmaf(ri * ki, p, du);
#pragma unroll
      for (int e = 0; e < W; ++e) G[e] = fmaf(wi, G[e], ri * dd[e]);
    }
  }
  if (q == 0) du_part[ln.bh * D + ln.line] = du;
}

// 3. dv of column ``line``: rows [first, first + 4) of G's column stepped
// backward in time, k . (G + r u dy) summed over the column's lanes.
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
wkv6_bwd_cols_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ w, const T* __restrict__ dy,
                     const float* __restrict__ u,
                     const float* __restrict__ ds, T* __restrict__ dv,
                     int T_len, int H) {
  using C = Cfg<D>;
  const Line<D> ln(H);
  const long long b = blockIdx.z, h = blockIdx.y;
  const int q = threadIdx.x % C::LANES;
  float G[W], uu[W];
#pragma unroll
  for (int e = 0; e < W; ++e) {
    G[e] = ds[(ln.bh * D + ln.first + e) * D + ln.line];
    uu[e] = u[h * D + ln.first + e];
  }
#pragma unroll 4
  for (int t = T_len - 1; t >= 0; --t) {
    const long long row = ((b * T_len + t) * H + h) * D;
    float rr[W], kk[W], ww[W];
    ld4(r + row + ln.first, rr);
    ld4(k + row + ln.first, kk);
    ld4(w + row + ln.first, ww);
    const float dj = to_f32(dy[row + ln.line]);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e)
      part = fmaf(kk[e], fmaf(rr[e] * uu[e], dj, G[e]), part);
    part = line_sum<C::LANES>(part);
    if (q == 0) dv[row + ln.line] = from_f32<T>(part);
#pragma unroll
    for (int e = 0; e < W; ++e) G[e] = fmaf(ww[e], G[e], rr[e] * dj);
  }
}

// 4. du[h, i] = the B partials summed in batch order.
__global__ void __launch_bounds__(DU_THREADS)
wkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                   int B, int HD) {
  const int n = blockIdx.x * DU_THREADS + threadIdx.x;
  if (n >= HD) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[static_cast<long long>(b) * HD + n];
  du[n] = s;
}

struct Args {
  const void *r, *k, *v, *w, *dy, *u, *ds;
  void *ck, *dr, *dk, *dv, *dw, *du_part, *du;
  int B, T_len, H;
};

// One stage of the (D) instance on the wrapper's grid: ``blocks`` blocks a
// head of ``threads`` threads (refused where they are not this instance's).
template <typename T, int D>
int stage_d(int stage, const Args& a, int blocks, int threads,
            cudaStream_t s) {
  using C = Cfg<D>;
  if (threads != C::THREADS || blocks != C::BLOCKS)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(blocks, a.H, a.B);
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* w = static_cast<const T*>(a.w);
  const T* dy = static_cast<const T*>(a.dy);
  const float* u = static_cast<const float*>(a.u);
  const float* ds = static_cast<const float*>(a.ds);
  float* ck = static_cast<float*>(a.ck);
  if (stage == 0)
    wkv6_bwd_states_kernel<T, D><<<grid, threads, 0, s>>>(k, v, w, ck, a.T_len,
                                                         a.H);
  else if (stage == 1)
    wkv6_bwd_rows_kernel<T, D><<<grid, threads, 0, s>>>(
        r, k, v, w, dy, u, ds, ck, static_cast<T*>(a.dr),
        static_cast<T*>(a.dk), static_cast<T*>(a.dw),
        static_cast<float*>(a.du_part), a.T_len, a.H);
  else if (stage == 2)
    wkv6_bwd_cols_kernel<T, D><<<grid, threads, 0, s>>>(
        r, k, w, dy, u, ds, static_cast<T*>(a.dv), a.T_len, a.H);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int stage(int st, const void* r, const void* k, const void* v, const void* w,
          const void* dy, const void* u, const void* ds, void* ck, void* dr,
          void* dk, void* dv, void* dw, void* du_part, void* du, int B,
          int T_len, int H, int D, int blocks, int threads, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (st == 3) {                     // du: (H, D) from the (B, H, D) partials
    const int HD = H * D;
    wkv6_bwd_du_kernel<<<(HD + DU_THREADS - 1) / DU_THREADS, DU_THREADS, 0,
                         s>>>(static_cast<const float*>(du_part),
                              static_cast<float*>(du), B, HD);
    return static_cast<int>(cudaGetLastError());
  }
  const Args a{r, k, v, w, dy, u, ds, ck, dr, dk, dv, dw, du_part, du,
               B, T_len, H};
  switch (D) {
    case 16: return stage_d<T, 16>(st, a, blocks, threads, s);
    case 32: return stage_d<T, 32>(st, a, blocks, threads, s);
    case 64: return stage_d<T, 64>(st, a, blocks, threads, s);
    case 128: return stage_d<T, 128>(st, a, blocks, threads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, bound with ctypes: one launch of stage ``st`` (0 states,
// 1 rows, 2 cols, 3 du), in that order on one stream.  r, k, v, w, dy are
// contiguous (B,T,H,D) tensors of one dtype, 16-byte aligned; u (H,D), ds
// (B,H,D,D), the checkpoints ck (B,H,ceil(T/8),D,D), du_part (B,H,D) and
// du (H,D) contiguous fp32; dr, dk, dv, dw contiguous (B,T,H,D) of the
// inputs' dtype.  ``blocks`` a head (grid x; heads y, batch z) of
// ``threads`` threads: the wrapper's grid_bwd().
extern "C" int repro_wkv6_bwd_f32(int st, const void* r, const void* k,
                                  const void* v, const void* w,
                                  const void* dy, const void* u,
                                  const void* ds, void* ck, void* dr,
                                  void* dk, void* dv, void* dw,
                                  void* du_part, void* du, int B, int T,
                                  int H, int D, int blocks, int threads,
                                  void* stream) {
  return stage<float>(st, r, k, v, w, dy, u, ds, ck, dr, dk, dv, dw, du_part,
                      du, B, T, H, D, blocks, threads, stream);
}

extern "C" int repro_wkv6_bwd_bf16(int st, const void* r, const void* k,
                                   const void* v, const void* w,
                                   const void* dy, const void* u,
                                   const void* ds, void* ck, void* dr,
                                   void* dk, void* dv, void* dw,
                                   void* du_part, void* du, int B, int T,
                                   int H, int D, int blocks, int threads,
                                   void* stream) {
  return stage<__nv_bfloat16>(st, r, k, v, w, dy, u, ds, ck, dr, dk, dv, dw,
                              du_part, du, B, T, H, D, blocks, threads,
                              stream);
}
