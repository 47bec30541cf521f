// Grouped (per-expert) GEMM for Hopper (sm_90a): out[e] = x[e] @ w[e] for
// every expert e, x (E,C,D) and w (E,D,F) in fp32 or bf16, an fp32
// accumulator, out (E,C,F) in x's dtype, rounded once.  The MoE layer's
// capacity-padded dispatch: C rows per expert (a multiple of 8, most of
// them the zero pad row at decode), the expert weights read once each.
//
// Replaces: src/repro/kernels/grouped_matmul/grouped_matmul.py,
// grouped_matmul_pallas (an (E, C/bc, F/bf, D/bd) grid with the
// contraction innermost, accumulating into an fp32 VMEM tile; it asserts
// that the 128-row block divides C, which the serving shapes break).
//
// What bounds it on an H100: at decode (C = 8) the weight read, every
// expert's D x F matrix once, at the 3.35 TB/s memory rate; at prefill
// (C = 160-648 for olmoe) the products, at the 989 TFLOP/s of the bf16
// tensor cores.
//
// Two routes, chosen by the wrapper before it launches
// (kernels/grouped_matmul/grouped_matmul.py, route()):
//
// "wgmma", bf16 operands whose innermost stride is 1, other strides and
// bases 16-byte aligned, D and F multiples of 8 (the whole bf16 MoE
// serving path).  The product runs transposed, out[e]^T = w[e]^T x[e]^T:
// 64 columns of w fill the 64 rows of a warpgroup's wgmma, and the C rows
// of x are its N (a multiple of 8 up to 256), so capacities that are a
// multiple of 8 multiply no pad rows.  One block per (128-column F tile,
// C tile, expert), the expert outermost so that an expert's x tile stays
// in L2 while its weight strips stream past; C > 256 splits into equal
// tiles of at most 256 rows.  Warp-specialised: a producer warp issues the
// TMA loads of a ring of shared-memory stages (w boxes 64 F x 64 D,
// MN-major; x boxes N C x 64 D, K-major; both 128-byte swizzled, zeros
// past the ragged edges of C, D and F, so the main loop has no masks),
// with a full and an empty mbarrier per stage; two consumer warpgroups,
// 64 F rows each, run wgmma m64nNk16 on the stages that have arrived (N
// as a sum of the instruction's power-of-two widths), wait for them and
// release the stage.  setmaxnreg moves registers from the producer to the
// consumers.  The epilogue rounds the fp32 accumulators to bf16 once,
// transposes them through shared memory and writes (E,C,F) with 16-byte
// stores, masked past C and F.
//
// "simt", every other call (fp32 operands, strided or misaligned views,
// odd widths): plain fp32 FMAs on the SIMT units.  The expert rides grid
// axis z and the row tiles grid axis x, so the blocks that share one
// expert's weight column tile run next to each other.  One block per BM x
// 64 output tile: BM = 64 rows with 256 threads in general, BM = 16 rows
// with 64 threads when C <= 16.  The contraction walks in BK-wide steps
// through two shared tiles held in fp32; each thread keeps a 4x4 register
// tile.  The next step's operands are loaded into registers, in their own
// type, while the current step's FMAs run.  x and w are read through
// their (expert, row, column) strides; the ragged edges of C, D and F are
// masked.
//
// The backward (kernels/grouped_matmul/grouped_matmul.py,
// grouped_matmul_bwd): dx = dy w^T and dw = x^T dy take the same kernel
// with x, w and dy read in place, no transposed copy (at
// granite-moe-3b-a800m's training shapes a transposed copy of x or w costs
// more than the product it feeds): dx reads w as
// a K-major A (its D the rows, its F the K), dw reads x as an MN-major B
// (its C the K, its D the columns; tiles a multiple of 64 columns, whole
// 64-column atoms LBO apart, as flash attention's P.V reads V).  Every
// other backward (fp32, widths no multiple of 8) takes the SIMT kernel on
// the transposed views.
//
// Each output is one accumulation in a fixed order on both routes: no
// split-K and no atomics, so the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------- wgmma

namespace wg {

constexpr int BM = 128;           // F columns per block: two warpgroups of 64
constexpr int BK = 64;            // D per stage: one 128-byte swizzled row
constexpr int A_BYTES = 64 * BK * 2;         // one 64 F x 64 D box of w
constexpr int THREADS = 384;      // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SMEM_LIMIT = 232448;           // per block on an H100
constexpr int LDT = BM + 8;       // epilogue tile row, bf16 (16-byte rows)

template <int N>
struct Cfg {
  static constexpr int STAGE = 2 * A_BYTES + N * BK * 2;  // 1024-multiple
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  // 1024 bytes of slack to align the ring, then a full and an empty
  // mbarrier per stage
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * 8 * STAGES;
  static_assert(STAGES >= 2, "ring too small");
  static_assert(N * LDT * 2 <= STAGES * STAGE, "epilogue tile too large");
};

// acc[.. N/2) += A (64 x 16) * B (16 x N), N split into the widths the
// instruction has (256, 128, ..., 8).  TA: A MN-major (the forward's w);
// TB: B MN-major (x read in place by the backward's dw, N a multiple of
// 64).  A part's B starts OFF further on: OFF rows of 128 bytes (K-major
// B, whole 1024-byte swizzle atoms), or OFF / 64 atoms of 64 K rows x 64
// N (MN-major B)
template <int N, int TA, int TB, int OFF = 0>
__device__ __forceinline__ void mma_k16(float* acc, uint64_t da,
                                        uint64_t db) {
  constexpr int P = N >= 256 ? 256 : N >= 128 ? 128 : N >= 64 ? 64
                  : N >= 32 ? 32 : N >= 16 ? 16 : 8;
  static_assert(!TB || P % 64 == 0, "MN-major B parts are whole atoms");
  constexpr int SKIP = TB ? OFF / 64 * A_BYTES : OFF * 128;
  hopper::wgmma_bf16<P, TA, TB>(acc + OFF / 2, da, db + (SKIP >> 4));
  if constexpr (N > P) mma_k16<N - P, TA, TB, OFF + P>(acc, da, db);
}

// out (E, C, F) = the product over K = D of an A of F rows and a B of C
// columns, both bf16 in shared memory through the 128-byte swizzle.  The
// forward (AK, BMN false): A = w (E,D,F) in boxes of 64 F x 64 D, MN-major;
// B = x (E,C,D) in boxes of 64 D x N C, K-major.  AK: A K-major, boxes of
// 64 K x 64 rows (the backward's dx reads w (E,D,F) in place: its D are
// the rows, its F the K).  BMN: B MN-major, N/64 boxes of 64 columns x 64
// K (the backward's dw reads x (E,C,D) in place: its C are the K, its D
// the columns).  Block (F tile, C tile, expert).
template <int N, bool AK = false, bool BMN = false>
__global__ void __launch_bounds__(THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap tx,
                 __nv_bfloat16* __restrict__ out, int C, int D, int F) {
  static_assert(!BMN || N % 64 == 0, "MN-major B tiles are whole atoms");
  using K = Cfg<N>;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must start 1024-aligned
  uint8_t* ring =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + K::STAGES * K::STAGE);
  uint64_t* empty = full + K::STAGES;
  const int f0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * N;
  const int e = blockIdx.z;
  const int nk = (D + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);       // the consumers' 8 warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < nk; ++kb) {
        hopper::mbar_wait(&empty[s], phase ^ 1);   // round 0 passes
        uint8_t* st = ring + s * K::STAGE;
        hopper::mbar_arrive_expect_tx(&full[s], K::STAGE);
        for (int h = 0; h < 2; ++h) {            // the two warpgroups' A
          if constexpr (AK)
            hopper::tma_load_3d(st + h * A_BYTES, &tw, &full[s], kb * BK,
                                f0 + 64 * h, e);
          else
            hopper::tma_load_3d(st + h * A_BYTES, &tw, &full[s],
                                f0 + 64 * h, kb * BK, e);
        }
        if constexpr (BMN) {
          for (int a = 0; a < N / 64; ++a)
            hopper::tma_load_3d(st + (2 + a) * A_BYTES, &tx, &full[s],
                                c0 + 64 * a, kb * BK, e);
        } else {
          hopper::tma_load_3d(st + 2 * A_BYTES, &tx, &full[s], kb * BK, c0,
                              e);
        }
        if (++s == K::STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw multiplies F rows f0 + 64 cw .. + 63
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int ct = threadIdx.x - 128;
  const int cw = ct / 128;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  int s = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < nk; ++kb) {
    hopper::mbar_wait(&full[s], phase);
    const uint8_t* st = ring + s * K::STAGE;
    // an MN-major box is 64 K rows of 128 bytes (64 of M or N), a k16
    // step 16 rows; a K-major box is rows of 128 bytes of K (64 values),
    // a k16 step 32 bytes.  MN-major B's atoms lie A_BYTES apart (LBO).
    const uint64_t da = hopper::desc_sw128(st + cw * A_BYTES,
                                           AK ? 16 : 1024, 1024);
    const uint64_t db = hopper::desc_sw128(st + 2 * A_BYTES,
                                           BMN ? A_BYTES : 16, 1024);
    constexpr int ASTEP = AK ? 32 : 16 * 128, BSTEP = BMN ? 16 * 128 : 32;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      mma_k16<N, AK ? 0 : 1, BMN ? 1 : 0>(acc, da + (k * ASTEP >> 4),
                                          db + (k * BSTEP >> 4));
    hopper::wgmma_commit();
    // Wait for this stage's products, then give its slot back.  Keeping
    // one group in flight here (wait_group 1, releasing the stage before)
    // is no faster on the card, and ptxas then hoisted the epilogue's
    // reads of acc above the final wait_group 0 (seen in the SASS): wrong
    // results.  The producer's ring and the other warpgroup keep the
    // tensor cores busy meanwhile.
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if ((ct & 31) == 0) hopper::mbar_arrive(&empty[s]);
    if (++s == K::STAGES) {
      s = 0;
      phase ^= 1;
    }
  }

  // epilogue: both warpgroups are past their last wgmma, so the ring holds
  // the bf16 tile [N][LDT], C-major, which rows of 16-byte stores write out
  hopper::named_bar_sync(1, 256);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring);
  const int t = ct % 128;
  const int fr = cw * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int cc = 2 * (t % 4);
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const int f = fr + 8 * ((q >> 1) & 1);
    const int c = 8 * (q >> 2) + cc + (q & 1);
    tile[c * LDT + f] = __float2bfloat16(acc[q]);
  }
  hopper::named_bar_sync(1, 256);
  constexpr int CHUNKS = BM / 8;               // 16-byte chunks per row
  for (int i = ct; i < N * CHUNKS; i += 256) {
    const int c = i / CHUNKS, gc = c0 + c;
    const int gf = f0 + (i % CHUNKS) * 8;
    if (gc < C && gf < F)
      *reinterpret_cast<uint4*>(out + (static_cast<long long>(e) * C + gc) *
                                          F + gf) =
          *reinterpret_cast<const uint4*>(tile + c * LDT + (i % CHUNKS) * 8);
  }
}

// rows per C tile: C split into equal tiles of at most 256, rounded up to 8
inline int tile_rows(int C) {
  const int tiles = (C + 255) / 256;
  return ((C + tiles - 1) / tiles + 7) / 8 * 8;
}

constexpr int MAX_DEVICES = 64;

// One launch of the (N, AK, BMN) instance over the tensor maps ta (A) and
// tb (B): out (E, C, F), K = D.
template <int N, bool AK = false, bool BMN = false>
int run(const CUtensorMap& ta, const CUtensorMap& tb, void* out, int E,
        int C, int D, int F, cudaStream_t stream) {
  using K = Cfg<N>;
  // once per device: setmaxnreg redistributes the block's registers, so
  // the consumers' 232 exist only if ptxas gave every thread its share of
  // the 64K; and the shared memory above 48 KB must be opted into
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, gmm_wgmma_kernel<N, AK, BMN>);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (a.numRegs * THREADS < 128 * PRODUCER_REGS + 256 * CONSUMER_REGS)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    err = cudaFuncSetAttribute(gmm_wgmma_kernel<N, AK, BMN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               K::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const dim3 grid((F + BM - 1) / BM, (C + N - 1) / N, E);
  gmm_wgmma_kernel<N, AK, BMN><<<grid, THREADS, K::SMEM, stream>>>(
      ta, tb, static_cast<__nv_bfloat16*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_n(const void* x, const void* w, void* out, int E, int C, int D,
             int F, long long sxe, long long sxc, long long swe,
             long long swd, cudaStream_t stream) {
  // the tensor maps are encoded on the host at every call (no cache to
  // invalidate when the allocator hands out an address again)
  CUtensorMap tw, tx;
  int rc = hopper::encode_bf16_3d_sw128(&tw, w, F, D, E, swd, swe, 64, BK);
  if (rc != 0) return rc;
  rc = hopper::encode_bf16_3d_sw128(&tx, x, D, C, E, sxc, sxe, BK, N);
  if (rc != 0) return rc;
  return run<N>(tw, tx, out, E, C, D, F, stream);
}

#define REPRO_GMM_CASE(n)                                              \
  case n:                                                              \
    return launch_n<n>(x, w, out, E, C, D, F, sxe, sxc, swe, swd, s);

int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, long long sxe, long long sxc, long long swe, long long swd,
           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tile_rows(C)) {
    REPRO_GMM_CASE(8) REPRO_GMM_CASE(16) REPRO_GMM_CASE(24)
    REPRO_GMM_CASE(32) REPRO_GMM_CASE(40) REPRO_GMM_CASE(48)
    REPRO_GMM_CASE(56) REPRO_GMM_CASE(64) REPRO_GMM_CASE(72)
    REPRO_GMM_CASE(80) REPRO_GMM_CASE(88) REPRO_GMM_CASE(96)
    REPRO_GMM_CASE(104) REPRO_GMM_CASE(112) REPRO_GMM_CASE(120)
    REPRO_GMM_CASE(128) REPRO_GMM_CASE(136) REPRO_GMM_CASE(144)
    REPRO_GMM_CASE(152) REPRO_GMM_CASE(160) REPRO_GMM_CASE(168)
    REPRO_GMM_CASE(176) REPRO_GMM_CASE(184) REPRO_GMM_CASE(192)
    REPRO_GMM_CASE(200) REPRO_GMM_CASE(208) REPRO_GMM_CASE(216)
    REPRO_GMM_CASE(224) REPRO_GMM_CASE(232) REPRO_GMM_CASE(240)
    REPRO_GMM_CASE(248) REPRO_GMM_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef REPRO_GMM_CASE

// rows per tile of the backward's MN-major-friendly tiling: rows split
// into equal tiles of at most 256, rounded up to 64 (whole B atoms)
inline int tile_rows64(int rows) {
  const int tiles = (rows + 255) / 256;
  return ((rows + tiles - 1) / tiles + 63) / 64 * 64;
}

// The backward's products on contiguous bf16 x (E,C,D), w (E,D,F) and dy
// (E,C,F), read in place (no transposed copy): which 0, dx (E,C,D) = dy
// w^T, A = w K-major (its D the rows, its F the K), B = dy K-major; which
// 1, dw (E,D,F) = x^T dy, A = dy MN-major (as the forward's w), B = x
// MN-major (its C the K, its D the columns).  C, D, F > 0; D and F
// multiples of 8.
int launch_bwd(int which, const void* x, const void* w, const void* dy,
               void* out, int E, int C, int D, int F, cudaStream_t s) {
  const long long CF = static_cast<long long>(C) * F;
  CUtensorMap ta, tb;
  int rc;
  if (which == 0) {
    const int n = tile_rows64(C);
    rc = hopper::encode_bf16_3d_sw128(&ta, w, F, D, E, F,
                                      static_cast<long long>(D) * F, BK, 64);
    if (rc == 0)
      rc = hopper::encode_bf16_3d_sw128(&tb, dy, F, C, E, F, CF, BK, n);
    if (rc != 0) return rc;
    switch (n) {
      case 64: return run<64, true, false>(ta, tb, out, E, C, F, D, s);
      case 128: return run<128, true, false>(ta, tb, out, E, C, F, D, s);
      case 192: return run<192, true, false>(ta, tb, out, E, C, F, D, s);
      case 256: return run<256, true, false>(ta, tb, out, E, C, F, D, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (which != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n = tile_rows64(D);
  rc = hopper::encode_bf16_3d_sw128(&ta, dy, F, C, E, F, CF, 64, BK);
  if (rc == 0)
    rc = hopper::encode_bf16_3d_sw128(&tb, x, D, C, E, D,
                                      static_cast<long long>(C) * D, 64, BK);
  if (rc != 0) return rc;
  switch (n) {
    case 64: return run<64, false, true>(ta, tb, out, E, D, C, F, s);
    case 128: return run<128, false, true>(ta, tb, out, E, D, C, F, s);
    case 192: return run<192, false, true>(ta, tb, out, E, D, C, F, s);
    case 256: return run<256, false, true>(ta, tb, out, E, D, C, F, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wg

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements: (expert,
// row, column) of x, then of w; out is a contiguous (E,C,F) tensor of x's
// dtype.  Each returns cudaGetLastError() after launch, or the error that
// kept it from launching.  The first two are the SIMT route, the third the
// wgmma route (bf16; the column strides must be 1).
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

extern "C" int repro_grouped_matmul_bf16_wgmma(
    const void* x, const void* w, void* out, int E, int C, int D, int F,
    long long sxe, long long sxc, long long sxd, long long swe,
    long long swd, long long swf, void* stream) {
  if (sxd != 1 || swf != 1) return static_cast<int>(cudaErrorInvalidValue);
  return wg::launch(x, w, out, E, C, D, F, sxe, sxc, swe, swd, stream);
}

// The backward's products on the tensor cores (bf16, x, w, dy contiguous
// and 16-byte aligned, C, D, F > 0, D and F multiples of 8), reading the
// operands in place: which 0 writes dx (E,C,D) = dy w^T, which 1 dw
// (E,D,F) = x^T dy, into a contiguous ``out``.
extern "C" int repro_grouped_matmul_bwd_bf16_wgmma(int which, const void* x,
                                                   const void* w,
                                                   const void* dy, void* out,
                                                   int E, int C, int D, int F,
                                                   void* stream) {
  if (C <= 0 || D <= 0 || F <= 0 || D % 8 != 0 || F % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return wg::launch_bwd(which, x, w, dy, out, E, C, D, F,
                        static_cast<cudaStream_t>(stream));
}
