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
// multiple of 8 multiply no pad rows.  The tiles are (128-column F tile,
// C tile, expert), the expert outermost so that an expert's x tile stays
// in L2 while its weight strips stream past; C > 256 splits into equal
// tiles of at most 256 rows.  Persistent: one block an SM (one a tile
// where there are fewer) walks the tiles in that order.  The wrapper
// plans both (grouped_matmul.plan, plan_bwd: the rows a tile and the
// blocks) and this side launches the instance of that many rows.  Warp-specialised:
// a producer warp issues the TMA loads of a ring of shared-memory stages
// (w boxes 64 F x 64 D, MN-major; x boxes N C x 64 D, K-major; both
// 128-byte swizzled, zeros past the ragged edges of C, D and F, so the
// main loop has no masks), with a full and an empty mbarrier per stage,
// running on from one tile into the next; two consumer warpgroups, 64 F
// rows each, run wgmma m64nNk16 on the stages that have arrived (one
// instruction a k16 step for any N, so A is read once) with one stage's
// group in flight while the next issues, releasing each stage when its
// group is done.  setmaxnreg moves registers from the producer to the
// consumers.  The epilogue rounds the fp32 accumulators to bf16 once, transposes them
// into a shared-memory piece of each warpgroup's own (64 C rows at a time,
// stmatrix into the TMA's 128-byte swizzle, two pieces alternating) and
// hands each piece to a TMA store, clipped past C and F; the consumers go
// on to the next tile while the stores run, and the producer already
// loads it.  The backward launches dx and dw on two streams, so that dw's
// blocks take the SMs that dx's last round of tiles leaves idle.
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
// a K-major A (its D the rows, its F the K) and dy as the forward's
// K-major B (C tiles of 8 to 256 rows in steps of 8, as the forward's:
// 5 x 216 rows at granite's C 1056), dw reads x as an MN-major B (its C
// the K, its D the columns; tiles a multiple of 64 columns, whole
// 64-column atoms LBO apart, as flash attention's P.V reads V).  The
// wrapper plans the tiles and the persistent blocks (plan_bwd).  Every
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

constexpr int BM = 128;           // F columns per tile: two warpgroups of 64
constexpr int BK = 64;            // D per stage: one 128-byte swizzled row
constexpr int A_BYTES = 64 * BK * 2;         // one 64 F x 64 D box of w
constexpr int THREADS = 384;      // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SMEM_LIMIT = 232448;           // per block on an H100
constexpr int EP_ROWS = 64;       // C rows of an epilogue piece
constexpr int EP_PIECE = EP_ROWS * 128;      // its 64 F x 64 C, bf16
constexpr int EP_BYTES = 2 * 2 * EP_PIECE;   // two pieces a warpgroup

template <int N>
struct Cfg {
  static constexpr int STAGE = 2 * A_BYTES + N * BK * 2;  // 1024-multiple
  // the ring, 1024 bytes of slack to align it, the epilogue pieces and a
  // full and an empty mbarrier per stage
  static constexpr int FIT = (SMEM_LIMIT - 1024 - EP_BYTES - 256) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM =
      1024 + STAGES * STAGE + EP_BYTES + 2 * 8 * STAGES;
  static_assert(STAGES >= 3, "ring too small");
};

// Accumulator columns [64 P, 64 P + 64) of a warpgroup's 64 x N tile,
// rounded to bf16, into the shared piece ``buf`` as the C-major tile that
// out (E, C, F) holds there (stmatrix, transposed: a C row of 64 F is 128
// bytes, in the 128-byte swizzle of the TMA store: 16-byte chunk k of row
// c at k ^ (c % 8)), then one TMA store of the 64 rows (``to64``'s box)
// or, for a tile's last, shorter piece, one of each 8 rows (``to8``'s), so
// that no store reaches past the tile's last row into the next tile's
// (rows past C and columns past F are not written).  The warpgroup's
// thread 0 first waits until the store that used ``buf`` two pieces ago
// has read it; named barrier 1 + cw among the warpgroup's 128 threads
// then hands ``buf`` over, and again the piece.
template <int N, int P>
__device__ __forceinline__ void store_piece(const float (&acc)[N / 2],
                                            uint8_t* eps, int& pieces,
                                            const CUtensorMap* to64,
                                            const CUtensorMap* to8, int t,
                                            int cw, int e, int c0, int f0) {
  constexpr int NB = N / 8 - 8 * P < 8 ? N / 8 - 8 * P : 8;  // 8-row blocks
  uint8_t* buf = eps + (2 * cw + (pieces & 1)) * EP_PIECE;
  if (t == 0 && pieces >= 2) hopper::bulk_wait_read<1>();
  hopper::named_bar_sync(1 + cw, 128);
  const int w = t / 32, m = (t % 32) / 8, r = t % 8;
  auto pack = [&](int q) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(acc[q], acc[q + 1]);
    return *reinterpret_cast<const uint32_t*>(&v);
  };
  // matrix m of an instruction: F rows 16 w + 8 (m % 2) .., C rows of
  // block jj + m / 2; this thread gives the address of its row r
  const int fblk = 2 * w + (m & 1);
#pragma unroll
  for (int jj = 0; jj + 1 < NB; jj += 2) {
    const int j = 8 * P + jj;
    const uint32_t regs[4] = {pack(4 * j), pack(4 * j + 2), pack(4 * j + 4),
                              pack(4 * j + 6)};
    const int c = 8 * (jj + (m >> 1)) + r;
    hopper::stmatrix_x4_trans(buf + c * 128 + ((fblk ^ r) << 4), regs);
  }
  if constexpr (NB % 2 == 1) {
    constexpr int j = 8 * P + NB - 1;
    const uint32_t regs[2] = {pack(4 * j), pack(4 * j + 2)};
    const int c = 8 * (NB - 1) + r;
    hopper::stmatrix_x2_trans(buf + c * 128 + ((fblk ^ r) << 4), regs);
  }
  hopper::fence_proxy_async();
  hopper::named_bar_sync(1 + cw, 128);
  if (t == 0) {
    if constexpr (NB == 8) {
      hopper::tma_store_3d(to64, buf, f0 + 64 * cw, c0 + 64 * P, e);
    } else {
#pragma unroll
      for (int g = 0; g < NB; ++g)
        hopper::tma_store_3d(to8, buf + g * 1024, f0 + 64 * cw,
                             c0 + 64 * P + 8 * g, e);
    }
    hopper::bulk_commit();
  }
  ++pieces;
  if constexpr (64 * (P + 1) < N)
    store_piece<N, P + 1>(acc, eps, pieces, to64, to8, t, cw, e, c0, f0);
}

// out (E, C, F) = the product over K = D of an A of F rows and a B of C
// columns, both bf16 in shared memory through the 128-byte swizzle.  The
// forward (AK, BMN false): A = w (E,D,F) in boxes of 64 F x 64 D, MN-major;
// B = x (E,C,D) in boxes of 64 D x N C, K-major.  AK: A K-major, boxes of
// 64 K x 64 rows (the backward's dx reads w (E,D,F) in place: its D are
// the rows, its F the K).  BMN: B MN-major, N/64 boxes of 64 columns x 64
// K (the backward's dw reads x (E,C,D) in place: its C are the K, its D
// the columns).  Persistent: block b takes tiles b, b + gridDim.x, ... of
// the (F tile, C tile, expert) tiles, F fastest and the expert outermost
// (an expert's operands stay in L2 while its tiles pass); the producer's
// ring runs on across tiles, so a tile's epilogue overlaps the loads of
// the next.
template <int N, bool AK = false, bool BMN = false>
__global__ void __launch_bounds__(THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap to64,
                 const __grid_constant__ CUtensorMap to8, int E, int C,
                 int D, int F) {
  static_assert(!BMN || N % 64 == 0, "MN-major B tiles are whole atoms");
  using K = Cfg<N>;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must start 1024-aligned
  uint8_t* ring =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* eps = ring + K::STAGES * K::STAGE;   // 1024-aligned pieces
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + K::STAGES * K::STAGE +
                                               EP_BYTES);
  uint64_t* empty = full + K::STAGES;
  const int mt = (F + BM - 1) / BM, nt = (C + N - 1) / N;
  const int tiles = mt * nt * E;
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
    // producer: one thread keeps the ring full, tile after tile
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int e = tile / (mt * nt);
        const int c0 = (tile / mt) % nt * N;
        const int f0 = tile % mt * BM;
        for (int kb = 0; kb < nk; ++kb) {
          hopper::mbar_wait(&empty[s], phase ^ 1);   // round 0 passes
          uint8_t* st = ring + s * K::STAGE;
          hopper::mbar_arrive_expect_tx(&full[s], K::STAGE);
          for (int h = 0; h < 2; ++h) {          // the two warpgroups' A
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
    }
    return;
  }

  // consumers: warpgroup cw multiplies F rows f0 + 64 cw .. + 63
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int ct = threadIdx.x - 128;
  const int cw = ct / 128;
  int pieces = 0;                    // this warpgroup's epilogue pieces
  float acc[N / 2];
  int s = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int e = tile / (mt * nt);
    const int c0 = (tile / mt) % nt * N;
    const int f0 = tile % mt * BM;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    int held = -1;                   // the stage whose products are in flight
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
      // one instruction a k16 step, however wide N (a multiple of 8)
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        hopper::wgmma_bf16<N, AK ? 0 : 1, BMN ? 1 : 0>(
            acc, da + (k * ASTEP >> 4), db + (k * BSTEP >> 4));
      hopper::wgmma_commit();
      // One group in flight: wait for the previous stage's products and
      // give its slot back while this stage's run.  The last stage waits
      // for all, inside the loop: with that wait after the loop, ptxas
      // moved the epilogue's first accumulator reads (F2FP) above it, past
      // the register fences (seen in the SASS: wrong sums that changed
      // from call to call); it moves nothing out of the loop.
      if (kb + 1 < nk)
        hopper::wgmma_wait<1>();
      else
        hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (held >= 0 && (ct & 31) == 0) hopper::mbar_arrive(&empty[held]);
      held = s;
      if (++s == K::STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    if ((ct & 31) == 0) hopper::mbar_arrive(&empty[held]);   // the last
    // epilogue, while the producer loads the next tile's stages: each
    // warpgroup stores its 64 F columns in pieces of 64 C rows
    store_piece<N, 0>(acc, eps, pieces, &to64, &to8, ct % 128, cw, e, c0,
                      f0);
  }
  if (ct % 128 == 0) hopper::bulk_wait<0>();   // the last stores done
}

constexpr int MAX_DEVICES = 64;

// One launch of the (N, AK, BMN) instance over the tensor maps ta (A) and
// tb (B): out (E, C, F), K = D, on ``blocks`` persistent blocks; out's maps
// (boxes of 64 F x 64 C and 64 F x 8 C, 128-byte swizzle) are encoded
// here.
template <int N, bool AK = false, bool BMN = false>
int run(const CUtensorMap& ta, const CUtensorMap& tb, void* out, int E,
        int C, int D, int F, int blocks, cudaStream_t stream) {
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
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap to64, to8;
  const long long CF = static_cast<long long>(C) * F;
  int rc = hopper::encode_bf16_3d_sw128(&to64, out, F, C, E, F, CF, 64, 64);
  if (rc == 0)
    rc = hopper::encode_bf16_3d_sw128(&to8, out, F, C, E, F, CF, 64, 8);
  if (rc != 0) return rc;
  gmm_wgmma_kernel<N, AK, BMN><<<blocks, THREADS, K::SMEM, stream>>>(
      ta, tb, to64, to8, E, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_n(const void* x, const void* w, void* out, int E, int C, int D,
             int F, long long sxe, long long sxc, long long swe,
             long long swd, int blocks, cudaStream_t stream) {
  // the tensor maps are encoded on the host at every call (no cache to
  // invalidate when the allocator hands out an address again)
  CUtensorMap tw, tx;
  int rc = hopper::encode_bf16_3d_sw128(&tw, w, F, D, E, swd, swe, 64, BK);
  if (rc != 0) return rc;
  rc = hopper::encode_bf16_3d_sw128(&tx, x, D, C, E, sxc, sxe, BK, N);
  if (rc != 0) return rc;
  return run<N>(tw, tx, out, E, C, D, F, blocks, stream);
}

#define REPRO_GMM_CASES(CASE)                                           \
  CASE(8) CASE(16) CASE(24) CASE(32) CASE(40) CASE(48) CASE(56)         \
  CASE(64) CASE(72) CASE(80) CASE(88) CASE(96) CASE(104) CASE(112)      \
  CASE(120) CASE(128) CASE(136) CASE(144) CASE(152) CASE(160)           \
  CASE(168) CASE(176) CASE(184) CASE(192) CASE(200) CASE(208)           \
  CASE(216) CASE(224) CASE(232) CASE(240) CASE(248) CASE(256)

#define REPRO_GMM_CASE(n)                                              \
  case n:                                                              \
    return launch_n<n>(x, w, out, E, C, D, F, sxe, sxc, swe, swd,      \
                       blocks, s);

// The forward: ``n`` C rows a tile on ``blocks`` persistent blocks, the
// wrapper's plan (grouped_matmul.plan); an ``n`` with no instance is
// refused.
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, long long sxe, long long sxc, long long swe, long long swd,
           int n, int blocks, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    REPRO_GMM_CASES(REPRO_GMM_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef REPRO_GMM_CASE

#define REPRO_GMM_DX_CASE(nn)                                          \
  case nn:                                                             \
    return run<nn, true, false>(ta, tb, out, E, C, F, D, blocks, s);
#define REPRO_GMM_DW_CASE(nn)                                          \
  case nn:                                                             \
    return run<nn, false, true>(ta, tb, out, E, D, C, F, blocks, s);

// The backward's products on contiguous bf16 x (E,C,D), w (E,D,F) and dy
// (E,C,F), read in place (no transposed copy): which 0, dx (E,C,D) = dy
// w^T, A = w K-major (its D the rows, its F the K), B = dy K-major,
// ``n`` rows a tile (any multiple of 8 to 256); which 1, dw (E,D,F) =
// x^T dy, A = dy MN-major (as the forward's w), B = x MN-major (its C the
// K, its D the columns), ``n`` a multiple of 64 (whole B atoms).  ``n``
// and ``blocks`` are the wrapper's plan (grouped_matmul.plan_bwd); an
// ``n`` with no instance is refused.  C, D, F > 0; D and F multiples of
// 8.
int launch_bwd(int which, const void* x, const void* w, const void* dy,
               void* out, int E, int C, int D, int F, int n, int blocks,
               cudaStream_t s) {
  const long long CF = static_cast<long long>(C) * F;
  CUtensorMap ta, tb;
  int rc;
  if (which == 0) {
    rc = hopper::encode_bf16_3d_sw128(&ta, w, F, D, E, F,
                                      static_cast<long long>(D) * F, BK, 64);
    if (rc == 0)
      rc = hopper::encode_bf16_3d_sw128(&tb, dy, F, C, E, F, CF, BK, n);
    if (rc != 0) return rc;
    switch (n) {
      REPRO_GMM_CASES(REPRO_GMM_DX_CASE)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (which != 1) return static_cast<int>(cudaErrorInvalidValue);
  rc = hopper::encode_bf16_3d_sw128(&ta, dy, F, C, E, F, CF, 64, BK);
  if (rc == 0)
    rc = hopper::encode_bf16_3d_sw128(&tb, x, D, C, E, D,
                                      static_cast<long long>(C) * D, 64, BK);
  if (rc != 0) return rc;
  switch (n) {
    REPRO_GMM_DW_CASE(64) REPRO_GMM_DW_CASE(128) REPRO_GMM_DW_CASE(192)
    REPRO_GMM_DW_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef REPRO_GMM_DX_CASE
#undef REPRO_GMM_DW_CASE
#undef REPRO_GMM_CASES

}  // namespace wg

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements: (expert,
// row, column) of x, then of w; out is a contiguous (E,C,F) tensor of x's
// dtype.  Each returns cudaGetLastError() after launch, or the error that
// kept it from launching.  The first two are the SIMT route, the third the
// wgmma route (bf16; the column strides must be 1), at ``n`` C rows a tile
// on ``blocks`` persistent blocks (the wrapper's plan).
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
    long long swd, long long swf, int n, int blocks, void* stream) {
  if (sxd != 1 || swf != 1) return static_cast<int>(cudaErrorInvalidValue);
  return wg::launch(x, w, out, E, C, D, F, sxe, sxc, swe, swd, n, blocks,
                    stream);
}

// The backward's products on the tensor cores (bf16, x, w, dy contiguous
// and 16-byte aligned, C, D, F > 0, D and F multiples of 8), reading the
// operands in place: which 0 writes dx (E,C,D) = dy w^T, which 1 dw
// (E,D,F) = x^T dy, into a contiguous ``out``, at ``n`` rows a tile on
// ``blocks`` persistent blocks (the wrapper's plan_bwd).
extern "C" int repro_grouped_matmul_bwd_bf16_wgmma(
    int which, const void* x, const void* w, const void* dy, void* out,
    int E, int C, int D, int F, int n, int blocks, void* stream) {
  if (C <= 0 || D <= 0 || F <= 0 || D % 8 != 0 || F % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return wg::launch_bwd(which, x, w, dy, out, E, C, D, F, n, blocks,
                        static_cast<cudaStream_t>(stream));
}
