// The SIMT route of the grouped (per-expert) GEMM for Hopper (sm_90a):
// out[e] = x[e] @ w[e], x (E,C,D) and w (E,D,F) in fp32 or bf16 read
// through their strides, an fp32 accumulator, out (E,C,F) contiguous in
// x's dtype, rounded once.  The wrapper sends it every call that the
// tensor-core route (grouped_matmul.cu) does not take
// (kernels/grouped_matmul/grouped_matmul.py, route(), route_bwd()).
//
// Replaces: src/repro/kernels/grouped_matmul/grouped_matmul.py,
// grouped_matmul_pallas, with grouped_matmul.cu, for fp32 operands and
// the shapes and strides TMA cannot read.
//
// What bounds it on an H100: plain fp32 FMAs on the SIMT units (no TF32
// and no tensor cores for fp32), so at granite-moe-3b-a800m's fp32
// training products and olmoe-1b-7b's fp32 prefill the 67 TFLOP/s fp32
// rate.
//
// Design: the wrapper plans each launch (grouped_matmul.plan_simt):
// output tiles of ``rows`` C rows, 16, 80 or 128 (the smallest that holds
// C's equal split into tiles of at most 128: 2 x 80 at olmoe's C 160,
// 9 x 128 at granite's 1056; smaller where the grid would not fill the
// SMs) by 128 F columns, on rows / 8 x 16 threads that each keep an 8 x 8
// fp32 register tile (16-row tiles: 128 threads of 2 x 8).  Other heights
// in steps of 8 measured no faster where they fit C more closely.
// The expert rides grid axis z and the row tiles grid axis x, so the
// blocks that share one expert's weight column tile run next to each
// other.  The contraction walks in 16-deep stages through a ring of 3
// raw stages in dynamic shared memory, filled by 16-byte cp.async.cg
// copies along each operand's contiguous axis (zero-filled past the
// ragged edges of C, D and F), or where that axis is misaligned or not of
// unit stride by 4-byte cp.async copies an element (a bf16 element's
// aligned word), so that in both types a stage's copies are in flight
// while the FMAs of the stages before it run; both orientations of each
// operand are read in place: x K-contiguous (the forward, dx's dy) or
// M-contiguous (dw's x^T view), w N-contiguous (the forward, dw's dy) or
// K-contiguous (dx's w^T view).  Each landed stage is staged once into
// the one fp32 layout the FMA loop reads (bf16 becomes fp32 there),
// transposed where K was contiguous: two block barriers a stage, one
// before the FMAs read it, one before the next stage overwrites it.
// Measured slower on the card: a second fp32 stage in flight (the shared
// memory of a third block an SM at 80 rows), FMA loops that read the
// ring in each orientation with no staging (32 registers of A a 4-k
// block, spills), rings of 4 or 5 stages (6 at 16 rows: no faster), a
// second FMA loop in the 80- and 128-row instances, and the element
// walks kept in shared memory; element copies as blocking bf16 loads, or
// with a division a stage, made the narrow products slower.
//
// The backward's dx = dy w^T and dw = x^T dy run here on the views the
// wrapper passes, read in place (no transposed copy).  Each output is one
// chain of FMAs in k order: no split of K and no atomics, so two calls
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BN = 128;           // output columns a block: 16 threads x 8
constexpr int BK = 16;            // contraction a ring stage
constexpr int STAGES = 3;         // ring slots

// 16 bytes (4 fp32 or 8 bf16) as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // bf16 is the top half of an fp32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// A thread's walk over a block of elements n wide (c < n the fast
// index, r the slow one): consecutive threads on consecutive c, each
// thread's next element NT further.  Made once a block (two divisions)
// and packed in two registers (c | r << 16, dc | dr << 16; n, dc, c < 2^8
// and r, dr <= NT), walked each stage without a division.
struct Walk {
  uint32_t at, step;
};

template <int NT>
__device__ __forceinline__ Walk walk(int n, int tid) {
  n = max(n, 1);
  return {static_cast<uint32_t>(tid % n | tid / n << 16),
          static_cast<uint32_t>(NT % n | NT / n << 16)};
}

// f(c, r) for each element of the walk's n-wide block with r < o
template <typename Fn>
__device__ __forceinline__ void elts(const Walk& w, int n, int o, Fn&& f) {
  const int dc = w.step & 0xffff, dr = w.step >> 16;
  for (int c = w.at & 0xffff, r = w.at >> 16; r < o;) {
    f(c, r);
    c += dc;
    r += dr;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

// One operand of a block, A (x: M = C rows, K = D) or B (w: K = D, N =
// F): its expert's base, the strides of its M (or N) and K axes, their
// extents; ``kc``: K is the contiguous axis (the ring holds rows of K,
// pitch KP), else M (or N) is (rows of BK); ``vec``: 16-byte copies
// along that axis (unit stride, the other strides and the base 16-byte
// aligned), else element copies, each thread's over the block's rows of
// M (or N) found by ``rows``.
template <typename T>
struct Operand {
  const T* p;
  long long smn, sk;
  int nmn, nk;
  bool kc, vec;
  Walk rows;
};

template <typename T>
struct Elt {
  static constexpr int E = 16 / sizeof(T);        // elements a copy
  static constexpr int KP = BK + E;               // pitch of a row of K
};

// One stage (BK of K from k0) of an operand's EXT rows or columns from
// mn0 -> the ring slot ``raw``, in the operand's own orientation and
// type, by thread ``tid`` of NT; 16-byte copies zero-fill past the ragged
// edges.  Rows of K sit KP apart, so that 16-byte reads of consecutive
// rows hit other banks.
template <typename T, int EXT, int NT>
__device__ __forceinline__ void load_stage(T* raw, const Operand<T>& op,
                                           int mn0, int k0, int tid) {
  constexpr int E = Elt<T>::E, KP = Elt<T>::KP;
  constexpr int S = static_cast<int>(sizeof(T));
  if (op.vec && op.kc) {
    constexpr int PR = BK / E, N = EXT * PR;
#pragma unroll 2
    for (int r = 0; r < (N + NT - 1) / NT; ++r) {
      const int i = tid + r * NT;
      if (N % NT == 0 || i < N) {
        const int m = i / PR, c = (i % PR) * E;
        const int gm = mn0 + m, gk = k0 + c;
        const int n = gm < op.nmn ? max(0, min(E, op.nk - gk)) : 0;
        hopper::cp_async16(raw + m * KP + c,
                           n ? op.p + gm * op.smn + gk : op.p, n * S);
      }
    }
  } else if (op.vec) {
    constexpr int PR = EXT / E, N = BK * PR;
#pragma unroll 2
    for (int r = 0; r < (N + NT - 1) / NT; ++r) {
      const int i = tid + r * NT;
      if (N % NT == 0 || i < N) {
        const int k = i / PR, c = (i % PR) * E;
        const int gk = k0 + k, gm = mn0 + c;
        const int n = gk < op.nk ? max(0, min(E, op.nmn - gm)) : 0;
        hopper::cp_async16(raw + k * EXT + c,
                           n ? op.p + gk * op.sk + gm : op.p, n * S);
      }
    }
  } else {
    // element copies, 4 bytes each (so asynchronous in both types), of
    // the tile's part inside the operand (vm x vk) into words: rows of K
    // BK + 1 words apart (conflict-free), or rows of M (or N) of EXT words;
    // consecutive threads along the contiguous axis, each thread a few
    // elements (elts' walk).  A bf16 element's copy is the aligned 4-byte
    // word that holds it (its other half, a neighbour in the same
    // allocation, is never used): stage_elt picks the half.
    uint32_t* words = reinterpret_cast<uint32_t*>(raw);
    const int vm = max(0, min(EXT, op.nmn - mn0));
    const int vk = max(0, min(BK, op.nk - k0));
    auto copy = [&](int m, int k) {
      const uintptr_t src = reinterpret_cast<uintptr_t>(
          op.p + (mn0 + m) * op.smn + (k0 + k) * op.sk);
      hopper::cp_async4(words + (op.kc ? m * (BK + 1) + k : k * EXT + m),
                        reinterpret_cast<const void*>(src & ~uintptr_t(3)),
                        4);
    };
    if (op.kc) {
      for (int i = tid; i < vm * BK; i += NT)
        if (i % BK < vk) copy(i / BK, i % BK);
    } else {
      elts(op.rows, vm, vk, copy);
    }
  }
}

// A landed stage of an operand -> fp32 [BK][EXT], the one layout the FMA
// loop reads: bf16 becomes fp32 here, once; rows of K are transposed
// (16-byte reads of KP-apart rows, consecutive threads on consecutive
// rows and so on consecutive words of the output).
template <typename T, int EXT, int NT>
__device__ __forceinline__ void stage(const T* raw, float* comp, bool kc,
                                      int tid) {
  constexpr int E = Elt<T>::E, KP = Elt<T>::KP;
  if (kc) {
    constexpr int N = EXT * (BK / E);
#pragma unroll 2
    for (int r = 0; r < (N + NT - 1) / NT; ++r) {
      const int i = tid + r * NT;
      if (N % NT == 0 || i < N) {
        const int m = i % EXT, c = i / EXT * E;
        float f[E];
        unpack(*reinterpret_cast<const uint4*>(raw + m * KP + c), f);
#pragma unroll
        for (int j = 0; j < E; ++j) comp[(c + j) * EXT + m] = f[j];
      }
    }
  } else {
    constexpr int N = BK * EXT / E;
#pragma unroll 2
    for (int r = 0; r < (N + NT - 1) / NT; ++r) {
      const int i = tid + r * NT;
      if (N % NT == 0 || i < N) {
        float f[E];
        unpack(*reinterpret_cast<const uint4*>(raw + i * E), f);
#pragma unroll
        for (int j = 0; j < E; j += 4)
          *reinterpret_cast<float4*>(comp + i * E + j) =
              make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
      }
    }
  }
}

// A landed stage of an element-copied operand (load_stage's words) ->
// fp32 [BK][EXT] rows m < vm: a bf16 element is the half of its word that
// its address names; zeros at k >= vk (the last stage's edge).  Rows (or
// columns) m >= vm are left as they are: they reach only outputs past C
// (or F), which are never stored.  Consecutive threads on consecutive m,
// conflict-free (rows of K are BK + 1 words apart).
template <typename T, int EXT, int NT>
__device__ __forceinline__ void stage_elt(const uint32_t* words, float* comp,
                                          const Operand<T>& op, int mn0,
                                          int k0, int tid) {
  const int vm = max(0, min(EXT, op.nmn - mn0));
  const int vk = max(0, min(BK, op.nk - k0));
  // the parity of an element's index, from the low bits alone
  const unsigned odd = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(op.p) / sizeof(T));
  elts(op.rows, vm, BK, [&](int m, int k) {
    float v = 0.f;
    if (k < vk) {
      const uint32_t u = words[op.kc ? m * (BK + 1) + k : k * EXT + m];
      if constexpr (sizeof(T) == 4) {
        v = __uint_as_float(u);
      } else {
        const bool high =
            (odd + static_cast<unsigned>(mn0 + m) *
                       static_cast<unsigned>(op.smn) +
             static_cast<unsigned>(k0 + k) * static_cast<unsigned>(op.sk)) &
            1u;
        v = __uint_as_float(high ? u & 0xffff0000u : u << 16);
      }
    }
    comp[k * EXT + m] = v;
  });
}

// four consecutive outputs of a row: one 16-byte (fp32) or 8-byte (bf16)
// store where the row allows, else element by element up to ``left``
__device__ __forceinline__ void store4(float* p, float4 v, int left,
                                       bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < left) p[j] = f[j];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v, int left,
                                       bool vec) {
  if (vec && left >= 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  } else {
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < left) p[j] = __float2bfloat16(f[j]);
  }
}

// The instance of ROWS output rows a block (16, 80 or 128):
// ROWS / TM x 16 threads, each a TM x 8 register tile (TM 8; 2 at 16
// rows, so that a small grid's blocks spread each stage's copies and FMAs
// over four warps, not one); the ring of STAGES raw stages of both
// operands, then one fp32 stage in the FMA loop's layout.  (64-deep
// stages at 16 rows measured slower at small D: each stage's fixed work
// grows fourfold.)
template <typename T, int ROWS>
struct Cfg {
  static constexpr int TM = ROWS == 16 ? 2 : 8;
  static constexpr int THREADS = ROWS / TM * (BN / 8);
  // bytes of a row (or column) of an operand in a ring slot: KP elements,
  // or BK + 1 words of element copies
  static constexpr int ROW = Elt<T>::KP * sizeof(T) > (BK + 1) * 4
                                 ? Elt<T>::KP * sizeof(T)
                                 : (BK + 1) * 4;
  static constexpr int RAW_A = ROWS * ROW;           // bytes
  static constexpr int RAW_B = BN * ROW;
  static constexpr int SLOT = RAW_A + RAW_B;
  static constexpr int COMP = BK * (ROWS + BN);     // fp32
  static constexpr size_t SMEM = STAGES * SLOT + COMP * sizeof(float);
  static_assert(ROWS % 8 == 0 && ROWS >= 16 && ROWS <= 128, "rows");
};

// Row i of thread row ty's TM x 8 tile: 4 ty + i and ROWS / 2 + 4 ty + i
// - 4 (TM 8), ty + i ROWS / 2 (TM 2).
template <int ROWS, int TM>
__device__ __forceinline__ int tile_row(int ty, int i) {
  if constexpr (TM == 8)
    return i < 4 ? 4 * ty + i : ROWS / 2 + 4 * ty + i - 4;
  return ty + i * ROWS / 2;
}

// One stage's FMAs of a thread's TM x 8 tile, k in order: its rows from
// ``ca`` and, of its two 4-column groups (columns 4 tx and 64 + 4 tx), the
// first NB from ``cw`` (1 on 16-row tiles whose second 64 columns lie
// past F: half the FMAs of a narrow product's stage).
template <int ROWS, int TM, int NB>
__device__ __forceinline__ void fma_stage(float (&acc)[TM][8],
                                          const float* ca, const float* cw) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float av[TM];
    if constexpr (TM == 8) {
      const float4 a0 = *reinterpret_cast<const float4*>(ca + k * ROWS);
      const float4 a1 =
          *reinterpret_cast<const float4*>(ca + k * ROWS + ROWS / 2);
      const float a8[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a8[i];
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = ca[k * ROWS + i * ROWS / 2];
    }
    float bv[4 * NB];
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      const float4 b =
          *reinterpret_cast<const float4*>(cw + k * BN + h * BN / 2);
      bv[4 * h] = b.x;
      bv[4 * h + 1] = b.y;
      bv[4 * h + 2] = b.z;
      bv[4 * h + 3] = b.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NB; ++j)
        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[e] = x[e] @ w[e] for the (ROWS x BN) tile (blockIdx.x, blockIdx.y)
// of expert blockIdx.z.  Thread (ty, tx) holds rows tile_row(ty, i) and
// columns 4 tx + j and 64 + 4 tx + j (j < 4): its reads of a k row are
// broadcasts (A: 16 bytes of 4 rows, or a row) or a warp's contiguous
// 256 bytes (B), conflict-free.  Each output is one chain of FMAs in k
// order.
template <typename T, int ROWS>
__global__ void __launch_bounds__(Cfg<T, ROWS>::THREADS,
                                  512 / Cfg<T, ROWS>::THREADS)
gmm_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int C, int D, int F, long long sxe,
                long long sxc, long long sxd, long long swe, long long swd,
                long long swf, int a_kc, int a_vec, int b_kc, int b_vec) {
  using Cf = Cfg<T, ROWS>;
  constexpr int NT = Cf::THREADS, TM = Cf::TM;
  extern __shared__ __align__(16) unsigned char smem[];
  float* comp = reinterpret_cast<float*>(smem + STAGES * Cf::SLOT);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int col0 = blockIdx.y * BN;
  const long long e = blockIdx.z;
  Operand<T> A{x + e * sxe, sxc, sxd, C, D, a_kc != 0, a_vec != 0};
  Operand<T> B{w + e * swe, swf, swd, F, D, b_kc != 0, b_vec != 0};
  if (!A.vec) A.rows = walk<NT>(min(ROWS, C - row0), tid);
  if (!B.vec) B.rows = walk<NT>(min(BN, F - col0), tid);
  const int steps = (D + BK - 1) / BK;

  auto load = [&](int s) {
    unsigned char* slot = smem + (s % STAGES) * Cf::SLOT;
    load_stage<T, ROWS, NT>(reinterpret_cast<T*>(slot), A, row0, s * BK,
                            tid);
    load_stage<T, BN, NT>(reinterpret_cast<T*>(slot + Cf::RAW_A), B, col0,
                          s * BK, tid);
  };
  auto to_comp = [&](int s) {
    const unsigned char* slot = smem + (s % STAGES) * Cf::SLOT;
    float* cb = comp + BK * ROWS;
    if (A.vec)
      stage<T, ROWS, NT>(reinterpret_cast<const T*>(slot), comp, A.kc, tid);
    else
      stage_elt<T, ROWS, NT>(reinterpret_cast<const uint32_t*>(slot), comp,
                             A, row0, s * BK, tid);
    if (B.vec)
      stage<T, BN, NT>(reinterpret_cast<const T*>(slot + Cf::RAW_A), cb,
                       B.kc, tid);
    else
      stage_elt<T, BN, NT>(
          reinterpret_cast<const uint32_t*>(slot + Cf::RAW_A), cb, B, col0,
          s * BK, tid);
  };

  // one commit group a stage: stage s has landed at a fixed count
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < steps) load(s);
    hopper::cp_async_commit();
  }
  if (steps > 0) {
    hopper::cp_async_wait<STAGES - 1>();
    __syncthreads();
    to_comp(0);
  }

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int ty = tid / 16, tx = tid % 16;
  const float* ca = comp + tile_row<ROWS, TM>(ty, 0);
  const float* cw = comp + BK * ROWS + 4 * tx;
  const bool two_halves = col0 + BN / 2 < F;   // else no output past 64
  for (int t = 0; t < steps; ++t) {
    // stage t + 1 has landed, every thread's stage t is in fp32, and no
    // thread still reads raw t's slot
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES < steps) load(t + STAGES);
    hopper::cp_async_commit();
    if (TM == 8 || two_halves)   // (the 8-row tiles keep one loop)
      fma_stage<ROWS, TM, 2>(acc, ca, cw);
    else if constexpr (TM == 2)
      fma_stage<ROWS, TM, 1>(acc, ca, cw);
    __syncthreads();                     // every thread's FMAs of stage t
    if (t + 1 < steps) to_comp(t + 1);
  }

  T* o = out + e * static_cast<long long>(C) * F;
  const bool vec = F % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = row0 + tile_row<ROWS, TM>(ty, i);
    if (m >= C) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = col0 + h * BN / 2 + 4 * tx;
      if (n < F)
        store4(o + static_cast<long long>(m) * F + n,
               make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                           acc[i][4 * h + 2], acc[i][4 * h + 3]),
               F - n, vec);
    }
  }
}

template <typename T, int ROWS>
int launch_rows(const void* x, const void* w, void* out, int E, int C,
                int D, int F, long long sxe, long long sxc, long long sxd,
                long long swe, long long swd, long long swf, int threads,
                int a_kc, int a_vec, int b_kc, int b_vec, cudaStream_t s) {
  using Cf = Cfg<T, ROWS>;
  if (threads != Cf::THREADS)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (Cf::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_simt_kernel<T, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Cf::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((C + ROWS - 1) / ROWS, (F + BN - 1) / BN, E);
  gmm_simt_kernel<T, ROWS><<<grid, Cf::THREADS, Cf::SMEM, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), C, D, F, sxe, sxc, sxd, swe, swd, swf, a_kc,
      a_vec, b_kc, b_vec);
  return static_cast<int>(cudaGetLastError());
}

// what 16-byte copies along an operand's contiguous axis need: that axis
// of unit stride, the other stride (of an extent past 1) and the expert
// stride multiples of 16 bytes, the base 16-byte aligned
template <typename T>
bool vec_ok(const void* p, long long s_c, long long s_o, int n_o,
            long long s_e, int n_e) {
  constexpr int E = Elt<T>::E;
  return s_c == 1 && (n_o <= 1 || s_o % E == 0) &&
         (n_e <= 1 || s_e % E == 0) &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

#define REPRO_SIMT_ROWS(CASE) CASE(16) CASE(80) CASE(128)

// The wrapper's plan (grouped_matmul.plan_simt): ``rows`` a block on
// ``threads`` threads, each operand's contiguous axis (kc: K) and copy
// width (vec: 16 bytes); an instance it does not have, or 16-byte copies
// of an operand they cannot read, are refused.
template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, long long sxe, long long sxc, long long sxd, long long swe,
           long long swd, long long swf, int rows, int threads, int a_kc,
           int a_vec, int b_kc, int b_vec, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if ((a_vec && !(a_kc ? vec_ok<T>(x, sxd, sxc, C, sxe, E)
                       : vec_ok<T>(x, sxc, sxd, D, sxe, E))) ||
      (b_vec && !(b_kc ? vec_ok<T>(w, swd, swf, F, swe, E)
                       : vec_ok<T>(w, swf, swd, D, swe, E))))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_SIMT_CASE(R)                                               \
  case R:                                                                \
    return launch_rows<T, R>(x, w, out, E, C, D, F, sxe, sxc, sxd, swe,  \
                             swd, swf, threads, a_kc, a_vec, b_kc, b_vec, \
                             s);
  switch (rows) {
    REPRO_SIMT_ROWS(REPRO_SIMT_CASE)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SIMT_CASE
}

#undef REPRO_SIMT_ROWS

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements: (expert,
// row, column) of x, then of w; out is a contiguous (E,C,F) tensor of x's
// dtype.  The wrapper's plan (grouped_matmul.plan_simt): ``rows`` C rows
// a block of ``threads`` threads, and for x and for w whether K is the
// contiguous axis (kc) and whether 16-byte copies read it (vec).  Each
// returns cudaGetLastError() after launch, or the error that kept it from
// launching.
extern "C" int repro_grouped_matmul_f32(
    const void* x, const void* w, void* out, int E, int C, int D, int F,
    long long sxe, long long sxc, long long sxd, long long swe,
    long long swd, long long swf, int rows, int threads, int x_kc,
    int x_vec, int w_kc, int w_vec, void* stream) {
  return launch<float>(x, w, out, E, C, D, F, sxe, sxc, sxd, swe, swd, swf,
                       rows, threads, x_kc, x_vec, w_kc, w_vec, stream);
}

extern "C" int repro_grouped_matmul_bf16(
    const void* x, const void* w, void* out, int E, int C, int D, int F,
    long long sxe, long long sxc, long long sxd, long long swe,
    long long swd, long long swf, int rows, int threads, int x_kc,
    int x_vec, int w_kc, int w_vec, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, E, C, D, F, sxe, sxc, sxd, swe,
                               swd, swf, rows, threads, x_kc, x_vec, w_kc,
                               w_vec, stream);
}
