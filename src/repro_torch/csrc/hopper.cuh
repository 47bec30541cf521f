// Hopper (sm_90a) building blocks of the port's kernels: thin inline-PTX
// wrappers for cp.async copies, mbarriers, named barriers, 1-D bulk copies,
// 3-D and 4-D TMA tensor loads, 3-D TMA tensor stores and their bulk
// groups, stmatrix, the wgmma shared-memory descriptor and instructions (A
// from shared memory or from registers), and setmaxnreg, plus the
// host-side encoders of TMA tensor maps.  The encodings follow the
// PTX ISA
// (as CUTLASS's cute/arch/mma_sm90_desc.hpp, mma_sm90_gmma.hpp and
// copy_sm90_tma.hpp spell them out).
//
// The tensor maps come from libcuda's cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPointByVersion (CUDA 12.5 and later; the
// unversioned lookup is deprecated there), so the library needs no -lcuda.

#pragma once

#include <cuda.h>              // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- cp.async

// 16 bytes global -> shared, bypassing L1; bytes past `src_bytes` are
// zero-filled (0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// waits until at most N committed cp.async groups of this thread are
// still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes initialised barriers visible to the async proxy (TMA); follow it
// with a block-wide barrier before any thread uses them
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed (on a fresh
// barrier parity 1 counts as completed).  A wait that polls 2^28 times
// (seconds) traps: a lost completion becomes a launch error, not a hung
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 28)) __trap();
}

// bar.sync on a named barrier (id 1-15) among `threads` threads
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// arrives at named barrier `id` (1-15) without waiting: with a bar.sync
// of the same id and count it hands shared-memory writes to the waiters
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ TMA

// Copies `bytes` (a multiple of 16) contiguous bytes from `src` to shared
// memory at `dst`, both 16-byte aligned; completion is reported to `bar`
// as transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Copies the box at coordinates (c0 innermost, c1, c2) of `map` into
// shared memory at `dst`; completion is reported to `bar` as transaction
// bytes.  Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 4-D map: coordinates (c0 innermost, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Copies the box at coordinates (c0 innermost, c1, c2) of `map` from
// shared memory at `src` to global memory (parts outside the tensor are
// not written), as one bulk group of this thread's (commit it after).
// Shared-memory writes of other threads must be made visible to the
// async proxy first (fence_proxy_async by each writer, then a barrier).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed bulk groups still read
// their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// waits until at most N of this thread's committed bulk groups are
// incomplete (their global writes done)
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// orders this thread's shared-memory writes before later async-proxy
// (TMA) accesses of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8 x 8 b16 matrices from the warp's registers to shared memory,
// transposed: thread t's r[i] holds (row t / 4, columns 2 (t % 4) and
// + 1, the lower column in the low half) of matrix i, and threads 8 i ..
// 8 i + 7 give the addresses of matrix i's stored rows (16 bytes each:
// its columns become rows).  The x2 form: matrices 0 and 1, addresses
// from threads 0 - 15.
__device__ __forceinline__ void stmatrix_x4_trans(void* row,
                                                  const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n"
      :: "r"(smem_u32(row)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}
__device__ __forceinline__ void stmatrix_x2_trans(void* row,
                                                  const uint32_t (&r)[2]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n"
      :: "r"(smem_u32(row)), "r"(r[0]), "r"(r[1])
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor with the 128-byte swizzle (layout type
// 1 in bits 62-63).  Address and byte offsets go in 16-byte units: start
// address bits 0-13, leading byte offset (LBO) 16-29, stride byte offset
// (SBO) 32-45, base offset 0 (every swizzle atom starts 1024-aligned).
// K-major operand: rows of 128 bytes, SBO the stride of 8-row groups, LBO
// unused (16).  MN-major operand: SBO the stride of 8-row groups along K,
// LBO the stride of 64-element groups along M or N.  Adding bytes >> 4 to
// the descriptor moves its start address.
__device__ __forceinline__ uint64_t desc_sw128(const void* smem,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// orders this thread's register and shared-memory writes before the
// warpgroup's next wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that writes them
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d[0 .. N/2) += A (64 x 16) * B (16 x N), bf16 operands from shared memory
// through descriptors a and b, fp32 accumulators in registers; N any
// multiple of 8 up to 256, one instruction (A is read from shared memory
// once, where a sum of narrower products reads it once for each).  TA = 1:
// A is MN-major (transposed), TB = 1: B is MN-major.  Thread t of the
// warpgroup holds, in d[q], row 16 (t / 32) + (t % 32) / 4 + 8 ((q / 2) % 2)
// and column 8 (q / 4) + 2 (t % 4) + q % 2 of the 64 x N product.
#define HOPPER_D4(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b) {
  static_assert(N % 8 == 0 && N >= 8 && N <= 256,
                "wgmma_bf16: N is a multiple of 8 up to 256");
  if constexpr (N == 8) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : HOPPER_D4(0)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 16) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 24) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, %15, %16;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 40) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19"
      "}, %20, %21, p, 1, 1, %23, %24;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 48) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 56) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27"
      "}, %28, %29, p, 1, 1, %31, %32;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 72) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
      "}, %36, %37, p, 1, 1, %39, %40;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 80) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39"
      "}, %40, %41, p, 1, 1, %43, %44;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 88) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %46, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43"
      "}, %44, %45, p, 1, 1, %47, %48;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 96) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 104) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51"
      "}, %52, %53, p, 1, 1, %55, %56;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 112) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, %59, %60;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 120) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59"
      "}, %60, %61, p, 1, 1, %63, %64;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 136) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67"
      "}, %68, %69, p, 1, 1, %71, %72;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 144) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, %75, %76;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 152) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %78, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75"
      "}, %76, %77, p, 1, 1, %79, %80;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 160) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, %83, %84;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 168) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %86, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n168k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83"
      "}, %84, %85, p, 1, 1, %87, %88;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76),
        HOPPER_D4(80)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 176) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87"
      "}, %88, %89, p, 1, 1, %91, %92;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76),
        HOPPER_D4(80), HOPPER_D4(84)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 184) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %94, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91"
      "}, %92, %93, p, 1, 1, %95, %96;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76),
        HOPPER_D4(80), HOPPER_D4(84), HOPPER_D4(88)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 192) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76),
        HOPPER_D4(80), HOPPER_D4(84), HOPPER_D4(88), HOPPER_D4(92)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 200) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      " %98, %99"
      "}, %100, %101, p, 1, 1, %103, %104;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76),
        HOPPER_D4(80), HOPPER_D4(84), HOPPER_D4(88), HOPPER_D4(92),
        HOPPER_D4(96)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 208) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      " %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p, 1, 1, %107, %108;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76),
        HOPPER_D4(80), HOPPER_D4(84), HOPPER_D4(88), HOPPER_D4(92),
        HOPPER_D4(96), HOPPER_D4(100)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 216) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %110, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n216k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107"
      "}, %108, %109, p, 1, 1, %111, %112;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76),
        HOPPER_D4(80), HOPPER_D4(84), HOPPER_D4(88), HOPPER_D4(92),
        HOPPER_D4(96), HOPPER_D4(100), HOPPER_D4(104)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 224) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111"
      "}, %112, %113, p, 1, 1, %115, %116;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76),
        HOPPER_D4(80), HOPPER_D4(84), HOPPER_D4(88), HOPPER_D4(92),
        HOPPER_D4(96), HOPPER_D4(100), HOPPER_D4(104), HOPPER_D4(108)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 232) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %118, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n232k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111, %112, %113, %114, %115"
      "}, %116, %117, p, 1, 1, %119, %120;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76),
        HOPPER_D4(80), HOPPER_D4(84), HOPPER_D4(88), HOPPER_D4(92),
        HOPPER_D4(96), HOPPER_D4(100), HOPPER_D4(104), HOPPER_D4(108),
        HOPPER_D4(112)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 240) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %122, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117,"
      " %118, %119"
      "}, %120, %121, p, 1, 1, %123, %124;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76),
        HOPPER_D4(80), HOPPER_D4(84), HOPPER_D4(88), HOPPER_D4(92),
        HOPPER_D4(96), HOPPER_D4(100), HOPPER_D4(104), HOPPER_D4(108),
        HOPPER_D4(112), HOPPER_D4(116)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 248) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %126, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n248k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117,"
      " %118, %119, %120, %121, %122, %123"
      "}, %124, %125, p, 1, 1, %127, %128;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76),
        HOPPER_D4(80), HOPPER_D4(84), HOPPER_D4(88), HOPPER_D4(92),
        HOPPER_D4(96), HOPPER_D4(100), HOPPER_D4(104), HOPPER_D4(108),
        HOPPER_D4(112), HOPPER_D4(116), HOPPER_D4(120)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 256) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117,"
      " %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : HOPPER_D4(0), HOPPER_D4(4), HOPPER_D4(8), HOPPER_D4(12),
        HOPPER_D4(16), HOPPER_D4(20), HOPPER_D4(24), HOPPER_D4(28),
        HOPPER_D4(32), HOPPER_D4(36), HOPPER_D4(40), HOPPER_D4(44),
        HOPPER_D4(48), HOPPER_D4(52), HOPPER_D4(56), HOPPER_D4(60),
        HOPPER_D4(64), HOPPER_D4(68), HOPPER_D4(72), HOPPER_D4(76),
        HOPPER_D4(80), HOPPER_D4(84), HOPPER_D4(88), HOPPER_D4(92),
        HOPPER_D4(96), HOPPER_D4(100), HOPPER_D4(104), HOPPER_D4(108),
        HOPPER_D4(112), HOPPER_D4(116), HOPPER_D4(120), HOPPER_D4(124)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
}
#undef HOPPER_D4

// d[0 .. N/2) += A (64 x 16) * B (16 x N) with A from registers: a[0..3]
// hold, pair-packed (lower column in the low half), thread t's elements
// of its warp's 16 rows, (row r, col c), (r + 8, c), (r, c + 8), (r + 8,
// c + 8) for r = (t % 32) / 4 and c = 2 (t % 4): the layout of the
// accumulator fragment of 16 columns above, so a product's fp32 result,
// rounded to bf16 pairs, is the A operand of the next one.  B from shared
// memory through descriptor b; TB = 1: B is MN-major.
template <int N, int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float* d, const uint32_t (&a)[4],
                                              uint64_t b) {
  static_assert(N == 64 || N == 128 || N == 256,
                "wgmma_bf16_rs: no instance for this N");
  if constexpr (N == 64) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TB));
  } else if constexpr (N == 256) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TB));
  }

}

// ---------------------------------------------------------------- setmaxnreg

// the calling warpgroup gives up registers down to R per thread
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// the calling warpgroup takes registers up to R per thread from the pool
// the others gave up (waits until they are free)
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// -------------------------------------------------------- host: tensor maps

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled with its CUDA 12.0 signature, looked
// up once; null without it
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D bf16 tensor map over `base`: dimension 0 innermost and
// contiguous, sizes d0..d2, strides s1 and s2 in elements, boxes of b0 x
// b1 x 1 elements (b0 <= 64, one 128-byte row) loaded with the 128-byte
// swizzle and zeros outside the tensor.  Returns 0 or a CUDA error code.
inline int encode_bf16_3d_sw128(CUtensorMap* map, const void* base,
                                long long d0, long long d1, long long d2,
                                long long s1, long long s2, int b0, int b1) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1 * 2),
                                 static_cast<cuuint64_t>(s2 * 2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 4-D bf16 tensor map over `base`: dimension 0 innermost and
// contiguous, sizes d0..d3, strides s1..s3 in elements (any order: a
// (B,S,H,Dh) tensor is mapped as (Dh, S, H, B), so a box never crosses a
// head or batch edge), boxes of b0 x b1 x 1 x 1 elements (b0 <= 64) loaded
// with the 128-byte swizzle and zeros outside the tensor.  Returns 0 or a
// CUDA error code.
inline int encode_bf16_4d_sw128(CUtensorMap* map, const void* base,
                                long long d0, long long d1, long long d2,
                                long long d3, long long s1, long long s2,
                                long long s3, int b0, int b1) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
      static_cast<cuuint64_t>(d2), static_cast<cuuint64_t>(d3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s1 * 2),
                                 static_cast<cuuint64_t>(s2 * 2),
                                 static_cast<cuuint64_t>(s3 * 2)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 4-D tensor map over `base` of bf16 (elem_bytes 2) or fp32 (4):
// dimension 0 innermost and contiguous, sizes d0..d3, strides s1..s3 in
// elements (any order), boxes of b0 x b1 x b2 x b3 elements loaded as
// they lie (no swizzle), zeros outside the tensor.  Returns 0 or a CUDA
// error code.
inline int encode_4d(CUtensorMap* map, const void* base, int elem_bytes,
                     long long d0, long long d1, long long d2, long long d3,
                     long long s1, long long s2, long long s3, int b0,
                     int b1, int b2, int b3) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
      static_cast<cuuint64_t>(d2), static_cast<cuuint64_t>(d3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s1 * elem_bytes),
                                 static_cast<cuuint64_t>(s2 * elem_bytes),
                                 static_cast<cuuint64_t>(s3 * elem_bytes)};
  const cuuint32_t box[4] = {
      static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1),
      static_cast<cuuint32_t>(b2), static_cast<cuuint32_t>(b3)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
