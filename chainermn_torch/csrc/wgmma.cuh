// PTX wrappers of Hopper's asynchronous path (sm_90a), beside the
// mma.sync ones of mma_sync.cuh: the warpgroup matrix multiply (`wgmma`)
// and its shared-memory matrix descriptors, the `mbarrier`s that count
// threads and bytes, the Tensor Memory Accelerator's tiled loads
// (`cp.async.bulk.tensor`) and the register hand-over between warpgroups
// (`setmaxnreg`). Used by the fused CE forward (csrc/fused_ce.cu); each
// kernel source includes it inside its own translation unit, and nothing
// here has external linkage.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

// ------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; call once after the inits, before a __syncthreads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival that also announces `bytes` still to land (TMA's
// complete_tx counts them off)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed. A barrier that
// never completes (a lost arrival or byte count) traps after ~2^28 polls,
// seconds to minutes, so that the kernel fails instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  for (unsigned polls = 0; !mbar_try_wait(bar, parity); ++polls)
    if (polls == (1u << 28)) __trap();
}

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// the box of `map` at (c0 innermost, c1) into shared memory at `dst`
// (1024-byte aligned for the 128-byte swizzle), completing on `bar`;
// elements outside the tensor land as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// --------------------------------------------------------------- wgmma

// descriptor of a K-major bf16 operand in shared memory as TMA lays it
// with CU_TENSOR_MAP_SWIZZLE_128B: rows of 64 elements (128 bytes),
// swizzled in groups of 8 rows (1024 bytes, the stride byte offset).
// `addr` is the shared-memory byte address of the operand's first row at
// the wanted depth: a 16-deep step inside the 128-byte row adds 32 bytes
// (the hardware applies the swizzle to the address bits, so the group
// must start 1024-byte aligned). Leading byte offset unused (0) for a
// swizzled K-major operand; layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define CHAINERMN_WG_OUT4(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define CHAINERMN_WG_OUT16(i)                                         \
  CHAINERMN_WG_OUT4(i), CHAINERMN_WG_OUT4(i + 4), CHAINERMN_WG_OUT4(i + 8), \
      CHAINERMN_WG_OUT4(i + 12)

// d[64 x 256] (+)= a[64 x 16] . b[16 x 256]: bf16 operands, both K-major
// in shared memory (descriptors `da`, `db`), f32 accumulators in
// registers. scale_d 0 overwrites d, 1 accumulates. Lane l of warp w of
// the warpgroup holds d[i] at row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2.
__device__ __forceinline__ void wgmma_m64n256k16_bf16(float (&d)[128],
                                                      uint64_t da,
                                                      uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : CHAINERMN_WG_OUT16(0), CHAINERMN_WG_OUT16(16),
        CHAINERMN_WG_OUT16(32), CHAINERMN_WG_OUT16(48),
        CHAINERMN_WG_OUT16(64), CHAINERMN_WG_OUT16(80),
        CHAINERMN_WG_OUT16(96), CHAINERMN_WG_OUT16(112)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef CHAINERMN_WG_OUT16
#undef CHAINERMN_WG_OUT4

// ------------------------------------------------------------ setmaxnreg

// hand registers between warpgroups: every warp of the warpgroup runs it,
// in a branch that never rejoins the others (else ptxas ignores it)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace
