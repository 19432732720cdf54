// Helpers shared by the flash-attention kernels (csrc/flash_fwd.cu,
// csrc/flash_bwd.cu): the tile shape, the PTX wrappers of the bf16
// tensor-core path (cp.async, ldmatrix, mma.sync m16n8k16, ex2) and the tile
// loaders of both paths. Each kernel source includes it inside its own
// translation unit; nothing here has external linkage.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int NTHREADS = 128; // 4 warps (bf16); 16 row groups x 8 lanes (f32)
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: tensor cores

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared; a zero source size zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; results below 2^-126 flush to 0, far
// under a bf16 P's resolution
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// [64 x DP] bf16 tile from strided global memory into shared memory (row
// stride DP + 8), 16 bytes per cp.async; rows >= nrows and columns >= d are
// zero-filled
template <int DP>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long row_stride,
                                                int nrows, int d) {
  constexpr int LD = DP + 8;
  constexpr int CHUNKS = DP / 8;
  for (int idx = threadIdx.x; idx < BK * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    const bool ok = r < nrows && c < d;
    cp_async16(dst + r * LD + c, ok ? src + r * row_stride + c : src, ok);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// [64 x DP] tile from strided global memory into f32 shared memory with row
// stride `ld`; rows >= nrows and columns >= d are zero-filled.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long row_stride, int nrows,
                                          int d) {
  constexpr int CHUNKS = DP / 4;
  for (int idx = threadIdx.x; idx < BK * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows && c < d) val = load4(src + r * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

}  // namespace
