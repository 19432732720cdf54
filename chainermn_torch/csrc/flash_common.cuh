// Helpers shared by the flash-attention kernels (csrc/flash_fwd.cu,
// csrc/flash_bwd.cu): the tile shape, the bf16 tile loader over the
// tensor-core PTX wrappers of mma_sync.cuh, and the f32 paths' CTA size,
// shared-memory layout, tile loader and 16-byte reads. Each kernel source
// includes it inside its own translation unit; nothing here has external
// linkage.

#pragma once

#include "mma_sync.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int NTHREADS = 128; // 4 warps (bf16)

// ---------------------------------------------------------------------------
// bf16: tensor cores (the PTX wrappers are in mma_sync.cuh)

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

constexpr int FNT = 256;  // threads of an f32 CTA: 8 warps, one CTA an SM

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// offset of (row, col) in shared-memory rows of LD floats; swizzled (LD a
// multiple of 32), quad col / 4 of a row sits at quad (col / 4) ^ (row %
// 8), so that 8 rows read at one column fall in 8 bank quads unpadded
template <int LD, bool SWZ = false>
__device__ __forceinline__ int at(int row, int col) {
  return row * LD + (SWZ ? col ^ ((row & 7) << 2) : col);
}

// ROWS x DP f32 tile from strided global memory into shared memory laid out
// by `at`, 16 bytes per cp.async by the CTA's FNT threads; rows >= nrows and
// columns >= d are zero-filled (their copies read nothing and point at
// `src`)
template <int ROWS, int DP, int LD, bool SWZ = false>
__device__ __forceinline__ void fma_tile_async(float* dst, const float* src,
                                               long long row_stride,
                                               int nrows, int d) {
  constexpr int CH = DP / 4;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += FNT) {
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    const bool ok = r < nrows && c < d;
    cp_async16(dst + at<LD, SWZ>(r, c), ok ? src + r * row_stride + c : src,
               ok);
  }
}

// VEC consecutive floats of shared memory, in one read
template <int VEC>
__device__ __forceinline__ void lds_vec(float (&x)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = load4(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

}  // namespace
