// Helpers shared by the flash-attention kernels (csrc/flash_fwd.cu,
// csrc/flash_bwd.cu): the tile shape and the tile loaders of both paths,
// over the tensor-core PTX wrappers of mma_sync.cuh. Each kernel source
// includes it inside its own translation unit; nothing here has external
// linkage.

#pragma once

#include "mma_sync.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int NTHREADS = 128; // 4 warps (bf16); 16 row groups x 8 lanes (f32)

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
