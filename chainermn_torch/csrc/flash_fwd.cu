// Flash-attention forward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel `_fa_kernel` (chainermn_tpu/ops/flash_attention.py,
// launched by `_flash_fwd_3d`): blockwise attention with an online softmax
// that returns O and the per-row logsumexp, never writing the [Lq, Lk] score
// matrix to device memory.
//
// What bounds it: at the serving prefill shape ([2, 2048, 12, 64] bf16,
// causal) the work is ~12.9 GFLOP against ~25 MB of q/k/v/o, so the card is
// bound by operations, far above the bytes line. This first version does the
// two products with f32 FMAs on the CUDA cores, not the tensor cores, so it
// sits well under the bf16 tensor-core roofline; `mma`/`wgmma` and TMA are the
// next step. What the design does about the bound it has: K/V tiles are
// staged once per CTA in shared memory and reused by all 64 query rows, each
// thread keeps a 4x8 register tile of scores, tiles above the causal diagonal
// or outside the sliding window are never visited, and shared-memory rows are
// padded so the 16-byte reads are bank-conflict free.
//
// Layout: q [B, Lq, Hq, D], k/v [B, Lk, Hkv, D], read in place through their
// strides (last dim contiguous); out [B, Lq, Hq, D] contiguous; lse
// [B, Hq, Lq] f32. GQA: query head h reads KV head h / (Hq / Hkv). Causal
// indices are top-left aligned (row i sees columns <= i), as in the TPU
// kernel's `_tile_scores`. Masked scores are the finite -1e30 and their
// probabilities are forced to exactly 0, so a fully masked row (segment ids)
// gives out == 0 and lse == -1e30.
//
// Numerics: Q.K^T from native-dtype operands with f32 accumulation (bf16
// products are exact in f32), P rounded to V's dtype before P.V, softmax
// state in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // key rows per K/V tile
constexpr int NTHREADS = 128; // 16 row groups x 8 column lanes
constexpr int RPT = 4;        // query rows per thread
constexpr int CPT = BK / 8;   // score columns per thread
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  const int* qseg;
  const int* kseg;
  int B, Lq, Lk, Hq, Hkv;
  long long qsb, qsl, qsh;
  long long ksb, ksl, ksh;
  long long vsb, vsl, vsh;
  float scale;
  int causal;
  int window;  // <= 0: no window
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// [rows x D] tile from strided global memory into f32 shared memory with
// row stride `ld`; rows at or beyond `nrows` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int nrows) {
  constexpr int CHUNKS = D / 4;
  for (int idx = threadIdx.x; idx < BK * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) val = load4(src + r * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Params p) {
  static_assert(D % 8 == 0 && D <= 128, "D must be a multiple of 8, <= 128");
  static_assert(BQ == BK, "load_tile serves Q and K/V tiles of one height");
  constexpr int LDQ = D + 4, LDK = D + 4, LDV = D, LDP = BK + 1;
  constexpr int DPT = D / 8;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * LDQ;
  float* sV = sK + BK * LDK;
  float* sP = sV + BK * LDV;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = bh / p.Hq;
  const int h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * BQ;
  const int rg = threadIdx.x / 8;  // row group: rows r0 .. r0 + RPT - 1
  const int cg = threadIdx.x % 8;  // lane within the row group's 8 lanes
  const int r0 = rg * RPT;

  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;
  load_tile<T, D>(sQ, LDQ, qb + q0 * p.qsl, p.qsl, min(BQ, p.Lq - q0));

  int qs[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + r0 + i;
    qs[i] = (p.qseg != nullptr && row < p.Lq) ? p.qseg[b * p.Lq + row] : 0;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // live K/V range: causal rows < q0 + BQ see no column beyond them; a
  // window hides every column <= q0 - window from the tile's first row
  int kend = p.Lk;
  int kbeg = 0;
  if (p.causal) {
    kend = min(kend, q0 + BQ);
    if (p.window > 0) kbeg = max(0, q0 - p.window + 1) / BK * BK;
  }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    const int nk = min(BK, p.Lk - k0);
    __syncthreads();  // previous tile's sK/sV/sP reads are done
    load_tile<T, D>(sK, LDK, kb + k0 * p.ksl, p.ksl, nk);
    load_tile<T, D>(sV, LDV, vb + k0 * p.vsl, p.vsl, nk);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = load4(sQ + (r0 + i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = load4(sK + (cg + 8 * j) * LDK + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    int ks[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = k0 + cg + 8 * j;
      ks[j] = (p.kseg != nullptr && col < p.Lk) ? p.kseg[b * p.Lk + col] : 0;
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + r0 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + cg + 8 * j;
        bool keep = col < p.Lk;
        if (p.causal) {
          keep = keep && col <= row;
          if (p.window > 0) keep = keep && row - col < p.window;
        }
        if (p.qseg != nullptr) keep = keep && qs[i] == ks[j];
        s[i][j] = keep ? s[i][j] * p.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 lanes of a row group are consecutive lanes of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pv = s[i][j] <= 0.5f * NEG ? 0.f : expf(s[i][j] - m_new);
        rs += pv;
        sP[(r0 + i) * LDP + cg + 8 * j] = round_to<T>(pv);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // sP complete

    // rows of sV beyond nk are zero and their sP entries are 0
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pr[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = sP[(r0 + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = sV[kk * LDV + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + r0 + i;
    if (row >= p.Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + ((static_cast<long long>(b) * p.Lq + row) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) store(orow + cg + 8 * j, acc[i][j] / denom);
    if (cg == 0)
      p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Lq + row] =
          m[i] + logf(denom);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.Hq, (p.Lq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
#define CASE(DD) \
  case DD:       \
    return launch<T, DD>(p, stream);
    CASE(8) CASE(16) CASE(24) CASE(32) CASE(40) CASE(48) CASE(56) CASE(64)
    CASE(72) CASE(80) CASE(88) CASE(96) CASE(104) CASE(112) CASE(120)
    CASE(128)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// launch's cudaError_t (0 on success); the wrapper raises on anything else.
extern "C" int chainermn_flash_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* qseg, const int* kseg, int dtype, int B, int Lq, int Lk,
    int Hq, int Hkv, int D, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb,
    long long vsl, long long vsh, float scale, int causal, int window,
    void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      (Lq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,   k,   v,   out, lse, qseg, kseg, B,     Lq,     Lk,
           Hq,  Hkv, qsb, qsl, qsh, ksb,  ksl,  ksh,   vsb,    vsl,
           vsh, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
