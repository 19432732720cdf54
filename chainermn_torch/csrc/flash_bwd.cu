// Flash-attention backward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel `_fa_bwd_fused_kernel` (chainermn_tpu/ops/
// flash_attention.py, launched by `_flash_bwd_3d`), and computes what the
// split pair `_fa_bwd_dq_kernel` / `_fa_bwd_dkv_kernel` compute beyond that
// kernel's VMEM envelope (windowed attention, causal Lq != Lk, Lk > 2048):
// dq, dk and dv from one rebuild of each score tile, with
//   P  = exp(S * scale - lse)        (masked entries exactly 0),
//   dP = dO . V^T,
//   dS = P o (dP - Dr) * scale,       Dr = rowsum(dO o O), f32, from the
//                                     caller,
//   dV += P^T . dO,  dK += dS^T . Q,  dQ += dS . K.
// The [Lq, Lk] matrices never reach device memory.
//
// Schedule (FlashAttention-2's): one CTA per (64-key tile, batch, KV head).
// K and V of the tile stay in shared memory; the CTA loops over the query
// heads that share its KV head (GQA/MQA: the group is summed inside the CTA,
// K/V are never repeated) and over the query tiles that see the key tile
// (tiles above the causal diagonal or outside the sliding window are
// skipped, as `_causal_live` skips them). dK and dV accumulate in registers
// across that whole loop and are written once, in the input dtype. dQ gets
// contributions from many CTAs, so it is summed with f32 atomicAdd into an
// f32 buffer the wrapper zeroes and casts afterwards: the summation order
// varies from run to run, so dq is reproducible only to f32 rounding.
//
// The TPU kernel's whole-Lk f32 dk/dv scratch, its 2 MiB / Lk <= 2048
// envelope and the slabbed fallback are VMEM artifacts and have no
// counterpart: nothing here grows with Lk.
//
// What bounds it: at the training shape ([4, 2048, 12, 64] bf16, causal) the
// five products are ~64.5 GFLOP against ~44 MB of q/k/v/o/do/dq/dk/dv, so
// the card is bound by operations. This first version runs the products with
// f32 FMAs on the CUDA cores (no tensor cores), like csrc/flash_fwd.cu; each
// thread keeps a 4x8 register tile of S and dP and a 4x(D/8) tile of dK and
// dV, shared-memory rows are padded against bank conflicts, and the work of a
// causal tile that is only partly visible is masked, not branched.
//
// Layout: q/do [B, Lq, Hq, D], k/v [B, Lk, Hkv, D], read in place through
// their strides (last dim contiguous); lse and Dr [B, Hq, Lq] f32; dq_acc
// [B, Lq, Hq, D] f32 (zeroed by the caller); dk/dv [B, Lk, Hkv, D]
// contiguous in the input dtype. Causal indices are top-left aligned (row i
// sees columns <= i), a window keeps i - window < j, segment ids keep
// qseg[i] == kseg[j]; a row that sees no key gets exactly zero gradient.
//
// Numerics as in the TPU kernel: S and dP from native-dtype operands with
// f32 accumulation, P rounded to dO's dtype before P^T.dO, dS rounded to the
// input dtype before dS^T.Q and dS.K, accumulators in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;        // query rows per inner tile
constexpr int BK = 64;        // key rows per CTA
constexpr int NTHREADS = 128; // 16 row groups x 8 column lanes
constexpr int RPT = 4;        // rows per thread
constexpr int CPT = BK / 8;   // score columns per thread
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dr;
  const int* qseg;
  const int* kseg;
  float* dq;
  void* dk;
  void* dv;
  int B, Lq, Lk, Hq, Hkv;
  long long qsb, qsl, qsh;
  long long ksb, ksl, ksh;
  long long vsb, vsl, vsh;
  long long osb, osl, osh;
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

// [64 x D] tile from strided global memory into f32 shared memory with row
// stride `ld`; rows at or beyond `nrows` are zero-filled.
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
  return 4 * BK * (D + 4) + 2 * BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_kernel(Params p) {
  static_assert(D % 8 == 0 && D <= 128, "D must be a multiple of 8, <= 128");
  static_assert(BQ == BK, "load_tile serves Q and K/V tiles of one height");
  constexpr int LD = D + 4, LDP = BK + 1;
  constexpr int DPT = D / 8;  // head-dim columns per thread
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;   // dO
  float* sP = sO + BQ * LD;   // P rounded to dO's dtype
  float* sS = sP + BQ * LDP;  // dS rounded to the input dtype

  const int bh = blockIdx.x;  // b * Hkv + hk
  const int kt = blockIdx.y;  // heaviest causal tiles (small kt) first
  const int b = bh / p.Hkv;
  const int hk = bh % p.Hkv;
  const int group = p.Hq / p.Hkv;
  const int k0 = kt * BK;
  const int nk = min(BK, p.Lk - k0);
  const int rg = threadIdx.x / 8;
  const int cg = threadIdx.x % 8;
  const int r0 = rg * RPT;

  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;
  load_tile<T, D>(sK, LD, kb + k0 * p.ksl, p.ksl, nk);
  load_tile<T, D>(sV, LD, vb + k0 * p.vsl, p.vsl, nk);

  int ks[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int col = k0 + cg + 8 * j;
    ks[j] = (p.kseg != nullptr && col < p.Lk) ? p.kseg[b * p.Lk + col] : 0;
  }

  // query rows that can see a column of this tile
  int qbeg = 0, qend = p.Lq;
  if (p.causal) {
    qbeg = k0 / BQ * BQ;
    if (p.window > 0) qend = min(qend, k0 + BK - 1 + p.window);
  }

  float dk[RPT][DPT], dv[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const T* qb = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
    const T* ob = static_cast<const T*>(p.dout) + b * p.osb + h * p.osh;
    const float* lse_b = p.lse + (static_cast<long long>(b) * p.Hq + h) * p.Lq;
    const float* dr_b = p.dr + (static_cast<long long>(b) * p.Hq + h) * p.Lq;
    for (int q0 = qbeg; q0 < qend; q0 += BQ) {
      const int nq = min(BQ, p.Lq - q0);
      __syncthreads();  // previous tile's sQ/sO/sP/sS reads are done
      load_tile<T, D>(sQ, LD, qb + q0 * p.qsl, p.qsl, nq);
      load_tile<T, D>(sO, LD, ob + q0 * p.osl, p.osl, nq);
      __syncthreads();

      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qv[RPT], ov[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          qv[i] = load4(sQ + (r0 + i) * LD + d);
          ov[i] = load4(sO + (r0 + i) * LD + d);
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float4 kv = load4(sK + (cg + 8 * j) * LD + d);
          const float4 vv = load4(sV + (cg + 8 * j) * LD + d);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            float t = s[i][j];
            t = fmaf(qv[i].x, kv.x, t);
            t = fmaf(qv[i].y, kv.y, t);
            t = fmaf(qv[i].z, kv.z, t);
            t = fmaf(qv[i].w, kv.w, t);
            s[i][j] = t;
            float u = dp[i][j];
            u = fmaf(ov[i].x, vv.x, u);
            u = fmaf(ov[i].y, vv.y, u);
            u = fmaf(ov[i].z, vv.z, u);
            u = fmaf(ov[i].w, vv.w, u);
            dp[i][j] = u;
          }
        }
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = q0 + r0 + i;
        const bool live = row < p.Lq;
        const int qs = (p.qseg != nullptr && live) ? p.qseg[b * p.Lq + row]
                                                   : 0;
        const float l = live ? lse_b[row] : 0.f;
        const float dri = live ? dr_b[row] : 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = k0 + cg + 8 * j;
          bool keep = live && col < p.Lk;
          if (p.causal) {
            keep = keep && col <= row;
            if (p.window > 0) keep = keep && row - col < p.window;
          }
          if (p.qseg != nullptr) keep = keep && qs == ks[j];
          const float pr = keep ? expf(s[i][j] * p.scale - l) : 0.f;
          const float ds = pr * (dp[i][j] - dri) * p.scale;
          sP[(r0 + i) * LDP + cg + 8 * j] = round_to<T>(pr);
          sS[(r0 + i) * LDP + cg + 8 * j] = round_to<T>(ds);
        }
      }
      __syncthreads();  // sP, sS complete

      // dV += P^T dO and dK += dS^T Q: this thread owns key rows
      // r0 .. r0 + 3 of the tile and head-dim columns cg + 8 j
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pc[RPT], sc[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pc[i] = sP[qq * LDP + r0 + i];
          sc[i] = sS[qq * LDP + r0 + i];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float ov = sO[qq * LD + cg + 8 * j];
          const float qv = sQ[qq * LD + cg + 8 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            dv[i][j] = fmaf(pc[i], ov, dv[i][j]);
            dk[i][j] = fmaf(sc[i], qv, dk[i][j]);
          }
        }
      }

      // dQ += dS K for query rows r0 .. r0 + 3, atomically into f32
      float dq[RPT][DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) dq[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float sc[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) sc[i] = sS[(r0 + i) * LDP + kk];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float kv = sK[kk * LD + cg + 8 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) dq[i][j] = fmaf(sc[i], kv, dq[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = q0 + r0 + i;
        if (row >= p.Lq) continue;
        float* dqrow =
            p.dq + ((static_cast<long long>(b) * p.Lq + row) * p.Hq + h) * D;
#pragma unroll
        for (int j = 0; j < DPT; ++j) atomicAdd(dqrow + cg + 8 * j, dq[i][j]);
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk);
  T* dvb = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + r0 + i;
    if (row >= p.Lk) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Lk + row) * p.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      store(dkb + off + cg + 8 * j, dk[i][j]);
      store(dvb + off + cg + 8 * j, dv[i][j]);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.Hkv, (p.Lk + BK - 1) / BK);
  flash_bwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the head dims the port's models and tests use; the wrapper refuses others
template <typename T>
int launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(p, stream);
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 40: return launch<T, 40>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; dout shares
// q's shape. Returns the launch's cudaError_t (0 on success); the wrapper
// raises on anything else.
extern "C" int chainermn_flash_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dr, const int* qseg, const int* kseg,
    float* dq, void* dk, void* dv, int dtype, int B, int Lq, int Lk, int Hq,
    int Hkv, int D, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb,
    long long vsl, long long vsh, long long osb, long long osl,
    long long osh, float scale, int causal, int window, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      (Lk + BK - 1) / BK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,   k,   v,   dout, lse, dr,  qseg, kseg, dq,    dk,
           dv,  B,   Lq,  Lk,   Hq,  Hkv, qsb,  qsl,  qsh,   ksb,
           ksl, ksh, vsb, vsl,  vsh, osb, osl,  osh,  scale, causal,
           window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
