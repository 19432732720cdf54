// Flash-attention forward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel `_fa_kernel` (chainermn_tpu/ops/flash_attention.py,
// launched by `_flash_fwd_3d`): blockwise attention with an online softmax
// that returns O and the per-row logsumexp, never writing the [Lq, Lk] score
// matrix to device memory.
//
// What bounds it: at the training shape ([4, 2048, 12, 64] bf16, causal) the
// two products are ~25.8 GFLOP against ~25 MB of q/k/v/o, so the card is
// bound by operations: 0.026 ms at the 989 TFLOP/s bf16 tensor-core peak.
// Only the tensor cores can come near that; the CUDA cores (67 TFLOP/s f32)
// cannot go under ~0.39 ms.
//
// bf16 path, FlashAttention-2's design on warp-level tensor cores:
// * one CTA owns 64 query rows of one (batch, head): 4 warps x 16 rows;
// * Q is copied to shared memory once and held in registers as the A
//   fragments of `mma.sync.m16n8k16` (bf16 in, f32 accumulate) for the
//   whole K/V loop;
// * K/V tiles of 64 keys stream through a two-stage `cp.async` ring: the
//   next tile's copy is in flight while the current one computes;
// * shared-memory rows are padded by 16 bytes, so the 8 row addresses of
//   every `ldmatrix` phase fall in 8 distinct bank groups;
// * S = Q.K^T accumulates in f32 fragments; the online softmax runs on
//   them (row max and sum through quad shuffles, exp2 with log2(e) folded
//   into the scale, lse returned in natural log);
// * P is rounded to bf16 in registers and used directly as the A operand
//   of P.V (the accumulator layout of m16n8 is the A layout of m16k16), V
//   is read with `ldmatrix.trans`: P never touches shared memory;
// * masking runs only on tiles that need it (the causal diagonal, the
//   window edge, a ragged tail, any segment ids); tiles above the diagonal
//   or outside the window are never visited; CTAs are launched heaviest
//   causal tile first.
// D is padded to the next multiple of 16 with zeros in shared memory
// (cp.async with a zero source size), so 8 template widths cover every
// head dim that is a multiple of 8 up to 128.
//
// Not used, and what it would add: Hopper's `wgmma` (one warpgroup issues a
// 64-row product asynchronously, B straight from shared memory) and TMA
// (one thread copies a whole tile, completion on an mbarrier) would free the
// registers and instructions that ldmatrix and cp.async spend, and let a
// warp-specialised producer overlap loads with two consumer warpgroups. The
// fragment layouts, masks and tile schedule here are what such a version
// reuses; `mma.sync` is what PyTorch's own flash backend runs on this card.
//
// f32 path: the CUDA-core FMA loop of the first version. The f32 contract
// (1e-4 against the plain version) is tighter than TF32's 10-bit mantissa,
// and f32 is not the main path's dtype.
//
// Layout: q [B, Lq, Hq, D], k/v [B, Lk, Hkv, D], read in place through their
// strides (last dim contiguous; rows 16-byte aligned); out [B, Lq, Hq, D]
// contiguous; lse [B, Hq, Lq] f32. GQA: query head h reads KV head
// h / (Hq / Hkv). Causal indices are top-left aligned (row i sees columns
// <= i), as in the TPU kernel's `_tile_scores`. Masked scores are the
// finite -1e30 and their probabilities are forced to exactly 0, so a fully
// masked row (segment ids) gives out == 0 and lse == -1e30.
//
// Numerics: Q.K^T from native-dtype operands with f32 accumulation (bf16
// products are exact in f32), P rounded to V's dtype before P.V, softmax
// state in f32.

#include "flash_common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  const int* qseg;
  const int* kseg;
  int B, Lq, Lk, Hq, Hkv, D;
  long long qsb, qsl, qsh;
  long long ksb, ksl, ksh;
  long long vsb, vsl, vsh;
  float scale;
  int causal;
  int window;  // <= 0: no window
};

// ---------------------------------------------------------------------------
// bf16: tensor cores

template <int DP>
constexpr int mma_smem_bytes() {
  return (BQ + 4 * BK) * (DP + 8) * 2;  // Q, then K and V of two stages
}

// up to DP 64, four CTAs fit an SM's shared memory; capping registers at
// 128 lets them all be resident. `chip_smoke.py` times this build
// beside one with -DFLASH_FWD_MIN_CTAS=1 (no cap); PERF.md keeps the
// reading
#ifndef FLASH_FWD_MIN_CTAS
#define FLASH_FWD_MIN_CTAS 4
#endif
template <int DP>
__global__ void __launch_bounds__(NTHREADS, DP <= 64 ? FLASH_FWD_MIN_CTAS : 1)
    flash_fwd_mma(Params p) {
  constexpr int LD = DP + 8;
  constexpr int KB = DP / 16;  // 16-deep steps over the head dim
  constexpr int NB = DP / 8;   // 8-wide output column blocks
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);
  bf16* sK = sQ + BQ * LD;      // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;  // [2][BK][LD]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = bh / p.Hq;
  const int h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // accumulator row (and row + 8)
  const int tig = lane % 4;  // accumulator columns 2 tig, 2 tig + 1
  const int lr = lane % 8;   // ldmatrix: row within an 8x8 matrix
  const int li = lane / 8;   // ldmatrix: which of the four matrices

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.ksb + hk * p.ksh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.vsb + hk * p.vsh;

  // live K/V range: causal rows < q0 + BQ see no column beyond them; a
  // window hides every column <= q0 - window from the tile's first row
  int kend = p.Lk;
  int kbeg = 0;
  if (p.causal) {
    kend = min(kend, q0 + BQ);
    if (p.window > 0) kbeg = max(0, q0 - p.window + 1) / BK * BK;
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  load_tile_async<DP>(sQ, qb + q0 * p.qsl, p.qsl, min(BQ, p.Lq - q0), p.D);
  if (ntiles > 0) {
    const int nk = min(BK, p.Lk - kbeg);
    load_tile_async<DP>(sK, kb + kbeg * p.ksl, p.ksl, nk, p.D);
    load_tile_async<DP>(sV, vb + kbeg * p.vsl, p.vsl, nk, p.D);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  int qs[2] = {0, 0};
  if (p.qseg != nullptr) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + 8 * hf;
      if (row < p.Lq) qs[hf] = p.qseg[b * p.Lq + row];
    }
  }

  const float scale2 = p.scale * LOG2E;
  unsigned qf[KB][4];
  float o[NB][4];
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kbeg + t * BK;
    const int st = t & 1;
    if (t + 1 < ntiles) {
      const int k1 = k0 + BK;
      const int nk = min(BK, p.Lk - k1);
      load_tile_async<DP>(sK + (st ^ 1) * BK * LD, kb + k1 * p.ksl, p.ksl, nk,
                          p.D);
      load_tile_async<DP>(sV + (st ^ 1) * BK * LD, vb + k1 * p.vsl, p.vsl, nk,
                          p.D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) landed for every thread
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KB; ++kk)
        ldsm_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
    }
    const bf16* tK = sK + st * BK * LD;
    const bf16* tV = sV + st * BK * LD;

    // S = Q K^T: 16 rows x 64 keys per warp, in 8 column blocks
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        unsigned bfr[4];
        ldsm_x4(bfr, tK + (pr * 16 + lr + (li >> 1) * 8) * LD + kk * 16 +
                         (li & 1) * 8);
        mma_bf16(s[2 * pr], qf[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * pr + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    const bool need_mask =
        k0 + BK > p.Lk || p.qseg != nullptr ||
        (p.causal && (k0 + BK - 1 > q0 ||
                      (p.window > 0 && k0 <= q0 + BQ - 1 - p.window)));
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + 8 * (e >> 1);
          const int col = k0 + j * 8 + tig * 2 + (e & 1);
          bool keep = col < p.Lk;
          if (p.causal) {
            keep = keep && col <= row;
            if (p.window > 0) keep = keep && row - col < p.window;
          }
          if (keep && p.qseg != nullptr)
            keep = qs[e >> 1] == p.kseg[b * p.Lk + col];
          if (!keep) s[j][e] = NEG;
        }
    }

    // online softmax in log2 units; a row is shared by the 4 lanes of a
    // quad. With scale >= 0 (the wrapper negates q for a negative one) the
    // row max of S scale log2(e) is the raw max times that factor, so each
    // exponent is one FFMA.
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      mx[hf] = fmaxf(m[hf], mx[hf] * scale2);
      alpha[hf] = ex2(m[hf] - mx[hf]);
      m[hf] = mx[hf];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pv = (need_mask && x <= 0.5f * NEG)
                             ? 0.f
                             : ex2(x * scale2 - mx[e >> 1]);
        s[j][e] = pv;
        rs[e >> 1] += pv;
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + rs[hf];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P from registers (rounded to bf16), V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < KB; ++dp) {
        unsigned bfr[4];
        ldsm_x4_t(bfr, tV + (kk * 16 + lr + (li & 1) * 8) * LD + dp * 16 +
                           (li >> 1) * 8);
        mma_bf16(o[2 * dp], a, bfr[0], bfr[1]);
        mma_bf16(o[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // no tile at all: Q's copy is still pending

  bf16* ob = static_cast<bf16*>(p.out);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = row0 + 8 * hf;
    if (row >= p.Lq) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    bf16* orow =
        ob + ((static_cast<long long>(b) * p.Lq + row) * p.Hq + h) * p.D;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int col = j * 8 + tig * 2;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[j][2 * hf] * inv, o[j][2 * hf + 1] * inv);
    }
    if (tig == 0)
      p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Lq + row] =
          lt > 0.f ? m[hf] * LN2 + logf(lt) : NEG;  // 0: no visible key
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs

constexpr int RPT = 4;       // query rows per thread
constexpr int CPT = BK / 8;  // score columns per thread

template <int DP>
constexpr int fma_smem_bytes() {
  return (BQ * (DP + 4) + BK * (DP + 4) + BK * DP + BQ * (BK + 1)) * 4;
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_fma(Params p) {
  static_assert(BQ == BK, "load_tile serves Q and K/V tiles of one height");
  constexpr int LDQ = DP + 4, LDK = DP + 4, LDV = DP, LDP = BK + 1;
  constexpr int DPT = DP / 8;  // output columns per thread
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

  const float* qb = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kb = static_cast<const float*>(p.k) + b * p.ksb + hk * p.ksh;
  const float* vb = static_cast<const float*>(p.v) + b * p.vsb + hk * p.vsh;
  load_tile<DP>(sQ, LDQ, qb + q0 * p.qsl, p.qsl, min(BQ, p.Lq - q0), p.D);

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

  int kend = p.Lk;
  int kbeg = 0;
  if (p.causal) {
    kend = min(kend, q0 + BQ);
    if (p.window > 0) kbeg = max(0, q0 - p.window + 1) / BK * BK;
  }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    const int nk = min(BK, p.Lk - k0);
    __syncthreads();  // previous tile's sK/sV/sP reads are done
    load_tile<DP>(sK, LDK, kb + k0 * p.ksl, p.ksl, nk, p.D);
    load_tile<DP>(sV, LDV, vb + k0 * p.vsl, p.vsl, nk, p.D);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
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
        sP[(r0 + i) * LDP + cg + 8 * j] = pv;
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

  float* ob = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + r0 + i;
    if (row >= p.Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow =
        ob + ((static_cast<long long>(b) * p.Lq + row) * p.Hq + h) * p.D;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (cg + 8 * j < p.D) orow[cg + 8 * j] = acc[i][j] / denom;
    if (cg == 0)
      p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Lq + row] =
          m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------

template <typename Kernel>
int launch_kernel(Kernel kernel, int smem, const Params& p,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.Hq, (p.Lq + BQ - 1) / BQ);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch(const Params& p, bool bf16_path, cudaStream_t stream) {
  if (bf16_path)
    return launch_kernel(flash_fwd_mma<DP>, mma_smem_bytes<DP>(), p, stream);
  return launch_kernel(flash_fwd_fma<DP>, fma_smem_bytes<DP>(), p, stream);
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
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 8 ||
      D > 128 || D % 8 != 0 || (dtype != 0 && dtype != 1) || !(scale >= 0.f) ||
      (Lq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,   k,   v,   out, lse, qseg, kseg, B,   Lq,    Lk,
           Hq,  Hkv, D,   qsb, qsl, qsh,  ksb,  ksl, ksh,   vsb,
           vsl, vsh, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = dtype == 1;
  switch ((D + 15) / 16 * 16) {  // head dim padded to the next 16
    case 16: return launch<16>(p, tc, s);
    case 32: return launch<32>(p, tc, s);
    case 48: return launch<48>(p, tc, s);
    case 64: return launch<64>(p, tc, s);
    case 80: return launch<80>(p, tc, s);
    case 96: return launch<96>(p, tc, s);
    case 112: return launch<112>(p, tc, s);
    default: return launch<128>(p, tc, s);
  }
}
