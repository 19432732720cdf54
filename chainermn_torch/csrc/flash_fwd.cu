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
// f32 path (`flash_fwd_fma`), full f32 on the CUDA cores: the f32 contract
// (1e-4 against the plain version) is tighter than TF32's 10-bit mantissa;
// an f32 model (the JAX TransformerLM's default) runs it. At [4, 2048, 12,
// 64] causal it is bound by its 25.8 GFLOP of FMAs (0.385 ms at 67
// TFLOP/s), so the design spends as little as it can beside the FMAs:
// * one CTA owns 128 query rows of one (batch, head), 256 threads: a warp
//   16 rows, each half-warp 8; Q is copied to shared memory once;
// * K/V tiles of 64 keys stream through a two-stage cp.async ring, the
//   next tile's copies issued before this tile's FMAs, one barrier a tile;
//   K rows padded by 4 floats, so 8 lanes on 8 keys hit 8 bank quads;
// * S = Q K^T in registers, 8 rows x 4 keys a thread (keys lx + 16 j of
//   the half-warp's 16 lanes), from 16-byte reads of 4 depths: 12 reads
//   per 128 FMAs, Q's by broadcast;
// * online softmax in log2 units: scale log2(e) folded into one FFMA
//   before ex2, the row max through xor shuffles inside the half-warp, the
//   row sum kept per lane and reduced once at the end;
// * P^T goes to shared memory, [key][row], each warp in its own 16 columns
//   (so a __syncwarp, not a barrier, orders it), quads swizzled by the key;
//   P V then reads two float4 of P and one float4 of V (d 64) per 32 FMAs
//   into an O accumulator of 8 rows x d / 16 columns a thread, in
//   registers for the CTA's life;
// * the masks, tile skipping, window, GQA, segment ids, ragged tails and
//   heaviest-first order are the bf16 path's; a fully masked row gives out
//   0 and lse -1e30. Shared memory: Q, the ring and P^T, 130 KB at d 64
//   (one CTA an SM), 226 KB at d 128.
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
// f32: register-tiled CUDA-core FMAs

// The f32 tile: FQ query rows a CTA of FNT threads. A warp owns 16 rows,
// each half-warp 8 of them (rows 16 w + 8 hf + i); the 16 lanes of a
// half-warp split a K/V tile's BK keys for S (lane lx holds keys lx + 16 j)
// and the head dim's columns for O.
constexpr int FQ = 128;
constexpr int FTM = 8;        // query rows a thread
constexpr int FTN = BK / 16;  // keys of S a thread
static_assert(FQ == FNT / 32 * 16 && FTM == 8,
              "a warp's 16 rows: two half-warps of 8");

template <int DP>
struct FmaTile {
  // Q rows are read by broadcast (one row a half-warp): no padding. K rows
  // are read 16 at a time: padded by 4 floats, 8 lanes on 8 keys hit 8
  // bank quads. V rows are read by 16 lanes on consecutive columns.
  static constexpr int LDQ = DP, LDK = DP + 4, LDV = DP;
  // O: a lane holds columns VEC lx + 16 VEC q + e (q < OQ, e < VEC) and
  // reads them from a V row VEC floats at a time
  static constexpr int VEC = DP % 64 == 0 ? 4 : DP % 32 == 0 ? 2 : 1;
  static constexpr int OQ = DP / (16 * VEC);
  static constexpr int OC = OQ * VEC;  // O columns a thread
  // floats: Q, then K and V of the two stages, then P^T [BK][FQ]
  static constexpr int K = FQ * LDQ;
  static constexpr int V = K + 2 * BK * LDK;
  static constexpr int P = V + 2 * BK * LDV;
  static constexpr int SMEM = (P + BK * FQ) * 4;
  static_assert(SMEM <= 232448, "the f32 tile must fit a block's smem");
};

template <int DP>
__global__ void __launch_bounds__(FNT, 1) flash_fwd_fma(Params p) {
  using T = FmaTile<DP>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + T::K;  // [2][BK][LDK]
  float* sV = sQ + T::V;  // [2][BK][LDV]
  float* sP = sQ + T::P;  // P^T [BK][FQ], each warp in its 16 columns

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = bh / p.Hq;
  const int h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * FQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hf = lane / 16;              // half-warp: rows 8 hf + i
  const int lx = lane % 16;              // keys lx + 16 j; O columns
  const int r0 = warp * 16 + 8 * hf;     // this thread's first tile row

  const float* qb = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kb = static_cast<const float*>(p.k) + b * p.ksb + hk * p.ksh;
  const float* vb = static_cast<const float*>(p.v) + b * p.vsb + hk * p.vsh;

  // live K/V range, as the bf16 path's
  int kend = p.Lk;
  int kbeg = 0;
  if (p.causal) {
    kend = min(kend, q0 + FQ);
    if (p.window > 0) kbeg = max(0, q0 - p.window + 1) / BK * BK;
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  // tile t's K and V into stage t & 1
  auto issue = [&](int t) {
    const int k0 = kbeg + t * BK;
    const int nk = min(BK, p.Lk - k0);
    const int st = t & 1;
    fma_tile_async<BK, DP, T::LDK>(sK + st * BK * T::LDK, kb + k0 * p.ksl,
                                   p.ksl, nk, p.D);
    fma_tile_async<BK, DP, T::LDV>(sV + st * BK * T::LDV, vb + k0 * p.vsl,
                                   p.vsl, nk, p.D);
  };
  fma_tile_async<FQ, DP, T::LDQ>(sQ, qb + q0 * p.qsl, p.qsl,
                                 min(FQ, p.Lq - q0), p.D);
  if (ntiles > 0) issue(0);
  cp_async_commit();

  int qs[FTM];
#pragma unroll
  for (int i = 0; i < FTM; ++i) {
    const int row = q0 + r0 + i;
    qs[i] = (p.qseg != nullptr && row < p.Lq) ? p.qseg[b * p.Lq + row] : 0;
  }

  // softmax state in log2 units; l is this lane's share of its columns,
  // summed over the half-warp once at the end (alpha is the same in all
  // 16 lanes of a row)
  const float scale2 = p.scale * LOG2E;
  float m[FTM], l[FTM], o[FTM][T::OC];
#pragma unroll
  for (int i = 0; i < FTM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < T::OC; ++c) o[i][c] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t (and Q) landed; every warp is done with t - 1
    if (t + 1 < ntiles) issue(t + 1);  // into the stage t - 1 used
    cp_async_commit();
    const int k0 = kbeg + t * BK;
    const float* tK = sK + (t & 1) * BK * T::LDK;
    const float* tV = sV + (t & 1) * BK * T::LDV;

    // S = Q K^T: 8 rows x 4 keys a thread, 8 + 4 16-byte reads per 4
    // depths (Q's by broadcast)
    float s[FTM][FTN];
#pragma unroll
    for (int i = 0; i < FTM; ++i)
#pragma unroll
      for (int j = 0; j < FTN; ++j) s[i][j] = 0.f;
    const float* qr = sQ + r0 * T::LDQ;
    const float* kr = tK + lx * T::LDK;
#pragma unroll
    for (int kq = 0; kq < DP; kq += 4) {
      float4 qv[FTM];
#pragma unroll
      for (int i = 0; i < FTM; ++i) qv[i] = load4(qr + i * T::LDQ + kq);
#pragma unroll
      for (int j = 0; j < FTN; ++j) {
        const float4 kv = load4(kr + 16 * j * T::LDK + kq);
#pragma unroll
        for (int i = 0; i < FTM; ++i) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv.x, x);
          x = fmaf(qv[i].y, kv.y, x);
          x = fmaf(qv[i].z, kv.z, x);
          x = fmaf(qv[i].w, kv.w, x);
          s[i][j] = x;
        }
      }
    }

    const bool need_mask =
        k0 + BK > p.Lk || p.qseg != nullptr ||
        (p.causal && (k0 + BK - 1 > q0 ||
                      (p.window > 0 && k0 <= q0 + FQ - 1 - p.window)));
    if (need_mask) {
      int ks[FTN];
#pragma unroll
      for (int j = 0; j < FTN; ++j) {
        const int col = k0 + lx + 16 * j;
        ks[j] = (p.kseg != nullptr && col < p.Lk) ? p.kseg[b * p.Lk + col]
                                                  : 0;
      }
#pragma unroll
      for (int i = 0; i < FTM; ++i) {
        const int row = q0 + r0 + i;
#pragma unroll
        for (int j = 0; j < FTN; ++j) {
          const int col = k0 + lx + 16 * j;
          bool keep = col < p.Lk;
          if (p.causal) {
            keep = keep && col <= row;
            if (p.window > 0) keep = keep && row - col < p.window;
          }
          if (p.qseg != nullptr) keep = keep && qs[i] == ks[j];
          if (!keep) s[i][j] = NEG;
        }
      }
    }

    // online softmax: a row's 64 keys lie in the 16 lanes of its
    // half-warp. With scale >= 0 (the wrapper negates q for a negative
    // one) the row max of S scale log2(e) is the raw max times that
    // factor, so each exponent is one FFMA; P^T goes to shared memory,
    // the thread's 8 rows as two float4 a key, their 4-float quads
    // swizzled by the key (quad c at c ^ (key & 3) of the warp's 4), so
    // that a quarter-warp's stores spread over the bank quads
    float* pw = sP + warp * 16;
#pragma unroll
    for (int i = 0; i < FTM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < FTN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx * scale2);
      const float alpha = ex2(m[i] - mn);
      m[i] = mn;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < FTN; ++j) {
        const float x = s[i][j];
        const float pv =
            (need_mask && x <= 0.5f * NEG) ? 0.f : ex2(fmaf(x, scale2, -mn));
        s[i][j] = pv;
        rs += pv;
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < T::OC; ++c) o[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < FTN; ++j) {
      const int key = lx + 16 * j;
#pragma unroll
      for (int g = 0; g < 2; ++g)
        *reinterpret_cast<float4*>(pw + key * FQ +
                                   4 * ((2 * hf + g) ^ (key & 3))) =
            make_float4(s[4 * g][j], s[4 * g + 1][j], s[4 * g + 2][j],
                        s[4 * g + 3][j]);
    }
    __syncwarp();  // a warp reads back only its own rows of P^T

    // O += P V: per key two float4 of P (the 8 rows) and OQ reads of VEC
    // V columns for 8 OC FMAs. Keys past Lk have P = 0 and zero-filled V.
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 p0 = load4(pw + k * FQ + 4 * ((2 * hf) ^ (k & 3)));
      const float4 p1 = load4(pw + k * FQ + 4 * ((2 * hf + 1) ^ (k & 3)));
      const float pr[FTM] = {p0.x, p0.y, p0.z, p0.w,
                             p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int q = 0; q < T::OQ; ++q) {
        float vv[T::VEC];
        lds_vec<T::VEC>(vv, tV + k * T::LDV + T::VEC * lx + 16 * T::VEC * q);
#pragma unroll
        for (int e = 0; e < T::VEC; ++e)
#pragma unroll
          for (int i = 0; i < FTM; ++i)
            o[i][q * T::VEC + e] = fmaf(pr[i], vv[e], o[i][q * T::VEC + e]);
      }
    }
  }
  cp_async_wait<0>();  // no tile at all: Q's copy is still pending

  float* ob = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < FTM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off /= 2)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + r0 + i;
    if (row >= p.Lq) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    float* orow =
        ob + ((static_cast<long long>(b) * p.Lq + row) * p.Hq + h) * p.D;
#pragma unroll
    for (int q = 0; q < T::OQ; ++q) {
      const int col = T::VEC * lx + 16 * T::VEC * q;
      if (col >= p.D) continue;
      const int c = q * T::VEC;
      if constexpr (T::VEC == 4)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(o[i][c] * inv, o[i][c + 1] * inv, o[i][c + 2] * inv,
                        o[i][c + 3] * inv);
      else if constexpr (T::VEC == 2)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[i][c] * inv, o[i][c + 1] * inv);
      else
        orow[col] = o[i][c] * inv;
    }
    if (lx == 0)
      p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Lq + row] =
          lt > 0.f ? m[i] * LN2 + logf(lt) : NEG;  // 0: no visible key
  }
}

// ---------------------------------------------------------------------------

// one CTA per (batch x query head, `rows` query rows) of `threads`
template <typename Kernel>
int launch_kernel(Kernel kernel, int smem, int rows, int threads,
                  const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.Hq, (p.Lq + rows - 1) / rows);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch(const Params& p, bool bf16_path, cudaStream_t stream) {
  if (bf16_path)
    return launch_kernel(flash_fwd_mma<DP>, mma_smem_bytes<DP>(), BQ,
                         NTHREADS, p, stream);
  return launch_kernel(flash_fwd_fma<DP>, FmaTile<DP>::SMEM, FQ, FNT, p,
                       stream);
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
