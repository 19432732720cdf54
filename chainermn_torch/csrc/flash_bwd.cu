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
// the card is bound by operations: 0.065 ms at the 989 TFLOP/s bf16
// tensor-core peak, which the CUDA cores (67 TFLOP/s f32) cannot approach.
//
// bf16 path, on warp-level tensor cores (`mma.sync.m16n8k16`, bf16 in, f32
// accumulate), 4 warps:
// * K and V (64 x D) are copied to shared memory once;
// * Q, dO, lse and Dr of each query tile stream through a two-stage
//   `cp.async` ring, the next tile's copy in flight while this one
//   computes;
// * each warp owns 16 query rows for S = Q.K^T and dP = dO.V^T (operands by
//   `ldmatrix` from rows padded by 16 bytes, so no bank conflicts), builds P
//   and dS in registers, masks only the tiles that need it (causal
//   diagonal, window edge, ragged tails, any segment ids), and adds
//   dQ = dS.K with dS as A fragments straight from registers and K through
//   `ldmatrix.trans`, by f32 atomics;
// * P and dS, rounded to bf16, go through shared memory once, so that each
//   warp can read the transposed operand for its 16 keys: dV += P^T.dO and
//   dK += dS^T.Q (`ldmatrix.trans` on P, dS, dO and Q), in registers for
//   the CTA's lifetime; no atomics for dK/dV.
// D is padded to the next multiple of 16 with zeros in shared memory, so 8
// template widths cover every head dim that is a multiple of 8 up to 128.
//
// Not used, and what it would add: `wgmma` with TMA-fed, warp-specialised
// pipelines (FlashAttention-3's design) would issue the five products
// asynchronously from shared-memory descriptors and free the registers
// ldmatrix spends; `mma.sync` is what PyTorch's own flash backend runs on
// this card, and the fragment layouts and masks here carry over.
//
// f32 path: the CUDA-core FMA loop of the first version. The f32 contract
// (1e-4 against the plain version) is tighter than TF32's 10-bit mantissa,
// and f32 is not the main path's dtype.
//
// Layout: q/do [B, Lq, Hq, D], k/v [B, Lk, Hkv, D], read in place through
// their strides (last dim contiguous, rows 16-byte aligned); lse and Dr
// [B, Hq, Lq] f32; dq_acc [B, Lq, Hq, D] f32 (zeroed by the caller); dk/dv
// [B, Lk, Hkv, D] contiguous in the input dtype. Causal indices are
// top-left aligned (row i sees columns <= i), a window keeps i - window < j,
// segment ids keep qseg[i] == kseg[j]; a row that sees no key gets exactly
// zero gradient.
//
// Numerics as in the TPU kernel: S and dP from native-dtype operands with
// f32 accumulation, P rounded to dO's dtype before P^T.dO, dS rounded to the
// input dtype before dS^T.Q and dS.K, accumulators in f32.

#include "flash_common.cuh"

namespace {

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
  int B, Lq, Lk, Hq, Hkv, D;
  long long qsb, qsl, qsh;
  long long ksb, ksl, ksh;
  long long vsb, vsl, vsh;
  long long osb, osl, osh;
  float scale;
  int causal;
  int window;  // <= 0: no window
};

// ---------------------------------------------------------------------------
// bf16: tensor cores

constexpr int LDP = BK + 8;  // row stride of the P and dS tiles

template <int DP>
constexpr int mma_smem_bytes() {
  // K, V; Q and dO of two stages; P, dS; lse and Dr of two stages; kseg
  return (6 * BK * (DP + 8) + 2 * BQ * LDP) * 2 + (4 * BQ + BK) * 4;
}

// up to DP 64, three CTAs fit an SM's shared memory; capping registers at
// 168 lets them all be resident. `chip_smoke.py` times this build
// beside one with -DFLASH_BWD_MIN_CTAS=1 (no cap); PERF.md keeps the
// reading
#ifndef FLASH_BWD_MIN_CTAS
#define FLASH_BWD_MIN_CTAS 3
#endif
template <int DP>
__global__ void __launch_bounds__(NTHREADS, DP <= 64 ? FLASH_BWD_MIN_CTAS : 1)
    flash_bwd_mma(Params p) {
  constexpr int LD = DP + 8;
  constexpr int KB = DP / 16;  // 16-wide steps over the head dim
  constexpr int NB = DP / 8;   // 8-wide head-dim column blocks
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;      // [2][BQ][LD]
  bf16* sO = sQ + 2 * BQ * LD;  // [2][BQ][LD] dO
  bf16* sP = sO + 2 * BQ * LD;  // [BQ][LDP] P rounded to bf16
  bf16* sS = sP + BQ * LDP;     // [BQ][LDP] dS rounded to bf16
  float* sL = reinterpret_cast<float*>(sS + BQ * LDP);  // [2][BQ] lse
  float* sD = sL + 2 * BQ;                              // [2][BQ] Dr
  int* sKs = reinterpret_cast<int*>(sD + 2 * BQ);       // [BK] kseg

  const int bh = blockIdx.x;  // b * Hkv + hk
  const int kt = blockIdx.y;  // heaviest causal tiles (small kt) first
  const int b = bh / p.Hkv;
  const int hk = bh % p.Hkv;
  const int group = p.Hq / p.Hkv;
  const int k0 = kt * BK;
  const int nk = min(BK, p.Lk - k0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // accumulator row (and row + 8)
  const int tig = lane % 4;  // accumulator columns 2 tig, 2 tig + 1
  const int lr = lane % 8;   // ldmatrix: row within an 8x8 matrix
  const int li = lane / 8;   // ldmatrix: which of the four matrices

  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.ksb + hk * p.ksh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.vsb + hk * p.vsh;
  load_tile_async<DP>(sK, kb + k0 * p.ksl, p.ksl, nk, p.D);
  load_tile_async<DP>(sV, vb + k0 * p.vsl, p.vsl, nk, p.D);
  if (p.kseg != nullptr && threadIdx.x < BK)
    sKs[threadIdx.x] =
        threadIdx.x < nk ? p.kseg[b * p.Lk + k0 + threadIdx.x] : 0;

  // query rows that can see a column of this tile
  int qbeg = 0, qend = p.Lq;
  if (p.causal) {
    qbeg = k0 / BQ * BQ;
    if (p.window > 0) qend = min(qend, k0 + BK - 1 + p.window);
  }
  const int nqt = qend > qbeg ? (qend - qbeg + BQ - 1) / BQ : 0;
  const int iters = group * nqt;

  // iteration it: query head hk * group + it / nqt, query tile it % nqt
  auto issue = [&](int it, int st) {
    const int h = hk * group + it / nqt;
    const int q0 = qbeg + (it % nqt) * BQ;
    const int nq = min(BQ, p.Lq - q0);
    const bf16* qsrc = static_cast<const bf16*>(p.q) + b * p.qsb +
                       h * p.qsh + q0 * p.qsl;
    const bf16* osrc = static_cast<const bf16*>(p.dout) + b * p.osb +
                       h * p.osh + q0 * p.osl;
    load_tile_async<DP>(sQ + st * BQ * LD, qsrc, p.qsl, nq, p.D);
    load_tile_async<DP>(sO + st * BQ * LD, osrc, p.osl, nq, p.D);
    const long long rowoff = (static_cast<long long>(b) * p.Hq + h) * p.Lq +
                             q0;
    const int r = threadIdx.x % BQ;
    if (threadIdx.x < BQ)
      cp_async4(sL + st * BQ + r, p.lse + rowoff + (r < nq ? r : 0), r < nq);
    else
      cp_async4(sD + st * BQ + r, p.dr + rowoff + (r < nq ? r : 0), r < nq);
  };

  if (iters > 0) issue(0, 0);
  cp_async_commit();  // with K and V

  const float scale2 = p.scale * LOG2E;
  float dk[NB][4], dv[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int st = it & 1;
    if (it + 1 < iters) {
      issue(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` (and K, V, kseg) landed for every thread
    const int h = hk * group + it / nqt;
    const int q0 = qbeg + (it % nqt) * BQ;
    const bf16* tQ = sQ + st * BQ * LD;
    const bf16* tO = sO + st * BQ * LD;

    // S = Q K^T and dP = dO V^T: this warp's 16 query rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      unsigned qa[4], oa[4];
      const int aoff = (warp * 16 + (lane & 15)) * LD + kk * 16 +
                       (lane >> 4) * 8;
      ldsm_x4(qa, tQ + aoff);
      ldsm_x4(oa, tO + aoff);
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        const int boff = (pr * 16 + lr + (li >> 1) * 8) * LD + kk * 16 +
                         (li & 1) * 8;
        unsigned kf[4], vf[4];
        ldsm_x4(kf, sK + boff);
        ldsm_x4(vf, sV + boff);
        mma_bf16(s[2 * pr], qa, kf[0], kf[1]);
        mma_bf16(s[2 * pr + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * pr], oa, vf[0], vf[1]);
        mma_bf16(dp[2 * pr + 1], oa, vf[2], vf[3]);
      }
    }

    // P = exp(S scale - lse), dS = P (dP - Dr) scale, masked entries 0
    const int rl = warp * 16 + g;  // tile-local rows rl, rl + 8
    const int row0 = q0 + rl;
    float lse2[2], dri[2];
    int qs[2] = {0, 0};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      lse2[hf] = sL[st * BQ + rl + 8 * hf] * LOG2E;
      dri[hf] = sD[st * BQ + rl + 8 * hf];
      const int row = row0 + 8 * hf;
      if (p.qseg != nullptr && row < p.Lq) qs[hf] = p.qseg[b * p.Lq + row];
    }
    const bool need_mask =
        p.qseg != nullptr || q0 + BQ > p.Lq || k0 + BK > p.Lk ||
        (p.causal && (k0 + BK - 1 > q0 ||
                      (p.window > 0 && k0 <= q0 + BQ - 1 - p.window)));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        float pv = ex2(s[j][e] * scale2 - lse2[hf]);
        if (need_mask) {
          const int row = row0 + 8 * hf;
          const int cl = j * 8 + tig * 2 + (e & 1);
          const int col = k0 + cl;
          bool keep = row < p.Lq && col < p.Lk;
          if (p.causal) {
            keep = keep && col <= row;
            if (p.window > 0) keep = keep && row - col < p.window;
          }
          if (p.qseg != nullptr) keep = keep && qs[hf] == sKs[cl];
          if (!keep) pv = 0.f;
        }
        s[j][e] = pv;
        dp[j][e] = pv * (dp[j][e] - dri[hf]) * p.scale;
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int off = (rl + 8 * hf) * LDP + j * 8 + tig * 2;
        *reinterpret_cast<unsigned*>(sP + off) =
            pack_bf16(s[j][2 * hf], s[j][2 * hf + 1]);
        *reinterpret_cast<unsigned*>(sS + off) =
            pack_bf16(dp[j][2 * hf], dp[j][2 * hf + 1]);
      }
    // dS (bf16) as the A operand of dQ = dS K, 16 keys per fragment
    unsigned dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      dsa[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      dsa[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      dsa[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      dsa[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    __syncthreads();  // sP, sS complete

    // dV += P^T dO and dK += dS^T Q: this warp's 16 keys x DP
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      unsigned pa[4], sa[4];
      const int toff = (kq * 16 + lr + (li >> 1) * 8) * LDP + warp * 16 +
                       (li & 1) * 8;
      ldsm_x4_t(pa, sP + toff);
      ldsm_x4_t(sa, sS + toff);
#pragma unroll
      for (int dd = 0; dd < KB; ++dd) {
        const int boff = (kq * 16 + lr + (li & 1) * 8) * LD + dd * 16 +
                         (li >> 1) * 8;
        unsigned of[4], qf[4];
        ldsm_x4_t(of, tO + boff);
        ldsm_x4_t(qf, tQ + boff);
        mma_bf16(dv[2 * dd], pa, of[0], of[1]);
        mma_bf16(dv[2 * dd + 1], pa, of[2], of[3]);
        mma_bf16(dk[2 * dd], sa, qf[0], qf[1]);
        mma_bf16(dk[2 * dd + 1], sa, qf[2], qf[3]);
      }
    }

    // dQ += dS K for this warp's 16 query rows, 16 columns at a time,
    // atomically into f32. The lanes 2i, 2i + 1 of a quad swap halves, so
    // that the even lane holds 4 consecutive columns of row0 and the odd
    // lane the same 4 of row0 + 8: one 16-byte atomic each.
    const bool odd = tig & 1;
    const int qrow = row0 + (odd ? 8 : 0);
    float* dqb = p.dq + ((static_cast<long long>(b) * p.Lq + qrow) * p.Hq +
                         h) * p.D + (tig & 2) * 2;
#pragma unroll
    for (int dd = 0; dd < KB; ++dd) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned kf[4];
        ldsm_x4_t(kf, sK + (kk * 16 + lr + (li & 1) * 8) * LD + dd * 16 +
                          (li >> 1) * 8);
        mma_bf16(acc[0], dsa[kk], kf[0], kf[1]);
        mma_bf16(acc[1], dsa[kk], kf[2], kf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float got0 =
            __shfl_xor_sync(0xffffffffu, odd ? acc[j][0] : acc[j][2], 1);
        const float got1 =
            __shfl_xor_sync(0xffffffffu, odd ? acc[j][1] : acc[j][3], 1);
        const float4 val =
            odd ? make_float4(got0, got1, acc[j][2], acc[j][3])
                : make_float4(acc[j][0], acc[j][1], got0, got1);
        const int col = dd * 16 + j * 8;  // + (tig & 2) * 2, in dqb
        if (col < p.D && qrow < p.Lq)
          atomicAdd(reinterpret_cast<float4*>(dqb + col), val);
      }
    }
    __syncthreads();  // sP, sS and this stage are free again
  }
  cp_async_wait<0>();  // no query tile at all: K/V's copy is still pending

  bf16* dkb = static_cast<bf16*>(p.dk);
  bf16* dvb = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + warp * 16 + g + 8 * hf;
    if (key >= p.Lk) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Lk + key) * p.Hkv + hk) * p.D;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int col = j * 8 + tig * 2;
      if (col >= p.D) continue;
      *reinterpret_cast<__nv_bfloat162*>(dkb + off + col) =
          __floats2bfloat162_rn(dk[j][2 * hf], dk[j][2 * hf + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + off + col) =
          __floats2bfloat162_rn(dv[j][2 * hf], dv[j][2 * hf + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs

constexpr int RPT = 4;       // rows per thread
constexpr int CPT = BK / 8;  // score columns per thread

template <int DP>
constexpr int fma_smem_bytes() {
  return (4 * BK * (DP + 4) + 2 * BQ * (BK + 1)) * 4;
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_fma(Params p) {
  static_assert(BQ == BK, "load_tile serves Q and K/V tiles of one height");
  constexpr int LD = DP + 4, LDS = BK + 1;
  constexpr int DPT = DP / 8;  // head-dim columns per thread
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;   // dO
  float* sP = sO + BQ * LD;   // P
  float* sS = sP + BQ * LDS;  // dS

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

  const float* kb = static_cast<const float*>(p.k) + b * p.ksb + hk * p.ksh;
  const float* vb = static_cast<const float*>(p.v) + b * p.vsb + hk * p.vsh;
  load_tile<DP>(sK, LD, kb + k0 * p.ksl, p.ksl, nk, p.D);
  load_tile<DP>(sV, LD, vb + k0 * p.vsl, p.vsl, nk, p.D);

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
    const float* qb = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
    const float* ob =
        static_cast<const float*>(p.dout) + b * p.osb + h * p.osh;
    const float* lse_b = p.lse + (static_cast<long long>(b) * p.Hq + h) * p.Lq;
    const float* dr_b = p.dr + (static_cast<long long>(b) * p.Hq + h) * p.Lq;
    for (int q0 = qbeg; q0 < qend; q0 += BQ) {
      const int nq = min(BQ, p.Lq - q0);
      __syncthreads();  // previous tile's sQ/sO/sP/sS reads are done
      load_tile<DP>(sQ, LD, qb + q0 * p.qsl, p.qsl, nq, p.D);
      load_tile<DP>(sO, LD, ob + q0 * p.osl, p.osl, nq, p.D);
      __syncthreads();

      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DP; d += 4) {
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
          sP[(r0 + i) * LDS + cg + 8 * j] = pr;
          sS[(r0 + i) * LDS + cg + 8 * j] = pr * (dp[i][j] - dri) * p.scale;
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
          pc[i] = sP[qq * LDS + r0 + i];
          sc[i] = sS[qq * LDS + r0 + i];
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
        for (int i = 0; i < RPT; ++i) sc[i] = sS[(r0 + i) * LDS + kk];
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
            p.dq + ((static_cast<long long>(b) * p.Lq + row) * p.Hq + h) *
                       p.D;
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          if (cg + 8 * j < p.D) atomicAdd(dqrow + cg + 8 * j, dq[i][j]);
      }
    }
  }

  float* dkb = static_cast<float*>(p.dk);
  float* dvb = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + r0 + i;
    if (row >= p.Lk) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Lk + row) * p.Hkv + hk) * p.D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      if (cg + 8 * j >= p.D) continue;
      dkb[off + cg + 8 * j] = dk[i][j];
      dvb[off + cg + 8 * j] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------

template <typename Kernel>
int launch_kernel(Kernel kernel, int smem, const Params& p,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.Hkv, (p.Lk + BK - 1) / BK);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch(const Params& p, bool bf16_path, cudaStream_t stream) {
  if (bf16_path)
    return launch_kernel(flash_bwd_mma<DP>, mma_smem_bytes<DP>(), p, stream);
  return launch_kernel(flash_bwd_fma<DP>, fma_smem_bytes<DP>(), p, stream);
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
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 8 ||
      D > 128 || D % 8 != 0 || (dtype != 0 && dtype != 1) ||
      (Lk + BK - 1) / BK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,   k,   v,   dout, lse, dr,  qseg, kseg, dq,  dk,    dv,
           B,   Lq,  Lk,  Hq,   Hkv, D,   qsb,  qsl,  qsh, ksb,   ksl,
           ksh, vsb, vsl, vsh,  osb, osl, osh,  scale, causal, window};
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
