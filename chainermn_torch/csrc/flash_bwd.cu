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
// f32 path (`flash_bwd_fma`), full f32 on the CUDA cores: the f32 contract
// (1e-4 against the plain version) is tighter than TF32's 10-bit mantissa;
// an f32 model (the JAX TransformerLM's default) runs it. At [4, 2048, 12,
// 64] causal it is bound by its 64.4 GFLOP of FMAs (0.962 ms at 67
// TFLOP/s), so the design spends as little as it can beside the FMAs:
// * one CTA of 256 threads, one an SM, owns 128 keys at d <= 64 (64
//   above): K and V are copied once, and dK and dV (64 floats a thread at
//   either height) stay in registers for the CTA's life;
// * Q, dO, lse and Dr of each 64-row query tile stream through a two-stage
//   cp.async ring, the next tile's copy issued before this tile's FMAs;
// * every product is an outer product of register tiles fed by 16-byte
//   shared-memory reads, the row operand read by broadcast in each
//   quarter-warp, the column operand spread over 8 bank quads: S and dP 8
//   rows x 4 keys a thread (4 x 4 at 64 keys), 12 reads per 128 FMAs;
//   dV += P^T dO and dK += dS^T Q 8 keys (4) x d/16 columns, a read of P^T
//   or dS^T covering 4 query rows; dQ = dS K 8 rows x d/16 columns over
//   half the keys (warps 0-3 the first half, 4-7 the second);
// * P is one FFMA (scale log2(e) folded in) and ex2; masks run only on the
//   tiles that need them (the causal diagonal, the window edge, ragged
//   tails, any segment ids); P and dS go to shared memory transposed,
//   [key][row], a warp's 32 stores on 32 banks;
// * dQ is summed into the f32 dq buffer with one 16-byte atomic per row and
//   4 columns (8 and 4 bytes where d/16 is not a multiple of 4);
// * rows are padded by 4 floats, so 8 rows read at one column hit 8 bank
//   quads; at d 128 padded tiles would not fit 227 KB, so there the rows
//   are unpadded and their quads XOR-swizzled by the row.
// Two barriers a query tile. What bounds it on an H100 (PERF.md, PR 14):
// the shared-memory reads. One 16-byte read costs the SM ~2.4 cycles where
// each quarter-warp reads one address and ~4 where it reads 8, so each
// product's reads take ~1.1x its FMAs' issue time; dK, dV, the S and dP
// tiles and their operands fill 254 registers, which leaves none to
// prefetch the next reads, and each product runs at about two thirds of
// that bound (~53% of the FMA peak in all). 128-key tiles beat 64 (fewer
// reads and atomics per FMA); splitting the CTA into an S/P/dV half and a
// dP/dS/dK half with 8 x 8 tiles (a third fewer reads) was no faster: a
// third barrier, the P exchange and spills ate the gain.
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

#include <type_traits>

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
// f32: register-tiled CUDA-core FMAs

constexpr int FQ = 64;  // query rows of a streamed tile

// The f32 tile at head dim DP (D padded to 16). Each product is an outer
// product of register tiles read from shared memory 16 bytes at a time:
// lanes 8 l4 + l8 of a warp share their row operand within a quarter-warp
// (one broadcast) and spread their column operand over 8 bank quads.
template <int DP>
struct FmaTile {
  // keys a CTA: dK and dV, 2 KT DP / FNT = 64 floats a thread at either
  // height, stay in registers for the CTA's life
  static constexpr int KT = DP <= 64 ? 128 : 64;
  // S and dP: TM query rows (r + 4 i) x 4 keys (c + 8 j) a thread; a warp
  // covers 4 TM rows x 32 keys, RW warps down the query tile
  static constexpr int TM = KT / 16;
  static constexpr int RW = FQ / (4 * TM);
  // dV and dK: TK keys (c + 4 i) x OC columns a thread; dQ: 8 query rows x
  // OC columns over half the keys (warps 0-3 the first half, 4-7 the
  // second). A lane's columns are OQ runs of VEC of its column group (16
  // groups: 8 lanes x 2 warps), so each run is one read
  static constexpr int TK = KT / 16;
  static constexpr int VEC = DP % 64 == 0 ? 4 : DP % 32 == 0 ? 2 : 1;
  static constexpr int OQ = DP / (16 * VEC);
  static constexpr int OC = OQ * VEC;
  // rows of Q, dO, K, V (LD floats) and of P^T, dS^T (LDP): padded by 4
  // floats, or at d 128, where padding would not fit, unpadded with their
  // 16-byte quads XOR-swizzled by the row (`at` in flash_common.cuh)
  static constexpr bool SWZ = DP == 128;
  static constexpr int LD = SWZ ? DP : DP + 4;
  static constexpr int LDP = SWZ ? FQ : FQ + 4;
  // offsets in floats: K, V; Q and dO of two stages; P^T and dS^T
  // [key][query row]; lse and Dr of two stages
  static constexpr int V = KT * LD;
  static constexpr int Q = 2 * KT * LD;
  static constexpr int O = Q + 2 * FQ * LD;
  static constexpr int P = O + 2 * FQ * LD;
  static constexpr int S = P + KT * LDP;
  static constexpr int L = S + KT * LDP;
  static constexpr int DR = L + 2 * FQ;
  static constexpr int SMEM = (DR + 2 * FQ) * 4;
  static_assert(SMEM <= 232448, "the f32 tile must fit a block's smem");
  static_assert(RW * KT / 32 == FNT / 32 && 4 * TK * 4 == KT,
                "8 warps tile both S and dV/dK");
};

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[i][j] = a[r + 4 i] . b[c + 8 j] over the head dim (rows of two
// shared-memory tiles), TM + 4 16-byte reads per 4 depths
template <int DP, int TM, int LD, bool SWZ>
__device__ __forceinline__ void row_dots(float (&acc)[TM][4], const float* a,
                                         const float* bt, int r, int c) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = load4(a + at<LD, SWZ>(r + 4 * i, d));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 bv = load4(bt + at<LD, SWZ>(c + 8 * j, d));
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float x = acc[i][j];
        x = fmaf(av[i].x, bv.x, x);
        x = fmaf(av[i].y, bv.y, x);
        x = fmaf(av[i].z, bv.z, x);
        x = fmaf(av[i].w, bv.w, x);
        acc[i][j] = x;
      }
    }
  }
}

// VEC consecutive floats of global memory from x, in one store or atomic
template <int VEC, bool ADD>
__device__ __forceinline__ void st_vec(float* p, const float* x) {
  if constexpr (VEC == 4) {
    const float4 v = make_float4(x[0], x[1], x[2], x[3]);
    if constexpr (ADD) atomicAdd(reinterpret_cast<float4*>(p), v);
    else *reinterpret_cast<float4*>(p) = v;
  } else if constexpr (VEC == 2) {
    const float2 v = make_float2(x[0], x[1]);
    if constexpr (ADD) atomicAdd(reinterpret_cast<float2*>(p), v);
    else *reinterpret_cast<float2*>(p) = v;
  } else {
    if constexpr (ADD) atomicAdd(p, x[0]);
    else *p = x[0];
  }
}

template <int DP>
__global__ void __launch_bounds__(FNT, 1) flash_bwd_fma(Params p) {
  using T = FmaTile<DP>;
  constexpr int KT = T::KT, TM = T::TM, TK = T::TK;
  constexpr int VEC = T::VEC, OQ = T::OQ, OC = T::OC;
  constexpr int LD = T::LD, LDP = T::LDP;
  constexpr bool SWZ = T::SWZ;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + T::V;
  float* sQ = sK + T::Q;   // [2][FQ] rows
  float* sO = sK + T::O;   // [2][FQ] rows of dO
  float* sP = sK + T::P;   // P^T [KT][LDP]
  float* sS = sK + T::S;   // dS^T [KT][LDP]
  float* sL = sK + T::L;   // [2][FQ] lse
  float* sD = sK + T::DR;  // [2][FQ] Dr

  const int bh = blockIdx.x;  // b * Hkv + hk
  const int kt = blockIdx.y;  // heaviest causal tiles (small kt) first
  const int b = bh / p.Hkv;
  const int hk = bh % p.Hkv;
  const int group = p.Hq / p.Hkv;
  const int k0 = kt * KT;
  const int nk = min(KT, p.Lk - k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l4 = lane / 8, l8 = lane % 8;
  // S, dP: tile rows r1 + 4 i and keys c1 + 8 j
  const int r1 = warp % T::RW * 4 * TM + l4;
  const int c1 = warp / T::RW * 32 + l8;
  // dV, dK: keys c3 + 4 i, column group cg (columns VEC cg + 16 VEC q + e)
  const int c3 = warp % 4 * (KT / 4) + l4;
  const int cg = warp / 4 * 8 + l8;
  // dQ: tile rows r4 + i, keys kq .. kq + KT / 2 - 1, column group cq
  const int r4 = (warp & 1) * 32 + 8 * l4;
  const int kq = warp / 4 * (KT / 2);
  const int cq = (warp >> 1 & 1) * 8 + l8;

  const float* kb = static_cast<const float*>(p.k) + b * p.ksb + hk * p.ksh;
  const float* vb = static_cast<const float*>(p.v) + b * p.vsb + hk * p.vsh;
  fma_tile_async<KT, DP, LD, SWZ>(sK, kb + k0 * p.ksl, p.ksl, nk, p.D);
  fma_tile_async<KT, DP, LD, SWZ>(sV, vb + k0 * p.vsl, p.vsl, nk, p.D);
  int ks[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = k0 + c1 + 8 * j;
    ks[j] = (p.kseg != nullptr && col < p.Lk) ? p.kseg[b * p.Lk + col] : 0;
  }

  // query rows that can see a column of this tile, as the bf16 path's
  int qbeg = 0, qend = p.Lq;
  if (p.causal) {
    qbeg = k0 / FQ * FQ;
    if (p.window > 0) qend = min(qend, k0 + KT - 1 + p.window);
  }
  const int nqt = qend > qbeg ? (qend - qbeg + FQ - 1) / FQ : 0;
  const int iters = group * nqt;

  // iteration it: query head hk * group + it / nqt, query tile it % nqt,
  // into stage st: Q and dO rows, then lse and Dr (threads < 2 FQ)
  auto issue = [&](int it, int st) {
    const int h = hk * group + it / nqt;
    const int q0 = qbeg + (it % nqt) * FQ;
    const int nq = min(FQ, p.Lq - q0);
    const float* qsrc = static_cast<const float*>(p.q) + b * p.qsb +
                        h * p.qsh + q0 * p.qsl;
    const float* osrc = static_cast<const float*>(p.dout) + b * p.osb +
                        h * p.osh + q0 * p.osl;
    fma_tile_async<FQ, DP, LD, SWZ>(sQ + st * FQ * LD, qsrc, p.qsl, nq, p.D);
    fma_tile_async<FQ, DP, LD, SWZ>(sO + st * FQ * LD, osrc, p.osl, nq, p.D);
    if (threadIdx.x < 2 * FQ) {
      const long long rowoff =
          (static_cast<long long>(b) * p.Hq + h) * p.Lq + q0;
      const int r = threadIdx.x % FQ;
      const bool lse = threadIdx.x < FQ;
      cp_async4((lse ? sL : sD) + st * FQ + r,
                (lse ? p.lse : p.dr) + rowoff + (r < nq ? r : 0), r < nq);
    }
  };

  if (iters > 0) issue(0, 0);
  cp_async_commit();  // with K and V

  const float scale2 = p.scale * LOG2E;
  float dk[TK][OC], dv[TK][OC];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int st = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; every thread is done with it - 1
    if (it + 1 < iters) issue(it + 1, st ^ 1);  // into the stage it - 1 used
    cp_async_commit();
    const int h = hk * group + it / nqt;
    const int q0 = qbeg + (it % nqt) * FQ;
    const float* tQ = sQ + st * FQ * LD;
    const float* tO = sO + st * FQ * LD;

    // S = Q K^T and dP = dO V^T: TM rows x 4 keys a thread
    float s[TM][4], dp[TM][4];
    row_dots<DP, TM, LD, SWZ>(s, tQ, sK, r1, c1);
    row_dots<DP, TM, LD, SWZ>(dp, tO, sV, r1, c1);

    // P = exp(S scale - lse), scale log2(e) folded into one FFMA before
    // ex2; masked entries 0, and masks only on the tiles that need them
    // (the causal diagonal, the window edge, ragged tails, any segment
    // ids)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float lse2 = sL[st * FQ + r1 + 4 * i] * LOG2E;
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = ex2(fmaf(s[i][j], scale2, -lse2));
    }
    if (p.qseg != nullptr || q0 + FQ > p.Lq || k0 + KT > p.Lk ||
        (p.causal && (k0 + KT - 1 > q0 ||
                      (p.window > 0 && k0 <= q0 + FQ - 1 - p.window)))) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = q0 + r1 + 4 * i;
        const int qs =
            (p.qseg != nullptr && row < p.Lq) ? p.qseg[b * p.Lq + row] : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + c1 + 8 * j;
          bool keep = (row < p.Lq) & (col < p.Lk);
          if (p.causal)
            keep &= (col <= row) & ((p.window <= 0) | (row - col < p.window));
          if (p.qseg != nullptr) keep &= qs == ks[j];
          if (!keep) s[i][j] = 0.f;
        }
      }
    }
    // dS = P (dP - Dr) scale; P and dS go to shared memory transposed,
    // [key][row]: a warp's 32 lanes store to 32 banks
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int rl = r1 + 4 * i;
      const float dri = sD[st * FQ + rl];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off = at<LDP, SWZ>(c1 + 8 * j, rl);
        sP[off] = s[i][j];
        sS[off] = s[i][j] * (dp[i][j] - dri) * p.scale;
      }
    }
    __syncthreads();  // P^T, dS^T complete

    // dV += P^T dO and dK += dS^T Q over the tile's query rows: per 4 rows,
    // 2 TK reads of P^T and dS^T (4 rows each) and 8 OQ of dO and Q
#pragma unroll 2
    for (int q = 0; q < FQ; q += 4) {
      float4 pt[TK], dt[TK];
#pragma unroll
      for (int i = 0; i < TK; ++i) {
        pt[i] = load4(sP + at<LDP, SWZ>(c3 + 4 * i, q));
        dt[i] = load4(sS + at<LDP, SWZ>(c3 + 4 * i, q));
      }
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4)
#pragma unroll
        for (int oq = 0; oq < OQ; ++oq) {
          const int col = VEC * cg + 16 * VEC * oq;
          float ov[VEC], qv[VEC];
          lds_vec<VEC>(ov, tO + at<LD, SWZ>(q + e4, col));
          lds_vec<VEC>(qv, tQ + at<LD, SWZ>(q + e4, col));
#pragma unroll
          for (int e = 0; e < VEC; ++e)
#pragma unroll
            for (int i = 0; i < TK; ++i) {
              dv[i][oq * VEC + e] =
                  fmaf(lane_of(pt[i], e4), ov[e], dv[i][oq * VEC + e]);
              dk[i][oq * VEC + e] =
                  fmaf(lane_of(dt[i], e4), qv[e], dk[i][oq * VEC + e]);
            }
        }
    }

    // dQ = dS K: 8 rows x OC columns a thread over half the keys, per key
    // two reads of dS^T (4 rows each) and OQ of K; summed into the f32
    // dq_acc with one VEC-wide atomic per row and run
    float dq[8][OC];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < OC; ++c) dq[i][c] = 0.f;
#pragma unroll 4
    for (int kk = kq; kk < kq + KT / 2; ++kk) {
      const float4 s0 = load4(sS + at<LDP, SWZ>(kk, r4));
      const float4 s1 = load4(sS + at<LDP, SWZ>(kk, r4 + 4));
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int oq = 0; oq < OQ; ++oq) {
        float kv[VEC];
        lds_vec<VEC>(kv, sK + at<LD, SWZ>(kk, VEC * cq + 16 * VEC * oq));
#pragma unroll
        for (int e = 0; e < VEC; ++e)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            dq[i][oq * VEC + e] = fmaf(sv[i], kv[e], dq[i][oq * VEC + e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + r4 + i;
      if (row >= p.Lq) continue;
      float* dqrow =
          p.dq + ((static_cast<long long>(b) * p.Lq + row) * p.Hq + h) * p.D;
#pragma unroll
      for (int oq = 0; oq < OQ; ++oq) {
        const int col = VEC * cq + 16 * VEC * oq;
        if (col < p.D) st_vec<VEC, true>(dqrow + col, dq[i] + oq * VEC);
      }
    }
  }
  cp_async_wait<0>();  // no query tile at all: K/V's copy is still pending

  float* dkb = static_cast<float*>(p.dk);
  float* dvb = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int key = k0 + c3 + 4 * i;
    if (key >= p.Lk) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Lk + key) * p.Hkv + hk) * p.D;
#pragma unroll
    for (int oq = 0; oq < OQ; ++oq) {
      const int col = VEC * cg + 16 * VEC * oq;
      if (col >= p.D) continue;
      st_vec<VEC, false>(dkb + off + col, dk[i] + oq * VEC);
      st_vec<VEC, false>(dvb + off + col, dv[i] + oq * VEC);
    }
  }
}

// ---------------------------------------------------------------------------

// calls f(std::integral_constant<int, DP>()), DP the head dim D padded to
// the next multiple of 16 (D is a multiple of 8 up to 128)
template <typename F>
int with_dp(int D, F f) {
  switch ((D + 15) / 16 * 16) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 48: return f(std::integral_constant<int, 48>());
    case 64: return f(std::integral_constant<int, 64>());
    case 80: return f(std::integral_constant<int, 80>());
    case 96: return f(std::integral_constant<int, 96>());
    case 112: return f(std::integral_constant<int, 112>());
    default: return f(std::integral_constant<int, 128>());
  }
}

// one CTA per (batch x KV head, `keys` keys) of `threads`
template <typename Kernel>
int launch_kernel(Kernel kernel, int smem, int keys, int threads,
                  const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.Hkv, (p.Lk + keys - 1) / keys);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch(const Params& p, bool bf16_path, cudaStream_t stream) {
  if (bf16_path)
    return launch_kernel(flash_bwd_mma<DP>, mma_smem_bytes<DP>(), BK,
                         NTHREADS, p, stream);
  return launch_kernel(flash_bwd_fma<DP>, FmaTile<DP>::SMEM,
                       FmaTile<DP>::KT, FNT, p, stream);
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
  return with_dp(D, [&](auto dp) {
    return launch<decltype(dp)::value>(p, dtype == 1, s);
  });
}

// the f32 body's tile at head dim D: 0 keys a CTA, 1 query rows a streamed
// tile, 2 threads a CTA, 3 CTAs an SM
extern "C" int chainermn_flash_bwd_f32_tile(int which, int D) {
  return with_dp(D, [&](auto dp) {
    return which == 0   ? FmaTile<decltype(dp)::value>::KT
           : which == 1 ? FQ
           : which == 2 ? FNT
                        : 1;
  });
}
