// Fused LM head + softmax cross-entropy for Hopper (sm_90a), plain C ABI
// for ctypes: the logits never reach device memory.
//
// Replaces the TPU kernels of chainermn_tpu/ops/fused_ce.py:
//   ce_fwd  <- `_fwd_kernel` (launched by `_run_fwd`): per row the logsumexp
//              of h . W, the target logit and the first-index argmax;
//   ce_dh   <- `_dh_kernel` (`_bwd_rule`): dh = (softmax - onehot) . W^T;
//   ce_dw   <- `_dw_kernel` (`_bwd_rule`): dW = h^T . (softmax - onehot),
// the softmax rebuilt per tile from the forward's lse, dl = softmax - onehot
// rounded to the operands' dtype before the second product (the TPU kernel's
// `dl.astype`). dh and dW leave the kernels unscaled, in the input dtype; the
// wrapper multiplies by dloss / N as `_bwd_rule` does.
//
// The head is passed transposed, wt [V, D] row-major (the port's
// `lm_head.weight` as it lies), h [N, D] row-major, labels int32 [N]; h and
// wt start on 16-byte boundaries (the wrapper checks).
//
// What bounds them: at the training shape (N = 8192, D = 768, V = 32768,
// bf16) the forward does 2 N D V = 412 GFLOP and dh and dW 4 N D V = 825
// GFLOP each (the logits are recomputed) against ~63 MB of h and W: all
// three are bound by the tensor cores' operations, 0.417 and 0.834 ms at the
// 989 TFLOP/s bf16 peak. f32 inputs take full-f32 FMAs on the CUDA cores
// (an f32 model's loss: the JAX TransformerLM defaults to f32, and the
// 1e-4 contract of f32 is tighter than TF32's 10-bit mantissa).
//
// f32 forward (`ce_fwd_fma`), dh (`ce_bwd_fma<false>`) and dW
// (`ce_bwd_fma<true>`), at N 1024, D 768, V 32768 bound by 2 N D V = 51.5
// GFLOP and 4 N D V = 103 GFLOP of FMAs each, 0.769 and 1.538 ms at the 67
// TFLOP/s f32 peak (one D chunk; the backward with c chunks recomputes the
// logits c times: (2 c + 2) N D V):
// * the forward and dh split the vocabulary, dW the rows of h, into S
//   ranges of whole tiles, as the bf16 forward's, so that (row blocks x S)
//   CTAs fill the SMs; a forward CTA writes its rows' partial (m, s, t, a)
//   and `ce_fwd_combine` combines them; a backward CTA writes its partial
//   [BM, DC] block to an f32 workspace [S, rows, D] that `ce_sum_ranges`
//   sums in range order (S = 1: straight into dh or dW^T). No atomics: two
//   calls give the same bits;
// * operands stream through a two-stage cp.async ring of shared-memory
//   slabs, the next slab's copies issued before this slab's FMAs; a logits
//   slab keeps the rows of h and W^T as they lie (row r, 64 depths) with
//   rows padded by 4 floats, so a 16-byte read brings 4 depths of one row
//   and 8 lanes reading 8 consecutive rows hit 8 different bank quads;
// * register tiles: each thread accumulates TM x TN logits from TM + TN
//   16-byte reads per 4 depths (forward 8 x 8: 4 reads per 64 FMAs, not 2
//   reads of shared memory per FMA);
// * forward epilogue in registers: a row's 128 columns lie in 16 lanes of
//   one warp, so its max, first-index argmax and sum of exp take xor
//   shuffles; lane 0 of the 16 folds them into the row's running (m, s, t,
//   a) in shared memory, strictly greater (the first tile keeps ties);
//   columns >= V read -inf; shared memory is fixed whatever D is;
// * dh and dW are one template, mirror images: a CTA keeps 32 rows of the
//   resident operand R (dh: h; dW: W^T) and their [32, DC] accumulator (DC
//   = 768) in registers, 8 x 12 a thread, for its whole life; per tile of
//   256 rows of the streamed operand T (dh: W^T; dW: h) it runs the
//   logits product (4 x 8 a thread), writes dl = exp(S - lse) - onehot (0
//   outside N x V) to shared memory transposed, then streams T's 256 rows
//   again, 32 at a time, 768 columns wide, through the same ring for acc
//   += dl . T. D > 768 takes chunks of 768 columns over blockIdx.z, each
//   recomputing the logits; any D that is a multiple of 4 runs, and shared
//   memory is fixed whatever D is. T is read from L2 twice per 32 rows of
//   R (2 N D V / 8 bytes, 6.4 GB at N 1024), but that traffic is not what
//   holds it at about half its bound: copies of this source that copy half
//   of T's slabs, or none, save about a tenth and a quarter of its time
//   (`ce_f32_traffic.py`, PERF.md section 6), so a 2-CTA cluster sharing
//   T would save at most the tenth.
//
// bf16 forward (`ce_fwd_wgmma`), warp-specialised:
// * a CTA owns 128 rows of h (two consumer warpgroups of 64) and one range
//   of the vocabulary, walked in tiles of 256 columns; the host splits the
//   vocabulary into S ranges of whole tiles so that (row blocks x S) CTAs
//   fill the SMs (S = 2 at the training shape: 128 CTAs), no range empty;
// * one producer thread issues TMA loads of the h box [128 x 64] and the W
//   box [256 x 64] per 64-deep step of D, 128-byte swizzled, into a ring
//   of 4 stages (48 KB each, shared memory fixed whatever D is); an
//   mbarrier per stage counts the bytes in, another the 8 consumer warps
//   out; TMA zero-fills past N, V and D;
// * each consumer warpgroup runs wgmma.m64n256k16 (bf16 in, f32
//   accumulate) from descriptors of the swizzled boxes; the 64 x 256 f32
//   logits tile stays in registers (128 a thread, registers handed over
//   from the producer with setmaxnreg), one step's products in flight
//   while the next stage is awaited;
// * the epilogue reads the tile where it lies: a quad of lanes holds a
//   row's 256 columns, so its max, first-index argmax, sum of
//   ex2((x - m) log2 e) and target logit need only shuffles inside the
//   quad; they fold into the row's running (m, s, t, a) with strictly
//   greater updates (the first tile wins ties); columns >= V read -inf;
// * each CTA writes its rows' partial (m, s, t, a) to a workspace of S x N
//   entries; a second small kernel (`ce_fwd_combine`) on the same stream
//   combines them in range order: lse = M + log sum s_i exp(m_i - M),
//   tl = sum t_i, am from the lowest range with m_i = M. No atomics: two
//   calls give the same bits.
// The TMA descriptors encode the base pointers, so the host builds them per
// call with cuTensorMapEncodeTiled, looked up through
// cudaGetDriverEntryPointByVersion so that the library needs no -lcuda.
//
// bf16 dh and dW, one kernel (`ce_bwd_mma`) for both, mirror images:
// * each CTA owns BM rows of the output and keeps that block of the
//   resident operand R in shared memory for its whole life (dh: h rows with
//   their lse and labels; dW: rows of W^T), copied once with cp.async;
// * it streams the other operand T (dh: W^T rows; dW: h rows with their lse
//   and labels) in tiles of BS full-width rows through a two-stage cp.async
//   ring (zero-filled past the ragged edge): the next tile's copy runs under
//   this tile's math, and every streamed byte serves both products;
// * S = R . T^T [BM, BS] (the accumulating output's rows as its rows) runs
//   on `mma.sync.m16n8k16` (bf16 in, f32 accumulate) fed by `ldmatrix`, each
//   warp a 32 x 16 piece over 1/KS of D; the partial sums meet in shared
//   memory in a fixed order;
// * dl = ex2((S - lse) log2 e) - onehot, 0 outside N x V, rounded to bf16
//   into a small [BM, BS] tile, the A operand of the second product;
// * acc[BM, D] += dl . T on `mma.sync` with T read by `ldmatrix.trans`; the
//   f32 accumulator stays in registers (32 rows x 96 columns a warp) and is
//   rounded and written once at the end.
// Layouts (`BwdLayout`): D <= 768 takes 64 rows, 16 warps and a 128-register
// cap (-DCE_BWD_ROWS=32: 32 rows, 8 warps, 255 registers, twice the L2
// traffic; `chip_smoke.py` times both); wider D takes 32 rows and 16-row
// tiles and splits the accumulator's columns in 768-wide chunks over
// blockIdx.y, each chunk recomputing S. D is zero-padded in shared memory,
// so every D that is a multiple of 8 up to 1536 runs.
// No atomics: each output element is owned by one CTA, so the results are
// reproducible run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include "mma_sync.cuh"
#include "wgmma.cuh"

namespace {

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ---------------------------------------- f32 forward, dh and dW: FMAs

// ROWS rows of a row-major f32 matrix `base` (row stride `lds`) from
// row `row0`, column `col0` on, 4 CH floats wide, into shared memory rows
// of stride LD, by cp.async 16 bytes at a time; rows >= nrows and columns
// >= ncols are zero-filled (their copies read nothing and point at `base`)
template <int NT, int ROWS, int CH, int LD>
__device__ __forceinline__ void slab_async(float* dst, const float* base,
                                           int row0, int col0, int lds,
                                           int nrows, int ncols) {
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    const bool ok = row0 + r < nrows && col0 + c < ncols;
    cp_async16(dst + r * LD + c,
               ok ? base + static_cast<long long>(row0 + r) * lds + col0 + c
                  : base,
               ok);
  }
}

// c[i][j] += A row (a + i RS rows) . B row (b + j CS rows) over one slab of
// FK depths; A and B rows lie FK + 4 floats apart. Each 16-byte read brings
// 4 depths of one row; depths are summed in order, so the bits do not
// depend on the schedule.
template <int FK, int TM, int TN, int RS, int CS>
__device__ __forceinline__ void fma_slab(float (&c)[TM][TN], const float* a,
                                         const float* b) {
  constexpr int LD = FK + 4;
#pragma unroll
  for (int kq = 0; kq < FK; kq += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * RS * LD + kq);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(b + j * CS * LD + kq);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        c[i][j] = fmaf(av[i].x, bv.x, c[i][j]);
        c[i][j] = fmaf(av[i].y, bv.y, c[i][j]);
        c[i][j] = fmaf(av[i].z, bv.z, c[i][j]);
        c[i][j] = fmaf(av[i].w, bv.w, c[i][j]);
      }
    }
  }
}

// The f32 forward's tile: BM rows of h (a warp holds 16, two lanes' 8 each),
// BN vocabulary columns (16 lanes x TN, lane l holding l + 16 j), FK-deep
// slabs of D in a ring of STAGES; MIN_CTAS an SM (1: registers uncapped).
struct FwdF32 {
  static constexpr int BM = 128, BN = 128, FK = 64, NT = 256;
  static constexpr int STAGES = 2, TM = 8, TN = 8, MIN_CTAS = 1;
  static constexpr int LD = FK + 4;
  static constexpr int STAGE = (BM + BN) * LD;  // floats
  // the ring, then per row m, s, t (f32) and a, label (int)
  static constexpr int SMEM = (STAGES * STAGE + 5 * BM) * 4;
};
static_assert(FwdF32::BM == FwdF32::NT / 32 * 16 &&
                  FwdF32::BN == 16 * FwdF32::TN && FwdF32::TM == 8,
              "a warp's 16 rows: two lanes of 8 rows, 16 lanes of TN columns");

// One CTA: rows [blockIdx.x BM, +BM) against vocabulary tiles
// [blockIdx.y per, +per) (the last range may be shorter). Writes the rows'
// partial (m, s, t, a) to part[4][S][N] (a as int bits), as `ce_fwd_wgmma`.
__global__ void __launch_bounds__(FwdF32::NT, FwdF32::MIN_CTAS)
    ce_fwd_fma(const float* __restrict__ h, const float* __restrict__ wt,
               const int* __restrict__ y, float* __restrict__ part, int N,
               int D, int V, int per) {
  using F = FwdF32;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* sM = ring + F::STAGES * F::STAGE;
  float* sS = sM + F::BM;
  float* sT = sS + F::BM;
  int* sA = reinterpret_cast<int*>(sT + F::BM);
  int* sY = sA + F::BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lx = lane % 16;                         // columns lx + 16 j
  const int r0 = warp * 16 + (lane / 16) * F::TM;   // rows r0 + i
  const int n0 = blockIdx.x * F::BM;
  const int tiles = (V + F::BN - 1) / F::BN;
  const int t_lo = blockIdx.y * per;
  const int t_hi = min(tiles, t_lo + per);
  const int ks = (D + F::FK - 1) / F::FK;
  const int steps = (t_hi - t_lo) * ks;

  for (int r = threadIdx.x; r < F::BM; r += F::NT) {
    sM[r] = -INFINITY;
    sS[r] = sT[r] = 0.f;
    sA[r] = 0;
    sY[r] = n0 + r < N ? y[n0 + r] : -1;
  }

  // step s: depths [k0, k0 + FK) of the h block and of vocabulary tile t
  auto issue = [&](int s) {
    if (s < steps) {
      const int t = t_lo + s / ks, k0 = (s % ks) * F::FK;
      float* st = ring + (s % F::STAGES) * F::STAGE;
      slab_async<F::NT, F::BM, F::FK / 4, F::LD>(st, h, n0, k0, D, N, D);
      slab_async<F::NT, F::BN, F::FK / 4, F::LD>(st + F::BM * F::LD, wt,
                                                 t * F::BN, k0, D, V, D);
    }
    cp_async_commit();
  };

  float c[F::TM][F::TN];
  for (int s = 0; s < F::STAGES - 1; ++s) issue(s);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<F::STAGES - 2>();
    __syncthreads();  // step i landed; everyone is done with step i - 1
    issue(i + F::STAGES - 1);
    const int kk = i % ks;
    if (kk == 0) {
#pragma unroll
      for (int r = 0; r < F::TM; ++r)
#pragma unroll
        for (int j = 0; j < F::TN; ++j) c[r][j] = 0.f;
    }
    const float* st = ring + (i % F::STAGES) * F::STAGE;
    fma_slab<F::FK, F::TM, F::TN, 1, 16>(c, st + r0 * F::LD,
                                         st + (F::BM + lx) * F::LD);
    if (kk != ks - 1) continue;

    // ---- the tile's logits are whole: fold them into the rows' state
    const int v0 = (t_lo + i / ks) * F::BN;
    if (v0 + F::BN > V) {
#pragma unroll
      for (int j = 0; j < F::TN; ++j)
        if (v0 + lx + 16 * j >= V) {
#pragma unroll
          for (int r = 0; r < F::TM; ++r) c[r][j] = -INFINITY;
        }
    }
#pragma unroll
    for (int r = 0; r < F::TM; ++r) {
      // this lane's max and its first column, then the 16 lanes' (the
      // larger max; on a tie the smaller column: jnp.argmax's rule)
      float mx = c[r][0];
      int col = lx;
#pragma unroll
      for (int j = 1; j < F::TN; ++j)
        if (c[r][j] > mx) {
          mx = c[r][j];
          col = lx + 16 * j;
        }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) {
        const float om = __shfl_xor_sync(0xffffffffu, mx, off);
        const int oc = __shfl_xor_sync(0xffffffffu, col, off);
        if (om > mx || (om == mx && oc < col)) {
          mx = om;
          col = oc;
        }
      }
      const float mb = mx * LOG2E;
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < F::TN; ++j) se += ex2(fmaf(c[r][j], LOG2E, -mb));
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        se += __shfl_xor_sync(0xffffffffu, se, off);
      const int row = r0 + r;
      const int yl = sY[row] - v0;
      if (yl >= 0 && yl < F::BN && sY[row] < V) {
#pragma unroll
        for (int j = 0; j < F::TN; ++j)
          if (lx + 16 * j == yl) sT[row] += c[r][j];  // one lane holds it
      }
      if (lx == 0) {
        const float m = sM[row];
        if (mx > m) {  // strictly greater: an earlier tile keeps ties
          sS[row] = sS[row] * ex2((m - mx) * LOG2E) + se;
          sM[row] = mx;
          sA[row] = v0 + col;
        } else {
          sS[row] += se * ex2((mx - m) * LOG2E);
        }
      }
    }
  }
  __syncwarp();  // a row's target logit may come from another lane
  if (lane % 16 == 0) {
    const size_t sn = static_cast<size_t>(gridDim.y) * N;
    int* part_a = reinterpret_cast<int*>(part + 3 * sn);
#pragma unroll
    for (int r = 0; r < F::TM; ++r) {
      const int row = r0 + r;
      if (n0 + row >= N) continue;
      const size_t at = static_cast<size_t>(blockIdx.y) * N + n0 + row;
      part[at] = sM[row];
      part[sn + at] = sS[row];
      part[2 * sn + at] = sT[row];
      part_a[at] = sA[row];
    }
  }
}

// The f32 backward's tile: BM rows R (dh: h; dW: W^T), BS streamed rows T
// a tile (dh: W^T; dW: h), an accumulator of BM x DC columns of the output,
// 8 x 12 a thread (rows 8 g.., columns 4 c + 256 q, q < 3). The logits
// product runs on FK-deep slabs (4 x TN a thread: warps 2 x 4 of 16 rows x
// BS / 4 columns), the second on VK rows of T, DC wide; both slab kinds
// share one ring of STAGES. One CTA an SM (shared memory and registers:
// 229,376 bytes, 255 registers).
struct BwdF32 {
  static constexpr int NT = 256, BM = 32, BS = 256, DC = 768;
  static constexpr int FK = 64, VK = 32, STAGES = 2;
  static constexpr int MIN_CTAS = 1;
  static constexpr int TN = BS / 32;         // logits columns a thread
  static constexpr int LD = FK + 4;          // logits slab row stride
  // the second product's slabs and dl^T [BS][BM] need no padding: their
  // readers take one row at a time (dl's writers meet 8-way conflicts, 4
  // TN stores a thread a tile)
  static constexpr int LDW = DC;
  static constexpr int LDL = BM;
  static constexpr int S1 = (BM + BS) * LD;  // floats
  static constexpr int S2 = VK * LDW;
  static constexpr int STAGE = S1 > S2 ? S1 : S2;
  static constexpr int SMEM = (STAGES * STAGE + BS * LDL) * 4;
};
static_assert(BwdF32::DC == 3 * 256 && BwdF32::BM == BwdF32::NT / 128 * 16 &&
                  BwdF32::BS % 32 == 0 && BwdF32::BS % BwdF32::VK == 0 &&
                  BwdF32::SMEM <= 232448,
              "the two products' thread tiles must cover the CTA's tiles");

// dh (DW false): R = h [nR = N, D], T = wt [nT = V, D], out = dh;
// dW (DW true):  R = wt [nR = V, D], T = h [nT = N, D], out = dW^T.
// lse and labels belong to the rows of h. Grid: (nR / BM, S ranges of
// `per` tiles of T, D / DC chunks). With S = 1 `out` is the result, else
// the range's slice of the f32 workspace [S][nR][D].
template <bool DW>
__global__ void __launch_bounds__(BwdF32::NT, BwdF32::MIN_CTAS)
    ce_bwd_fma(const float* __restrict__ rsrc, int nR,
               const float* __restrict__ tsrc, int nT,
               const int* __restrict__ y, const float* __restrict__ lse,
               float* __restrict__ out, int D, int per) {
  using B = BwdF32;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* sDl = ring + B::STAGES * B::STAGE;  // dl^T: [T row][R row]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * B::BM;
  const int tiles = (nT + B::BS - 1) / B::BS;
  const int t_lo = blockIdx.y * per;
  const int t_hi = min(tiles, t_lo + per);
  const int d0 = blockIdx.z * B::DC;
  const int dcw = min(B::DC, D - d0);         // this chunk's columns
  const int nq = (dcw + 255) / 256;            // its 256-column blocks
  const int ks = (D + B::FK - 1) / B::FK;     // logits slabs a tile
  const int per_tile = ks + B::BS / B::VK;
  const int steps = (t_hi - t_lo) * per_tile;

  // logits: rows pr + 4 i, columns pc + 8 j of the [BM, BS] tile
  const int pr = (warp / 4) * 16 + lane / 8;
  const int pc = (warp % 4) * (B::BS / 4) + lane % 8;
  // accumulator: rows ar + i, columns ac + 256 q + e
  const int ar = ((warp / 4) * 2 + lane / 16) * 8;
  const int ac = ((warp % 4) * 16 + lane % 16) * 4;

  // dh: the lse and labels of this thread's logits rows, fixed
  float lr[4];
  int yr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + pr + 4 * i;
    lr[i] = !DW && row < nR ? lse[row] * LOG2E : 0.f;
    yr[i] = !DW && row < nR ? y[row] : -1;
  }

  auto issue = [&](int s) {
    if (s < steps) {
      const int t0 = (t_lo + s / per_tile) * B::BS;
      const int p = s % per_tile;
      float* st = ring + (s % B::STAGES) * B::STAGE;
      if (p < ks) {
        const int k0 = p * B::FK;
        slab_async<B::NT, B::BM, B::FK / 4, B::LD>(st, rsrc, r0, k0, D, nR,
                                                   D);
        slab_async<B::NT, B::BS, B::FK / 4, B::LD>(st + B::BM * B::LD, tsrc,
                                                   t0, k0, D, nT, D);
      } else {
        // the chunk's 256-column blocks in use
        for (int q = 0; q < nq; ++q)
          slab_async<B::NT, B::VK, 64, B::LDW>(st + 256 * q, tsrc,
                                               t0 + (p - ks) * B::VK,
                                               d0 + 256 * q, D, nT, D);
      }
    }
    cp_async_commit();
  };

  float acc[8][12];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[i][j] = 0.f;
  float sc[4][B::TN];

  for (int s = 0; s < B::STAGES - 1; ++s) issue(s);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<B::STAGES - 2>();
    __syncthreads();  // step i landed; everyone is done with step i - 1
    issue(i + B::STAGES - 1);
    const float* st = ring + (i % B::STAGES) * B::STAGE;
    const int p = i % per_tile;
    if (p < ks) {
      // ---- S = R . T^T, one slab of depth
      if (p == 0) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < B::TN; ++b) sc[a][b] = 0.f;
      }
      fma_slab<B::FK, 4, B::TN, 4, 8>(sc, st + pr * B::LD,
                                      st + (B::BM + pc) * B::LD);
      if (p == ks - 1) {
        // dl = exp(S - lse) - onehot, 0 outside nR x nT, stored transposed
        // (the next steps' readers wait at the loop's barrier)
        const int t0 = (t_lo + i / per_tile) * B::BS;
#pragma unroll
        for (int b = 0; b < B::TN; ++b) {
          const int tc = pc + 8 * b;  // tile row of T
          const int tr = t0 + tc;
          float lc = 0.f;
          int yc = -1;
          if (DW && tr < nT) {
            lc = lse[tr] * LOG2E;
            yc = y[tr];
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int rr = pr + 4 * a;  // tile row of R
            const int row = r0 + rr;
            const float l = DW ? lc : lr[a];
            const int lab = DW ? yc : yr[a];
            const int voc = DW ? row : tr;  // the vocabulary index
            sDl[tc * B::LDL + rr] =
                row < nR && tr < nT
                    ? ex2(fmaf(sc[a][b], LOG2E, -l)) - (lab == voc ? 1.f : 0.f)
                    : 0.f;
          }
        }
      }
    } else {
      // ---- acc += dl . T over VK rows of T (all three 256-column blocks:
      // a block past the chunk's width adds to columns never stored)
      const float* dl = sDl + (p - ks) * B::VK * B::LDL + ar;
#pragma unroll
      for (int k = 0; k < B::VK; ++k) {
        const float4 x0 = *reinterpret_cast<const float4*>(dl + k * B::LDL);
        const float4 x1 =
            *reinterpret_cast<const float4*>(dl + k * B::LDL + 4);
        const float dv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 w = *reinterpret_cast<const float4*>(
              st + k * B::LDW + ac + 256 * q);
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            acc[a][4 * q] = fmaf(dv[a], w.x, acc[a][4 * q]);
            acc[a][4 * q + 1] = fmaf(dv[a], w.y, acc[a][4 * q + 1]);
            acc[a][4 * q + 2] = fmaf(dv[a], w.z, acc[a][4 * q + 2]);
            acc[a][4 * q + 3] = fmaf(dv[a], w.w, acc[a][4 * q + 3]);
          }
        }
      }
    }
  }

  const size_t slice = static_cast<size_t>(blockIdx.y) * nR * D;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = r0 + ar + a;
    if (row >= nR) continue;
    float* orow = out + slice + static_cast<size_t>(row) * D + d0;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int col = ac + 256 * q;
      if (col < dcw)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[a][4 * q], acc[a][4 * q + 1], acc[a][4 * q + 2],
                        acc[a][4 * q + 3]);
    }
  }
}

// the S ranges' partial dh [N, D] or dW^T [V, D], summed in range order:
// n4 float4 a range
__global__ void ce_sum_ranges(const float4* __restrict__ part, int S,
                              size_t n4, float4* __restrict__ out) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < n4; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 acc = part[e];
    for (int s = 1; s < S; ++s) {
      const float4 v = part[s * n4 + e];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    out[e] = acc;
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T>
bool shapes_ok(int N, int D, int V) {
  return N >= 1 && V >= 1 && D >= 1 && D % (16 / sizeof(T)) == 0;
}

// S ranges of `per` tiles (ceil(tiles / S)) cover `tiles` with none empty
bool ranges_ok(int S, int tiles) {
  const int per = (tiles + S - 1) / S;
  return S >= 1 && S <= tiles && (S - 1) * per < tiles;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ------------------------------------------------- bf16 dh / dW: mma.sync

// A tile layout of `ce_bwd_mma`: BM resident rows, BS streamed rows per
// tile, NW warps, WN 8-column blocks of the accumulator per warp, S in
// pieces of 32 x PN per warp.
template <int BM_, int BS_, int NW_, int WN_, int PN_>
struct BwdLayout {
  static constexpr int BM = BM_, BS = BS_, NW = NW_, WN = WN_, PN = PN_;
  static constexpr int NT = NW * 32;
  static constexpr int RG = BM / 32;          // 32-row groups of the acc
  static constexpr int CG = NW / RG;          // column groups of the acc
  static constexpr int CW = CG * WN * 8;      // acc columns per CTA
  static constexpr int NP = RG * (BS / PN);   // 32 x PN pieces of S
  static constexpr int KS = NW / NP;          // depth slices of S
  static constexpr int LDL = BS + 8;          // dl tile row stride
  static_assert(BM % 32 == 0 && BS % PN == 0 && PN % 16 == 0 &&
                    WN % 2 == 0 && NW % RG == 0 && NW % NP == 0,
                "the pieces of S and of the acc must split over the warps");
  // D zero-padded so that the KS depth slices are whole 16-deep steps
  static int width(int D) { return round_up(D, 16 * KS); }
  static int smem(int D) {
    const int ld = width(D) + 8;  // +16 bytes: conflict-free ldmatrix rows
    return (BM + 2 * BS) * ld * 2 + (KS - 1) * BM * BS * 4 + BM * LDL * 2 +
           (BM + 2 * BS) * 8;
  }
};

// the main path's layout, and the one `chip_smoke.py` times beside it
#ifndef CE_BWD_ROWS
#define CE_BWD_ROWS 64
#endif
#if CE_BWD_ROWS == 32
using Narrow = BwdLayout<32, 32, 8, 12, 16>;   // 255 registers a thread
#else
using Narrow = BwdLayout<64, 32, 16, 12, 16>;  // 128 registers a thread
#endif
// D > 768: two tile rows fit no more; 768-column chunks of the acc
using Wide = BwdLayout<32, 16, 16, 6, 16>;

// ROWS rows of a row-major [*, D] bf16 matrix into shared memory (row
// stride ld, W columns), 16 bytes per cp.async; rows >= nrows and columns
// >= D are zero-filled
template <int NT, int ROWS>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld,
                                                const bf16* src, int D,
                                                int nrows, int W) {
  const int chunks = W / 8;
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += NT) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    const bool ok = r < nrows && c < D;
    cp_async16(dst + r * ld + c,
               ok ? src + static_cast<long long>(r) * D + c : src, ok);
  }
}

// dh (DW false): R = h [N, D], T = wt [V, D], out = dh [N, D];
// dW (DW true):  R = wt [V, D], T = h [N, D], out = dW^T [V, D].
// lse and labels belong to the rows of h. Grid: (nR / BM, chunks of CW
// acc columns); W is D padded (`BwdLayout::width`).
template <bool DW, typename L>
__global__ void __launch_bounds__(L::NT, 1)
    ce_bwd_mma(const bf16* __restrict__ rsrc, int nR,
               const bf16* __restrict__ tsrc, int nT, const int* y,
               const float* lse, bf16* out, int D, int W) {
  constexpr int BM = L::BM, BS = L::BS, NP = L::NP, KS = L::KS;
  constexpr int WN = L::WN, LDL = L::LDL, NT = L::NT;
  constexpr int NB = L::PN / 8;  // 8-column blocks of an S piece
  extern __shared__ float4 smem4[];
  const int LD = W + 8;
  bf16* sR = reinterpret_cast<bf16*>(smem4);
  bf16* sT = sR + BM * LD;  // [2][BS][LD]
  // partial S of depth slices 1.., [KS - 1][NP][2 NB][32] float4 in
  // accumulator order: each lane stores and loads its own 8 NB values
  float4* sP = reinterpret_cast<float4*>(sT + 2 * BS * LD);
  bf16* sDl = reinterpret_cast<bf16*>(sP + (KS - 1) * BM * BS / 4);
  float* sLse = reinterpret_cast<float*>(sDl + BM * LDL);  // dh: [BM]
  int* sY = reinterpret_cast<int*>(sLse + BM + 2 * BS);    // dW: [2][BS]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // accumulator row (and row + 8)
  const int tig = lane % 4;  // accumulator columns 2 tig, 2 tig + 1
  const int lr = lane % 8;   // ldmatrix: row within an 8x8 matrix
  const int li = lane / 8;   // ldmatrix: which of the four matrices
  const int r0 = blockIdx.x * BM;
  const int nt = (nT + BS - 1) / BS;

  // the tile's lse and labels (dW: they follow the streamed h rows)
  auto load_tile = [&](int t, int st) {
    const int t0 = t * BS;
    load_rows_async<NT, BS>(sT + st * BS * LD, LD,
                            tsrc + static_cast<long long>(t0) * D, D,
                            nT - t0, W);
    if (DW) {
      for (int j = threadIdx.x; j < BS; j += NT) {
        const bool ok = t0 + j < nT;
        cp_async4(sLse + st * BS + j, ok ? lse + t0 + j : lse, ok);
        cp_async4(sY + st * BS + j, ok ? y + t0 + j : y, ok);
      }
    }
  };

  load_rows_async<NT, BM>(sR, LD, rsrc + static_cast<long long>(r0) * D, D,
                          nR - r0, W);
  if (!DW) {
    for (int i = threadIdx.x; i < BM; i += NT) {
      const bool ok = r0 + i < nR;
      sLse[i] = ok ? lse[r0 + i] : 0.f;
      sY[i] = ok ? y[r0 + i] : -1;
    }
  }
  load_tile(0, 0);
  cp_async_commit();

  // S: this warp's 32 x PN piece and depth slice
  const int piece = warp % NP, slice = warp / NP;
  const int pr = (piece / (BS / L::PN)) * 32;
  const int pc = (piece % (BS / L::PN)) * L::PN;
  const int kd = W / KS;
  // acc: this warp's 32 rows and WN * 8 columns
  const int rg = warp / L::CG;
  const int cb = blockIdx.y * L::CW + (warp % L::CG) * WN * 8;

  float acc[2][WN][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < WN; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    const int t0 = t * BS;
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < nt) {
      load_tile(t + 1, st ^ 1);
      cp_async_commit();
    }
    const bf16* tT = sT + st * BS * LD;

    float s[2][NB][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        s[mt][nb][0] = s[mt][nb][1] = s[mt][nb][2] = s[mt][nb][3] = 0.f;
    const bf16* pa =
        sR + (pr + (lane & 15)) * LD + slice * kd + (lane >> 4) * 8;
    const bf16* pb =
        tT + (pc + lr + (li >> 1) * 8) * LD + slice * kd + (li & 1) * 8;
#pragma unroll 4
    for (int k = 0; k < kd; k += 16) {
      unsigned a[2][4], b[NB / 2][4];
#pragma unroll
      for (int jb = 0; jb < NB / 2; ++jb) ldsm_x4(b[jb], pb + jb * 16 * LD + k);
      ldsm_x4(a[0], pa + k);
      ldsm_x4(a[1], pa + 16 * LD + k);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int jb = 0; jb < NB / 2; ++jb) {
          mma_bf16(s[mt][2 * jb], a[mt], b[jb][0], b[jb][1]);
          mma_bf16(s[mt][2 * jb + 1], a[mt], b[jb][2], b[jb][3]);
        }
    }
    constexpr int PQ = 2 * NB;  // float4 of a piece per lane
    float4* part = sP + piece * PQ * 32 + lane;
    if (slice > 0) {
#pragma unroll
      for (int q = 0; q < PQ; ++q) {
        const float* v = s[q / NB][q % NB];
        part[(slice - 1) * NP * PQ * 32 + q * 32] =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();  // partial sums stored

    if (slice == 0) {
#pragma unroll
      for (int ks = 1; ks < KS; ++ks)
#pragma unroll
        for (int q = 0; q < PQ; ++q) {
          const float4 v = part[(ks - 1) * NP * PQ * 32 + q * 32];
          float* o = s[q / NB][q % NB];
          o[0] += v.x;
          o[1] += v.y;
          o[2] += v.z;
          o[3] += v.w;
        }
      // dl = exp(S - lse) - onehot, 0 outside N x V, rounded to bf16
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = pr + mt * 16 + g + 8 * hf;  // tile row (R row)
          const bool row_ok = r0 + i < nR;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const int j = pc + nb * 8 + tig * 2;  // tile column (T row)
            float d[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jj = j + e;
              const float x = s[mt][nb][2 * hf + e];
              const float l = DW ? sLse[st * BS + jj] : sLse[i];
              const int lab = DW ? sY[st * BS + jj] : sY[i];
              const int v = DW ? r0 + i : t0 + jj;  // vocabulary row
              d[e] = row_ok && t0 + jj < nT
                         ? ex2(fmaf(x, LOG2E, -l * LOG2E)) -
                               (lab == v ? 1.f : 0.f)
                         : 0.f;
            }
            *reinterpret_cast<__nv_bfloat162*>(sDl + i * LDL + j) =
                __floats2bfloat162_rn(d[0], d[1]);
          }
        }
    }
    __syncthreads();  // dl stored

    // acc += dl . T: dl through ldmatrix, T through ldmatrix.trans
    const bf16* pl = sDl + (rg * 32 + (lane & 15)) * LDL + (lane >> 4) * 8;
    const bf16* pt = tT + (lr + (li & 1) * 8) * LD + cb + (li >> 1) * 8;
#pragma unroll
    for (int k = 0; k < BS; k += 16) {
      unsigned a0[4], a1[4];
      ldsm_x4(a0, pl + k);
      ldsm_x4(a1, pl + 16 * LDL + k);
#pragma unroll
      for (int jp = 0; jp < WN / 2; ++jp) {
        if (cb + jp * 16 < W) {  // warp-uniform: a chunk past the padding
          unsigned b[4];
          ldsm_x4_t(b, pt + k * LD + jp * 16);
          mma_bf16(acc[0][2 * jp], a0, b[0], b[1]);
          mma_bf16(acc[0][2 * jp + 1], a0, b[2], b[3]);
          mma_bf16(acc[1][2 * jp], a1, b[0], b[1]);
          mma_bf16(acc[1][2 * jp + 1], a1, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + rg * 32 + mt * 16 + g + 8 * hf;
      if (row >= nR) continue;
      bf16* orow = out + static_cast<long long>(row) * D;
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int col = cb + j * 8 + tig * 2;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[mt][j][2 * hf],
                                    acc[mt][j][2 * hf + 1]);
      }
    }
}

template <bool DW, typename L>
int launch_bwd(const bf16* r, int nR, const bf16* t, int nT, const int* y,
               const float* lse, bf16* out, int D, cudaStream_t st) {
  const int W = L::width(D);
  const int smem = L::smem(D);
  int err = set_smem(ce_bwd_mma<DW, L>, smem);
  if (err) return err;
  const dim3 grid((nR + L::BM - 1) / L::BM, (W + L::CW - 1) / L::CW);
  ce_bwd_mma<DW, L><<<grid, L::NT, smem, st>>>(r, nR, t, nT, y, lse, out, D,
                                              W);
  return static_cast<int>(cudaGetLastError());
}

bool narrow(int D) { return Narrow::width(D) <= Narrow::CW; }

int bwd_mma_smem(int D) {
  return narrow(D) ? Narrow::smem(D) : Wide::smem(D);
}

template <bool DW>
int bwd_mma(const void* h, const void* wt, const int* y, const float* lse,
            void* out, int N, int D, int V, cudaStream_t st) {
  const bf16* hb = static_cast<const bf16*>(h);
  const bf16* wb = static_cast<const bf16*>(wt);
  const bf16* r = DW ? wb : hb;
  const bf16* t = DW ? hb : wb;
  const int nR = DW ? V : N, nT = DW ? N : V;
  bf16* o = static_cast<bf16*>(out);
  if (narrow(D)) return launch_bwd<DW, Narrow>(r, nR, t, nT, y, lse, o, D, st);
  return launch_bwd<DW, Wide>(r, nR, t, nT, y, lse, o, D, st);
}

// ------------------------------------------------- bf16 forward: wgmma

// The tile of `ce_fwd_wgmma`: BM rows of h (two consumer warpgroups of 64),
// BN vocabulary columns, BK-deep steps of D (one 128-byte swizzle row of
// bf16), a ring of STAGES (h box + W box) in shared memory.
struct Fwd {
  static constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
  static constexpr int CONSUMERS = 2;                 // warpgroups
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  static constexpr int A_BYTES = BM * BK * 2;         // 16 KB
  static constexpr int B_BYTES = BN * BK * 2;         // 32 KB
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // + 1024 to align the ring to the swizzle's 1024-byte pattern, + the
  // full and empty barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
  static constexpr int EMPTY_ARRIVALS = CONSUMERS * 4;  // one per warp
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
};
static_assert(Fwd::BK * 2 == 128, "a box row is one 128-byte swizzle row");
static_assert(Fwd::STAGE_BYTES % 1024 == 0 && Fwd::A_BYTES % 1024 == 0,
              "every box starts on the swizzle's 1024-byte pattern");
static_assert(Fwd::PRODUCER_REGS * 128 + Fwd::CONSUMER_REGS * 128 *
                      Fwd::CONSUMERS <= 65536,
              "the warpgroups' registers fit the SM");

// One CTA: rows [blockIdx.x * BM, +BM) against vocabulary tiles
// [blockIdx.y * per, +per) (the last range may be shorter). Writes the
// rows' partial (m, s, t, a) to part[4][S][N] (a as int bits).
__global__ void __launch_bounds__(Fwd::THREADS, 1)
    ce_fwd_wgmma(const __grid_constant__ CUtensorMap tm_h,
                 const __grid_constant__ CUtensorMap tm_w,
                 const int* __restrict__ y, float* __restrict__ part, int N,
                 int D, int V, int per) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + Fwd::STAGES * Fwd::STAGE_BYTES;
  const uint32_t empty = full + Fwd::STAGES * 8;
  const int wg = threadIdx.x / 128;
  const int row0 = blockIdx.x * Fwd::BM;
  const int tiles = (V + Fwd::BN - 1) / Fwd::BN;
  const int t_lo = blockIdx.y * per;
  const int t_hi = min(tiles, t_lo + per);
  const int ksteps = (D + Fwd::BK - 1) / Fwd::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Fwd::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, Fwd::EMPTY_ARRIVALS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == Fwd::CONSUMERS) {
    // ---- producer: one thread keeps the ring full
    setmaxnreg_dec<Fwd::PRODUCER_REGS>();
    if (threadIdx.x == Fwd::CONSUMERS * 128) {
      tma_prefetch(&tm_h);
      tma_prefetch(&tm_w);
      int stage = 0;
      unsigned phase = 0;
      for (int t = t_lo; t < t_hi; ++t) {
        for (int k = 0; k < ksteps; ++k) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          const uint32_t sa = ring + stage * Fwd::STAGE_BYTES;
          mbar_arrive_expect_tx(bar, Fwd::STAGE_BYTES);
          tma_load_2d(sa, &tm_h, k * Fwd::BK, row0, bar);
          tma_load_2d(sa + Fwd::A_BYTES, &tm_w, k * Fwd::BK, t * Fwd::BN,
                      bar);
          if (++stage == Fwd::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each, the logits tile in registers
    setmaxnreg_inc<Fwd::CONSUMER_REGS>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int q = lane % 4;  // columns 8 j + 2 q (+1) of every 8-block
    const unsigned quad = 0xFu << (lane & ~3);
    int rows[2], lab[2], a[2];
    float m[2], s[2], tl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rows[r] = row0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
      lab[r] = rows[r] < N ? y[rows[r]] : -1;
      m[r] = -INFINITY;
      s[r] = tl[r] = 0.f;
      a[r] = 0;
    }
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    int stage = 0;
    unsigned phase = 0;
    // this warpgroup's 64 rows of the h box
    const uint32_t a_off = wg * 64 * 128;
    for (int t = t_lo; t < t_hi; ++t) {
      int prev = 0;
      for (int k = 0; k < ksteps; ++k) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t sa = ring + stage * Fwd::STAGE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Fwd::BK / 16; ++kk)
          wgmma_m64n256k16_bf16(acc, smem_desc_sw128(sa + a_off + kk * 32),
                                smem_desc_sw128(sa + Fwd::A_BYTES + kk * 32),
                                (k | kk) != 0);
        wgmma_commit();
        if (k > 0) {
          // the previous step's products are done: release its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = stage;
        if (++stage == Fwd::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * prev);

      const int v0 = t * Fwd::BN;
      if (v0 + Fwd::BN > V) {
#pragma unroll
        for (int i = 0; i < 128; ++i)
          if (v0 + 8 * (i / 4) + 2 * q + i % 2 >= V) acc[i] = -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (mx > m[r]) {  // the same in all four lanes of the quad
          // first column of the tile attaining the max (jnp.argmax's rule)
          int first = 1 << 30;
#pragma unroll
          for (int j = 31; j >= 0; --j) {
            if (acc[4 * j + 2 * r + 1] == mx) first = 8 * j + 2 * q + 1;
            if (acc[4 * j + 2 * r] == mx) first = 8 * j + 2 * q;
          }
          first = min(first, __shfl_xor_sync(quad, first, 1));
          first = min(first, __shfl_xor_sync(quad, first, 2));
          a[r] = v0 + first;  // strictly greater: an earlier tile keeps ties
          s[r] *= ex2((m[r] - mx) * LOG2E);
          m[r] = mx;
        }
        const float mb = m[r] * LOG2E;
        float se = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          se += ex2(fmaf(acc[4 * j + 2 * r], LOG2E, -mb)) +
                ex2(fmaf(acc[4 * j + 2 * r + 1], LOG2E, -mb));
        se += __shfl_xor_sync(0xffffffffu, se, 1);
        se += __shfl_xor_sync(0xffffffffu, se, 2);
        s[r] += se;
        const int yl = lab[r] - v0;
        if (yl >= 0 && yl < Fwd::BN && lab[r] < V) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            if (8 * j + 2 * q == yl) tl[r] += acc[4 * j + 2 * r];
            if (8 * j + 2 * q + 1 == yl) tl[r] += acc[4 * j + 2 * r + 1];
          }
        }
      }
    }
    // the target logit sits in one lane of the quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tl[r] += __shfl_xor_sync(0xffffffffu, tl[r], 1);
      tl[r] += __shfl_xor_sync(0xffffffffu, tl[r], 2);
    }
    if (q == 0) {
      const size_t sn = static_cast<size_t>(gridDim.y) * N;
      int* part_a = reinterpret_cast<int*>(part + 3 * sn);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= N) continue;
        const size_t at = static_cast<size_t>(blockIdx.y) * N + rows[r];
        part[at] = m[r];
        part[sn + at] = s[r];
        part[2 * sn + at] = tl[r];
        part_a[at] = a[r];
      }
    }
  }
}

// one thread per row: the S ranges' partials, combined in range order
__global__ void ce_fwd_combine(const float* __restrict__ part, int S, int N,
                               float* lse, float* tl, int* am) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t sn = static_cast<size_t>(S) * N;
  const int* part_a = reinterpret_cast<const int*>(part + 3 * sn);
  float mx = -INFINITY;
  int arg = 0;
  for (int i = 0; i < S; ++i) {
    const float mi = part[static_cast<size_t>(i) * N + row];
    if (mi > mx) {  // strictly greater: the lowest range keeps ties
      mx = mi;
      arg = part_a[static_cast<size_t>(i) * N + row];
    }
  }
  float sum = 0.f, t = 0.f;
  for (int i = 0; i < S; ++i) {
    const size_t at = static_cast<size_t>(i) * N + row;
    sum += part[sn + at] * expf(part[at] - mx);
    t += part[2 * sn + at];
  }
  lse[row] = mx + logf(sum);
  tl[row] = t;
  am[row] = arg;
}

// cuTensorMapEncodeTiled's signature (cuda.h, CUDA 12), looked up at run
// time so that the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the encoder, looked up once; null with *err set on failure
EncodeTiled encode_tiled(int* err) {
  static int status = 0;
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found != cudaDriverEntryPointSuccess)
      e = cudaErrorSymbolNotFound;
    status = static_cast<int>(e);
    return e == cudaSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  *err = status;
  return fn;
}

// the tensor map of a row-major bf16 [rows, D] matrix in boxes of
// [box_rows, BK], 128-byte swizzled, zero-filled outside; returns 0, or a
// negated CUresult
int encode_rows(EncodeTiled enc, CUtensorMap* map, const void* base,
                int rows, int D, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {Fwd::BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return -static_cast<int>(r);
}

int fwd_bf16(const void* h, const void* wt, const int* y, float* lse,
             float* tl, int* am, float* part, int S, int N, int D, int V,
             cudaStream_t st) {
  const int tiles = (V + Fwd::BN - 1) / Fwd::BN;
  const int per = (tiles + S - 1) / S;
  if (!ranges_ok(S, tiles) || part == nullptr || !aligned16(h) ||
      !aligned16(wt))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  const EncodeTiled enc = encode_tiled(&err);
  if (enc == nullptr) return err ? err : static_cast<int>(cudaErrorUnknown);
  CUtensorMap tm_h, tm_w;
  if ((err = encode_rows(enc, &tm_h, h, N, D, Fwd::BM))) return err;
  if ((err = encode_rows(enc, &tm_w, wt, V, D, Fwd::BN))) return err;
  if ((err = set_smem(ce_fwd_wgmma, Fwd::SMEM))) return err;
  const dim3 grid((N + Fwd::BM - 1) / Fwd::BM, S);
  ce_fwd_wgmma<<<grid, Fwd::THREADS, Fwd::SMEM, st>>>(tm_h, tm_w, y, part,
                                                      N, D, V, per);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  ce_fwd_combine<<<(N + 255) / 256, 256, 0, st>>>(part, S, N, lse, tl, am);
  return static_cast<int>(cudaGetLastError());
}

int fwd_f32(const void* h, const void* wt, const int* y, float* lse,
            float* tl, int* am, float* part, int S, int N, int D, int V,
            cudaStream_t st) {
  const int tiles = (V + FwdF32::BN - 1) / FwdF32::BN;
  if (!ranges_ok(S, tiles) || part == nullptr || !aligned16(h) ||
      !aligned16(wt))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(ce_fwd_fma, FwdF32::SMEM);
  if (err) return err;
  const dim3 grid((N + FwdF32::BM - 1) / FwdF32::BM, S);
  ce_fwd_fma<<<grid, FwdF32::NT, FwdF32::SMEM, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(wt), y, part, N,
      D, V, (tiles + S - 1) / S);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  ce_fwd_combine<<<(N + 255) / 256, 256, 0, st>>>(part, S, N, lse, tl, am);
  return static_cast<int>(cudaGetLastError());
}

// dh (DW false: R = h, T = W^T) or dW^T (DW true: R = W^T, T = h) on
// `ce_bwd_fma<DW>`; S ranges of T's tiles, summed by `ce_sum_ranges` from
// the f32 workspace `part` [S, nR, D] when S > 1
template <bool DW>
int bwd_f32(const void* h, const void* wt, const int* y, const float* lse,
            void* out, float* part, int S, int N, int D, int V,
            cudaStream_t st) {
  using B = BwdF32;
  const int nR = DW ? V : N, nT = DW ? N : V;
  const int tiles = (nT + B::BS - 1) / B::BS;
  if (!ranges_ok(S, tiles) || (S > 1 && part == nullptr) || !aligned16(h) ||
      !aligned16(wt) || !aligned16(out) || !aligned16(part))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(ce_bwd_fma<DW>, B::SMEM);
  if (err) return err;
  const dim3 grid((nR + B::BM - 1) / B::BM, S, (D + B::DC - 1) / B::DC);
  const float* hf = static_cast<const float*>(h);
  const float* wf = static_cast<const float*>(wt);
  ce_bwd_fma<DW><<<grid, B::NT, B::SMEM, st>>>(
      DW ? wf : hf, nR, DW ? hf : wf, nT, y, lse,
      S > 1 ? part : static_cast<float*>(out), D, (tiles + S - 1) / S);
  if ((err = static_cast<int>(cudaGetLastError())) || S == 1) return err;
  const size_t n4 = static_cast<size_t>(nR) * D / 4;
  const size_t want = (n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  ce_sum_ranges<<<blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(part),
                                        S, n4, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h and wt alike); every tensor
// contiguous. Each returns the launch's cudaError_t (0 on success); the
// bf16 forward returns a negated CUresult when a tensor map is refused.
extern "C" int chainermn_ce_smem(int which, int dtype, int D) {
  const bool bf = dtype == 1;
  if (which == 0) return bf ? Fwd::SMEM : FwdF32::SMEM;
  return bf ? bwd_mma_smem(D) : BwdF32::SMEM;
}

// the forward's tile for `dtype`: 0 rows of h per CTA, 1 vocabulary columns
// per tile, 2 depth of one pipeline step, 3 CTAs an SM holds
extern "C" int chainermn_ce_fwd_tile(int which, int dtype) {
  if (dtype == 1)
    return which == 0 ? Fwd::BM : which == 1 ? Fwd::BN : which == 2 ? Fwd::BK
                                                                    : 1;
  return which == 0   ? FwdF32::BM
         : which == 1 ? FwdF32::BN
         : which == 2 ? FwdF32::FK
                      : FwdF32::MIN_CTAS;
}

// the f32 dh's tile: 0 rows of h per CTA, 1 vocabulary rows per tile, 2
// columns of dh per D chunk, 3 CTAs an SM holds
extern "C" int chainermn_ce_dh_tile(int which) {
  return which == 0   ? BwdF32::BM
         : which == 1 ? BwdF32::BS
         : which == 2 ? BwdF32::DC
                      : BwdF32::MIN_CTAS;
}

// the f32 dW's tile (dh's mirror image, one template): 0 vocabulary rows
// per CTA, 1 rows of h per tile, 2 columns of dW per D chunk, 3 CTAs an
// SM holds
extern "C" int chainermn_ce_dw_tile(int which) {
  return chainermn_ce_dh_tile(which);
}

// `part` is an f32 workspace of 4 x splits x N entries and `splits` the
// number of vocabulary ranges (see chainermn_ce_fwd_tile), for both dtypes
extern "C" int chainermn_ce_fwd(const void* h, const void* wt, const int* y,
                                float* lse, float* tl, int* am, float* part,
                                int splits, int dtype, int N, int D, int V,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && shapes_ok<float>(N, D, V))
    return fwd_f32(h, wt, y, lse, tl, am, part, splits, N, D, V, st);
  if (dtype == 1 && shapes_ok<__nv_bfloat16>(N, D, V))
    return fwd_bf16(h, wt, y, lse, tl, am, part, splits, N, D, V, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32: `splits` vocabulary ranges (see chainermn_ce_dh_tile) and, when it
// is above 1, `part` an f32 workspace of splits x N x D entries; bf16
// takes neither (its CTAs own whole rows of dh)
extern "C" int chainermn_ce_dh(const void* h, const void* wt, const int* y,
                               const float* lse, void* dh_out, float* part,
                               int splits, int dtype, int N, int D, int V,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && shapes_ok<float>(N, D, V))
    return bwd_f32<false>(h, wt, y, lse, dh_out, part, splits, N, D, V,
                          st);
  if (dtype == 1 && shapes_ok<__nv_bfloat16>(N, D, V))
    return bwd_mma<false>(h, wt, y, lse, dh_out, N, D, V, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32: `splits` ranges of h's rows (see chainermn_ce_dw_tile) and, when it
// is above 1, `part` an f32 workspace of splits x V x D entries; bf16
// takes neither (its CTAs own whole rows of dW^T)
extern "C" int chainermn_ce_dw(const void* h, const void* wt, const int* y,
                               const float* lse, void* dwt_out, float* part,
                               int splits, int dtype, int N, int D, int V,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && shapes_ok<float>(N, D, V))
    return bwd_f32<true>(h, wt, y, lse, dwt_out, part, splits, N, D, V, st);
  if (dtype == 1 && shapes_ok<__nv_bfloat16>(N, D, V))
    return bwd_mma<true>(h, wt, y, lse, dwt_out, N, D, V, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
