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
// 989 TFLOP/s bf16 peak. f32 inputs take plain FMAs on the CUDA cores (a
// testing path: its 1e-4 contract is tighter than TF32); the f32 kernels
// sweep the other operand through shared-memory tiles, unpipelined.
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

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int BK = 32;   // depth of one h / wt slab of the logits product
constexpr int DC = 64;   // head-dim columns per chunk of the dh / dW product
constexpr int PAD = 8;   // elements of padding per shared-memory row
constexpr float NEG = -1e30f;

struct RowMajor {};
struct ColMajor {};

// A(m, k): RowMajor a[m * lda + k], ColMajor a[k * lda + m];
// B(k, n): RowMajor b[k * ldb + n], ColMajor b[n * ldb + k].
template <typename L>
__device__ __forceinline__ int at(int i, int j, int ld);
template <>
__device__ __forceinline__ int at<RowMajor>(int i, int j, int ld) {
  return i * ld + j;
}
template <>
__device__ __forceinline__ int at<ColMajor>(int i, int j, int ld) {
  return j * ld + i;
}

// A BM x BN f32 accumulator tile spread over the CTA: C += A . B with the
// f32 operands in shared memory, on FMAs.
template <typename T, int BM, int BN, typename LA, typename LB>
struct Tile;

template <int BM, int BN, typename LA, typename LB>
struct Tile<float, BM, BN, LA, LB> {
  static constexpr int PER = BM * BN / NTHREADS;
  static_assert(BM * BN % NTHREADS == 0, "tile must split over the CTA");
  float acc[PER];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  }
  __device__ void load(const float* c, int ldc) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NTHREADS;
      acc[i] = c[(e / BN) * ldc + e % BN];
    }
  }
  __device__ void store(float* c, int ldc) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NTHREADS;
      c[(e / BN) * ldc + e % BN] = acc[i];
    }
  }
  template <int K>
  __device__ void mma(const float* a, int lda, const float* b, int ldb) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NTHREADS;
      const int m = e / BN, n = e % BN;
      float t = acc[i];
#pragma unroll 8
      for (int k = 0; k < K; ++k)
        t = fmaf(a[at<LA>(m, k, lda)], b[at<LB>(k, n, ldb)], t);
      acc[i] = t;
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// ROWS x COLS slab of a row-major global matrix (row stride `lds`) into
// shared memory (row stride `ldd`), 16 bytes at a time; rows >= nrows and
// columns >= ncols read as zero. ncols is a multiple of 16 bytes of T.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_slab(T* dst, int ldd, const T* src,
                                          long long lds, int nrows,
                                          int ncols) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int PER_ROW = COLS / CH;
  static_assert(COLS % CH == 0, "slab width must hold whole 16-byte chunks");
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += NTHREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows && c < ncols)
      val = *reinterpret_cast<const uint4*>(src + r * lds + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = val;
  }
}

// logits tile C[BM x BN] = h[n0:, :] . wt[v0:, :]^T over the whole depth D
template <typename T, int BM, int BN>
__device__ __forceinline__ void logits_tile(
    Tile<T, BM, BN, RowMajor, ColMajor>& acc, T* sA, T* sB, const T* h,
    const T* wt, int n0, int v0, int N, int V, int D) {
  acc.zero();
  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();  // the previous slab's readers are done
    load_slab<T, BM, BK>(sA, BK + PAD, h + static_cast<long long>(n0) * D + k0,
                         D, N - n0, D - k0);
    load_slab<T, BN, BK>(sB, BK + PAD,
                         wt + static_cast<long long>(v0) * D + k0, D, V - v0,
                         D - k0);
    __syncthreads();
    acc.template mma<BK>(sA, BK + PAD, sB, BK + PAD);
  }
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ------------------------------------------------------------ f32 forward

constexpr int F_BM = 64, F_BN = 128;

template <typename T>
constexpr int fwd_smem() {
  return (F_BM + F_BN) * (BK + PAD) * static_cast<int>(sizeof(T)) +
         F_BM * (F_BN + 4) * 4;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ce_fwd_kernel(const T* h, const T* wt, const int* y, float* lse,
                  float* tl, int* am, int N, int D, int V) {
  extern __shared__ float4 smem4[];
  T* sA = reinterpret_cast<T*>(smem4);
  T* sB = sA + F_BM * (BK + PAD);
  float* sC = reinterpret_cast<float*>(sB + F_BN * (BK + PAD));
  constexpr int LDC = F_BN + 4;
  constexpr int RPW = F_BM / NWARPS;  // rows per warp in the epilogue
  const int n0 = blockIdx.x * F_BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float m[RPW], s[RPW], t[RPW];
  int a[RPW], yy[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = n0 + warp * RPW + i;
    m[i] = NEG;
    s[i] = t[i] = 0.f;
    a[i] = 0;
    yy[i] = row < N ? y[row] : -1;
  }

  Tile<T, F_BM, F_BN, RowMajor, ColMajor> acc;
  for (int v0 = 0; v0 < V; v0 += F_BN) {
    logits_tile<T, F_BM, F_BN>(acc, sA, sB, h, wt, n0, v0, N, V, D);
    acc.store(sC, LDC);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float* crow = sC + (warp * RPW + i) * LDC;
      float x[F_BN / 32];
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < F_BN / 32; ++j) {
        const int c = lane + 32 * j;
        x[j] = v0 + c < V ? crow[c] : -INFINITY;
        mc = fmaxf(mc, x[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      // first column attaining the tile max (jnp.argmax's tie rule)
      int first = 1 << 30;
#pragma unroll
      for (int j = F_BN / 32 - 1; j >= 0; --j)
        if (x[j] == mc) first = lane + 32 * j;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
      const float m_new = fmaxf(m[i], mc);
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < F_BN / 32; ++j) se += expf(x[j] - m_new);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        se += __shfl_xor_sync(0xffffffffu, se, off);
      s[i] = s[i] * expf(m[i] - m_new) + se;
      if (mc > m[i]) a[i] = v0 + first;  // strictly greater: first tile wins
      m[i] = m_new;
      const int yl = yy[i] - v0;
      if (yl >= 0 && yl < F_BN && yy[i] < V) t[i] += crow[yl];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = n0 + warp * RPW + i;
      if (row < N) {
        lse[row] = m[i] + logf(s[i]);
        tl[row] = t[i];
        am[row] = a[i];
      }
    }
  }
}

// -------------------------------------------------------------- dl tiles

// dl = exp(logit - lse) - onehot(y), rounded to T, zero outside N x V
template <typename T, int BM, int BN>
__device__ __forceinline__ void dl_tile(T* sDl, int lddl, const float* sC,
                                        int ldc, const float* sLse,
                                        const int* sY, int n0, int v0, int N,
                                        int V) {
  for (int e = threadIdx.x; e < BM * BN; e += NTHREADS) {
    const int r = e / BN, c = e % BN;
    float x = 0.f;
    if (n0 + r < N && v0 + c < V)
      x = expf(sC[r * ldc + c] - sLse[r]) - (sY[r] == v0 + c ? 1.f : 0.f);
    sDl[r * lddl + c] = from_float<T>(x);
  }
}

template <int ROWS>
__device__ __forceinline__ void stage_rows(float* sLse, int* sY,
                                           const float* lse, const int* y,
                                           int n0, int N) {
  for (int r = threadIdx.x; r < ROWS; r += NTHREADS) {
    const bool ok = n0 + r < N;
    sLse[r] = ok ? lse[n0 + r] : 0.f;
    sY[r] = ok ? y[n0 + r] : -1;
  }
}

// --------------------------------------------------------------------- dh

constexpr int H_BM = 32, H_BN = 128;

template <typename T>
int dh_smem(int D) {
  const int dp = round_up(D, DC);
  return H_BM * (BK + PAD) * static_cast<int>(sizeof(T)) +
         H_BN * (DC + PAD) * static_cast<int>(sizeof(T)) +
         H_BM * (H_BN + 4) * 4 +
         H_BM * (H_BN + PAD) * static_cast<int>(sizeof(T)) +
         H_BM * (dp + 4) * 4 + H_BM * 8;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ce_dh_kernel(const T* h, const T* wt, const int* y, const float* lse,
                 T* dh, int N, int D, int V) {
  static_assert(DC >= BK, "the wt buffer serves both products");
  extern __shared__ float4 smem4[];
  constexpr int LDC = H_BN + 4, LDL = H_BN + PAD, LDB = DC + PAD;
  const int ldh = round_up(D, DC) + 4;
  T* sA = reinterpret_cast<T*>(smem4);
  T* sB = sA + H_BM * (BK + PAD);
  float* sC = reinterpret_cast<float*>(sB + H_BN * LDB);
  T* sDl = reinterpret_cast<T*>(sC + H_BM * LDC);
  float* sDh = reinterpret_cast<float*>(sDl + H_BM * LDL);
  float* sLse = sDh + H_BM * ldh;
  int* sY = reinterpret_cast<int*>(sLse + H_BM);
  const int n0 = blockIdx.x * H_BM;

  for (int e = threadIdx.x; e < H_BM * ldh; e += NTHREADS) sDh[e] = 0.f;
  stage_rows<H_BM>(sLse, sY, lse, y, n0, N);

  Tile<T, H_BM, H_BN, RowMajor, ColMajor> acc;
  Tile<T, H_BM, DC, RowMajor, RowMajor> acc2;
  for (int v0 = 0; v0 < V; v0 += H_BN) {
    logits_tile<T, H_BM, H_BN>(acc, sA, sB, h, wt, n0, v0, N, V, D);
    acc.store(sC, LDC);
    __syncthreads();
    dl_tile<T, H_BM, H_BN>(sDl, LDL, sC, LDC, sLse, sY, n0, v0, N, V);
    for (int dc = 0; dc < D; dc += DC) {
      __syncthreads();  // sDl written; previous chunk's sB readers done
      load_slab<T, H_BN, DC>(sB, LDB,
                             wt + static_cast<long long>(v0) * D + dc, D,
                             V - v0, D - dc);
      __syncthreads();
      acc2.load(sDh + dc, ldh);
      acc2.template mma<H_BN>(sDl, LDL, sB, LDB);
      acc2.store(sDh + dc, ldh);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H_BM * D; e += NTHREADS) {
    const int r = e / D, c = e % D;
    if (n0 + r < N)
      dh[static_cast<long long>(n0 + r) * D + c] =
          from_float<T>(sDh[r * ldh + c]);
  }
}

// --------------------------------------------------------------------- dW

constexpr int W_BV = 32, W_BM = 64;

template <typename T>
int dw_smem(int D) {
  const int dp = round_up(D, DC);
  return W_BM * (BK + PAD) * static_cast<int>(sizeof(T)) +
         W_BV * (BK + PAD) * static_cast<int>(sizeof(T)) +
         W_BM * (W_BV + 4) * 4 +
         W_BM * (W_BV + PAD) * static_cast<int>(sizeof(T)) +
         W_BM * (DC + PAD) * static_cast<int>(sizeof(T)) +
         W_BV * (dp + 4) * 4 + W_BM * 8;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ce_dw_kernel(const T* h, const T* wt, const int* y, const float* lse,
                 T* dwt, int N, int D, int V) {
  extern __shared__ float4 smem4[];
  constexpr int LDC = W_BV + 4, LDL = W_BV + PAD, LDH = DC + PAD;
  const int ldw = round_up(D, DC) + 4;
  T* sA = reinterpret_cast<T*>(smem4);
  T* sB = sA + W_BM * (BK + PAD);
  float* sC = reinterpret_cast<float*>(sB + W_BV * (BK + PAD));
  T* sDl = reinterpret_cast<T*>(sC + W_BM * LDC);
  T* sH = sDl + W_BM * LDL;
  float* sDw = reinterpret_cast<float*>(sH + W_BM * LDH);
  float* sLse = sDw + W_BV * ldw;
  int* sY = reinterpret_cast<int*>(sLse + W_BM);
  const int v0 = blockIdx.x * W_BV;

  for (int e = threadIdx.x; e < W_BV * ldw; e += NTHREADS) sDw[e] = 0.f;

  // logits tile rows are h rows, columns this CTA's vocabulary rows
  Tile<T, W_BM, W_BV, RowMajor, ColMajor> acc;
  // dW^T[v, d] += sum_r dl[r, v] h[r, d]: A(v, r) = sDl[r][v]
  Tile<T, W_BV, DC, ColMajor, RowMajor> acc2;
  for (int n0 = 0; n0 < N; n0 += W_BM) {
    logits_tile<T, W_BM, W_BV>(acc, sA, sB, h, wt, n0, v0, N, V, D);
    acc.store(sC, LDC);
    stage_rows<W_BM>(sLse, sY, lse, y, n0, N);
    __syncthreads();
    dl_tile<T, W_BM, W_BV>(sDl, LDL, sC, LDC, sLse, sY, n0, v0, N, V);
    for (int dc = 0; dc < D; dc += DC) {
      __syncthreads();
      load_slab<T, W_BM, DC>(sH, LDH, h + static_cast<long long>(n0) * D + dc,
                             D, N - n0, D - dc);
      __syncthreads();
      acc2.load(sDw + dc, ldw);
      acc2.template mma<W_BM>(sDl, LDL, sH, LDH);
      acc2.store(sDw + dc, ldw);
    }
    __syncthreads();  // sLse / sY / sDl readers done before the next tile
  }
  __syncthreads();
  for (int e = threadIdx.x; e < W_BV * D; e += NTHREADS) {
    const int r = e / D, c = e % D;
    if (v0 + r < V)
      dwt[static_cast<long long>(v0 + r) * D + c] =
          from_float<T>(sDw[r * ldw + c]);
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

template <typename T>
int fwd(const void* h, const void* wt, const int* y, float* lse, float* tl,
        int* am, int N, int D, int V, cudaStream_t st) {
  const int smem = fwd_smem<T>();
  int err = set_smem(ce_fwd_kernel<T>, smem);
  if (err) return err;
  ce_fwd_kernel<T><<<(N + F_BM - 1) / F_BM, NTHREADS, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(wt), y, lse, tl, am, N,
      D, V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dh(const void* h, const void* wt, const int* y, const float* lse,
       void* out, int N, int D, int V, cudaStream_t st) {
  const int smem = dh_smem<T>(D);
  int err = set_smem(ce_dh_kernel<T>, smem);
  if (err) return err;
  ce_dh_kernel<T><<<(N + H_BM - 1) / H_BM, NTHREADS, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(wt), y, lse,
      static_cast<T*>(out), N, D, V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dw(const void* h, const void* wt, const int* y, const float* lse,
       void* out, int N, int D, int V, cudaStream_t st) {
  const int smem = dw_smem<T>(D);
  int err = set_smem(ce_dw_kernel<T>, smem);
  if (err) return err;
  ce_dw_kernel<T><<<(V + W_BV - 1) / W_BV, NTHREADS, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(wt), y, lse,
      static_cast<T*>(out), N, D, V);
  return static_cast<int>(cudaGetLastError());
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
  // S ranges of `per` tiles must cover the vocabulary with none empty
  if (S < 1 || S > tiles || (S - 1) * per >= tiles || part == nullptr ||
      (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(wt)) %
          16)
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h and wt alike); every tensor
// contiguous. Each returns the launch's cudaError_t (0 on success); the
// bf16 forward returns a negated CUresult when a tensor map is refused.
extern "C" int chainermn_ce_smem(int which, int dtype, int D) {
  const bool bf = dtype == 1;
  if (which == 0) return bf ? Fwd::SMEM : fwd_smem<float>();
  if (bf) return bwd_mma_smem(D);
  return which == 1 ? dh_smem<float>(D) : dw_smem<float>(D);
}

// the bf16 forward's tile: 0 rows of h per CTA, 1 vocabulary columns per
// tile, 2 depth of one pipeline step
extern "C" int chainermn_ce_fwd_tile(int which) {
  return which == 0 ? Fwd::BM : which == 1 ? Fwd::BN : Fwd::BK;
}

// bf16: `part` is an f32 workspace of 4 x splits x N entries and `splits`
// the number of vocabulary ranges (see chainermn_ce_fwd_tile); f32 takes
// neither (one CTA sweeps the whole vocabulary)
extern "C" int chainermn_ce_fwd(const void* h, const void* wt, const int* y,
                                float* lse, float* tl, int* am, float* part,
                                int splits, int dtype, int N, int D, int V,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && shapes_ok<float>(N, D, V))
    return fwd<float>(h, wt, y, lse, tl, am, N, D, V, st);
  if (dtype == 1 && shapes_ok<__nv_bfloat16>(N, D, V))
    return fwd_bf16(h, wt, y, lse, tl, am, part, splits, N, D, V, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int chainermn_ce_dh(const void* h, const void* wt, const int* y,
                               const float* lse, void* dh_out, int dtype,
                               int N, int D, int V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && shapes_ok<float>(N, D, V))
    return dh<float>(h, wt, y, lse, dh_out, N, D, V, st);
  if (dtype == 1 && shapes_ok<__nv_bfloat16>(N, D, V))
    return bwd_mma<false>(h, wt, y, lse, dh_out, N, D, V, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int chainermn_ce_dw(const void* h, const void* wt, const int* y,
                               const float* lse, void* dwt_out, int dtype,
                               int N, int D, int V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && shapes_ok<float>(N, D, V))
    return dw<float>(h, wt, y, lse, dwt_out, N, D, V, st);
  if (dtype == 1 && shapes_ok<__nv_bfloat16>(N, D, V))
    return bwd_mma<true>(h, wt, y, lse, dwt_out, N, D, V, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
