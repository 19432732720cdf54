// Fused LM head + softmax cross-entropy for Hopper (sm_90a), plain C ABI
// for ctypes: three kernels, the logits never reach device memory.
//
// Replaces the TPU kernels of chainermn_tpu/ops/fused_ce.py:
//   ce_fwd  <- `_fwd_kernel` (launched by `_run_fwd`): per row the logsumexp
//              of h . W, the target logit and the first-index argmax;
//   ce_dh   <- `_dh_kernel` (`_bwd_rule`): dh = (softmax - onehot) . W^T;
//   ce_dw   <- `_dw_kernel` (`_bwd_rule`): dW = h^T . (softmax - onehot),
// the softmax rebuilt per tile from the forward's lse. dh and dW leave the
// kernels unscaled, in the input dtype; the wrapper multiplies by dloss / N
// as `_bwd_rule` does.
//
// The head is passed transposed, wt [V, D] row-major (the port's
// `lm_head.weight` as it lies), h [N, D] row-major, labels int32 [N].
//
// What bounds it: at the training shape (N = 8192, D = 768, V = 32768, bf16)
// the three kernels do 2 N D V = 412 GFLOP (forward) and 4 N D V = 825 GFLOP
// each (dh, dW: the logits are recomputed) against ~63 MB of h and W, so they
// are bound by the tensor cores' operations. The design keeps every [rows,
// vocab] logits tile in shared memory and runs the bf16 products on the
// tensor cores through `wmma` 16x16x16 fragments with f32 accumulation (f32
// inputs take plain FMAs on the CUDA cores: that path exists for testing).
// TPU tile rules do not carry over: rows are not padded to a block (ragged N
// and V are masked here), vocab need not divide a tile, and the TPU's
// [256, 768] f32 dh scratch, too large for one SM, becomes a [32, D] f32
// accumulator in shared memory:
//   ce_fwd: one CTA per 64 rows sweeps the vocabulary in 128-column tiles
//           with an online max / sum-exp / target / argmax per row;
//   ce_dh:  one CTA per 32 rows sweeps the vocabulary; per tile it rebuilds
//           dl = softmax - onehot once and adds dl . wt into dh, D in
//           64-column chunks;
//   ce_dw:  one CTA per 32 vocabulary rows sweeps all rows in 64-row tiles
//           and adds dl^T . h into its [32, D] slice of dW.
// No atomics: each output element is owned by one CTA, so the results are
// reproducible run to run. Simple and unpipelined; TMA and wgmma come later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;

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

template <typename L>
struct WmmaLayout;
template <>
struct WmmaLayout<RowMajor> {
  using type = wmma::row_major;
};
template <>
struct WmmaLayout<ColMajor> {
  using type = wmma::col_major;
};

// A BM x BN f32 accumulator tile spread over the CTA: C += A . B with the
// operands in shared memory. bf16 runs on the tensor cores, f32 on FMAs.
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

template <int BM, int BN, typename LA, typename LB>
struct Tile<__nv_bfloat16, BM, BN, LA, LB> {
  static constexpr int NBN = BN / 16;
  static constexpr int NB = (BM / 16) * NBN;
  static constexpr int PER = NB / NWARPS;
  static_assert(BM % 16 == 0 && BN % 16 == 0 && NB % NWARPS == 0,
                "16x16 blocks must split evenly over the warps");
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[PER];

  __device__ static int blk_m(int i) {
    return ((threadIdx.x / 32) + i * NWARPS) / NBN * 16;
  }
  __device__ static int blk_n(int i) {
    return ((threadIdx.x / 32) + i * NWARPS) % NBN * 16;
  }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) wmma::fill_fragment(acc[i], 0.f);
  }
  __device__ void load(const float* c, int ldc) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      wmma::load_matrix_sync(acc[i], c + blk_m(i) * ldc + blk_n(i), ldc,
                             wmma::mem_row_major);
  }
  __device__ void store(float* c, int ldc) const {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      wmma::store_matrix_sync(c + blk_m(i) * ldc + blk_n(i), acc[i], ldc,
                              wmma::mem_row_major);
  }
  template <int K>
  __device__ void mma(const __nv_bfloat16* a, int lda,
                      const __nv_bfloat16* b, int ldb) {
    static_assert(K % 16 == 0, "depth must be a multiple of 16");
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   typename WmmaLayout<LA>::type> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   typename WmmaLayout<LB>::type> fb;
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        wmma::load_matrix_sync(fa, a + at<LA>(blk_m(i), kk, lda), lda);
        wmma::load_matrix_sync(fb, b + at<LB>(kk, blk_n(i), ldb), ldb);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// ---------------------------------------------------------------- forward

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h and wt alike); every tensor
// contiguous. Each returns the launch's cudaError_t (0 on success).
extern "C" int chainermn_ce_smem(int which, int dtype, int D) {
  const bool bf = dtype == 1;
  if (which == 0) return bf ? fwd_smem<__nv_bfloat16>() : fwd_smem<float>();
  if (which == 1) return bf ? dh_smem<__nv_bfloat16>(D) : dh_smem<float>(D);
  return bf ? dw_smem<__nv_bfloat16>(D) : dw_smem<float>(D);
}

extern "C" int chainermn_ce_fwd(const void* h, const void* wt, const int* y,
                                float* lse, float* tl, int* am, int dtype,
                                int N, int D, int V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && shapes_ok<float>(N, D, V))
    return fwd<float>(h, wt, y, lse, tl, am, N, D, V, st);
  if (dtype == 1 && shapes_ok<__nv_bfloat16>(N, D, V))
    return fwd<__nv_bfloat16>(h, wt, y, lse, tl, am, N, D, V, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int chainermn_ce_dh(const void* h, const void* wt, const int* y,
                               const float* lse, void* dh_out, int dtype,
                               int N, int D, int V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && shapes_ok<float>(N, D, V))
    return dh<float>(h, wt, y, lse, dh_out, N, D, V, st);
  if (dtype == 1 && shapes_ok<__nv_bfloat16>(N, D, V))
    return dh<__nv_bfloat16>(h, wt, y, lse, dh_out, N, D, V, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int chainermn_ce_dw(const void* h, const void* wt, const int* y,
                               const float* lse, void* dwt_out, int dtype,
                               int N, int D, int V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && shapes_ok<float>(N, D, V))
    return dw<float>(h, wt, y, lse, dwt_out, N, D, V, st);
  if (dtype == 1 && shapes_ok<__nv_bfloat16>(N, D, V))
    return dw<__nv_bfloat16>(h, wt, y, lse, dwt_out, N, D, V, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
