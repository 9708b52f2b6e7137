// Flash-attention backward for Hopper (sm_90a): dq in one kernel, dk/dv and
// the bias gradient in another, both re-forming the probability tile from
// the forward's per-row logsumexp.
//
// Replaces the TPU kernels analytics_zoo_tpu/ops/flash_attention.py:
// _dq_kernel and _dkv_kernel (launched by _flash_backward) and computes what
// they compute, for s = (q k^T) * scale (+ bias[key]) (causal: -1e30 where
// q_pos < k_pos, q_pos offset by s_k - s_q):
//   p    = exp(s - lse)                      f32
//   dp   = dO v^T                            f32
//   ds   = p * (dp - delta)                  f32; delta = rowsum(dO * out) - g_lse
//   dq   = scale * sum_k ds k                (dq kernel)
//   dv   = sum_q p^T dO,  dk = scale * sum_q ds^T q,  dbias = sum_q ds
//                                            (dkv kernel; dbias f32 per key)
// bf16 inputs: every product takes bf16 operands with f32 accumulation, and
// p and ds are rounded to bf16 before p^T dO, ds k and ds^T q, as the TPU
// kernels' _mm(..., cdt) does; p, ds, lse, delta and dbias stay f32. f32
// inputs: plain f32 FMA, no TF32.
//
// The TPU kernels carry their accumulators in scratch across a sequential
// grid axis. Hopper runs blocks in no order, so one CTA owns one output tile
// and loops over the other sequence itself: a dq CTA owns R query rows and
// walks the key tiles; a dkv CTA owns R keys and walks the query tiles. Every
// sum is then taken in a fixed order inside one CTA, with no atomics, so the
// gradients are the same from run to run; that is why the work is split in
// two kernels, as on the TPU.
//
// Bound. At BERT-base training's attention shape (batch 64, 12 heads, seq
// 128, d 64, bf16) the dq kernel must read q, k, v, dO, lse and delta and
// write dq, about 63 MB, for 3 s^2 d products per head (4.8e9 flop); the dkv
// kernel reads the same and writes dk and dv, about 76 MB, for 4 products
// (6.4e9 flop). At 3.35 TB/s against 989 TF/s both are bound by bytes
// (~0.019 and ~0.023 ms). The design keeps the s x s tiles out of device
// memory; q/dO (dq) or k/v (dkv) stay in shared memory for the whole walk.
//
// Design (first version: right and simple; TMA, wgmma, pipelining and
// fusing dq into the dkv pass come later). 128 threads per CTA. The tile
// products are WMMA (mma.sync) bf16 16x16x16 tiles with f32 accumulation
// (scalar FMA for f32), staged through shared memory: the elementwise step
// needs each tile element with its row's lse/delta, and WMMA fragments hide
// their row mapping. R and the walked tile width C are 64, or 32 where head
// dim 256 (or f32 with head dim 128) would not fit 227 KB of shared memory.
// Causal tiles that hold no live (q, k) pair are skipped, as
// _causal_block_live skips them. The bias is read through strides in its own
// dtype (the input dtype or f32) and widened to f32 as it loads, so a
// (batch, 1, 1, s_k) padding mask reaches the kernels as it is.
//
// C interface (ctypes): azoo_flash_attention_bwd_dq and
// azoo_flash_attention_bwd_dkv return a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB: the most a block may opt in to

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// The additive key bias: element (batch, head, key) at
// row(bh) + key * sk, in T or (f32 == 1) in f32; null for no bias.
struct Bias {
  const void* ptr;
  int f32;
  int n_head;
  long long sb, sh, sk;  // element strides of batch, head and key

  __device__ __forceinline__ long long row(int bh) const {
    return (bh / n_head) * sb + (bh % n_head) * sh;
  }
  template <typename T>
  __device__ __forceinline__ float at(long long row_off, int key) const {
    const long long i = row_off + (long long)key * sk;
    return f32 ? static_cast<const float*>(ptr)[i]
               : to_float(static_cast<const T*>(ptr)[i]);
  }
};

// ROWS x D tile from a contiguous (rows, D) global array into shared memory
// with row stride LD, 16 bytes per thread per step.
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<uint4*>(dst + r * LD + c * VEC) =
        *reinterpret_cast<const uint4*>(src + size_t(r) * D + c * VEC);
  }
}

// One warp: C[16 x NC] (+)= A[16 x KD] B. A row-major with stride lda; C f32
// row-major with stride ldc. B_T: B is stored (NC x KD) row-major and used
// transposed (A B^T); otherwise B is (KD x NC) row-major.
template <typename T, int KD, int NC, bool B_T, bool ACC>
__device__ __forceinline__ void warp_mm(const T* A, int lda, const T* B,
                                        int ldb, float* C, int ldc,
                                        int lane) {
  static_assert(KD % 16 == 0 && NC % 16 == 0, "16-wide tiles");
  if constexpr (std::is_same<T, bf16>::value) {
    using BLayout =
        typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
    for (int n = 0; n < NC / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (ACC)
        wmma::load_matrix_sync(acc, C + n * 16, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < KD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
        wmma::load_matrix_sync(a, A + kk * 16, lda);
        if (B_T)
          wmma::load_matrix_sync(b, B + n * 16 * ldb + kk * 16, ldb);
        else
          wmma::load_matrix_sync(b, B + kk * 16 * ldb + n * 16, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + n * 16, acc, ldc, wmma::mem_row_major);
    }
  } else {
    // lane owns E = 16 * NC / 32 elements: for NC >= 32 the columns
    // lane + 32 j of every row, for NC == 16 column lane % 16 of every
    // other row
    constexpr int E = NC / 2;
    static_assert(E <= 64, "accumulator registers");
    constexpr int JC = NC >= 32 ? NC / 32 : 1;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int r = NC >= 32 ? e / JC : lane / 16 + 2 * e;
      const int c = NC >= 32 ? lane + 32 * (e % JC) : lane % 16;
      acc[e] = ACC ? C[r * ldc + c] : 0.0f;
    }
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = NC >= 32 ? e / JC : lane / 16 + 2 * e;
        const int c = NC >= 32 ? lane + 32 * (e % JC) : lane % 16;
        const float a = A[r * lda + kk];
        const float b = B_T ? B[c * ldb + kk] : B[kk * ldb + c];
        acc[e] = fmaf(a, b, acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int r = NC >= 32 ? e / JC : lane / 16 + 2 * e;
      const int c = NC >= 32 ? lane + 32 * (e % JC) : lane % 16;
      C[r * ldc + c] = acc[e];
    }
  }
}

// The whole CTA: C[R x N] (+)= A[R x KD] B, 16-row groups of C spread over
// the warps, each group's columns split between the warps left over.
template <typename T, int R, int N, int KD, bool B_T, bool ACC>
__device__ __forceinline__ void cta_mm(const T* A, int lda, const T* B,
                                       int ldb, float* C, int ldc, int warp,
                                       int lane) {
  constexpr int GROUPS = R / 16;
  static_assert(NWARPS % GROUPS == 0, "row groups per warp");
  constexpr int SPLIT = NWARPS / GROUPS;
  static_assert(N % (16 * SPLIT) == 0, "column split");
  constexpr int NC = N / SPLIT;
  const int g = warp % GROUPS, s = warp / GROUPS;
  const T* b = B_T ? B + s * NC * ldb : B + s * NC;
  warp_mm<T, KD, NC, B_T, ACC>(A + g * 16 * lda, lda, b, ldb,
                               C + g * 16 * ldc + s * NC, ldc, lane);
}

// Shared-memory layout of both kernels: the R rows a CTA owns (X, Y: q/dO
// for dq, k/v for dkv), the C rows of the tile it walks (U, W), the f32
// tiles S and dP (R x C), the rounded tile dS (R x C, input dtype) and an f32
// accumulator (R x D), the walked tile's per-row lse/delta or per-key bias;
// the dkv kernel (DKV) adds the rounded P tile and a second accumulator.
template <typename T, int D, int R_, int C_, bool DKV>
struct Layout {
  static constexpr int R = R_, C = C_;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = D + PAD;   // X/Y/U/W row stride (elements)
  static constexpr int SLD = C + 4;    // S/dP row stride (floats)
  static constexpr int PLD = C + PAD;  // P/dS row stride (elements)
  static constexpr int ALD = D + 4;    // accumulator row stride (floats)
  static constexpr int TPR = NTHREADS / R;  // threads per row, elementwise
  static constexpr int CPT = C / TPR;       // columns per thread
  static constexpr size_t X_OFF = 0;
  static constexpr size_t Y_OFF = align128(X_OFF + size_t(R) * LD * sizeof(T));
  static constexpr size_t U_OFF = align128(Y_OFF + size_t(R) * LD * sizeof(T));
  static constexpr size_t W_OFF = align128(U_OFF + size_t(C) * LD * sizeof(T));
  static constexpr size_t S_OFF = align128(W_OFF + size_t(C) * LD * sizeof(T));
  static constexpr size_t DP_OFF = align128(S_OFF + size_t(R) * SLD * 4);
  static constexpr size_t DS_OFF = align128(DP_OFF + size_t(R) * SLD * 4);
  static constexpr size_t A0_OFF = align128(DS_OFF + size_t(R) * PLD * sizeof(T));
  static constexpr size_t P_OFF = align128(A0_OFF + size_t(R) * ALD * 4);
  static constexpr size_t A1_OFF =
      align128(P_OFF + (DKV ? size_t(R) * PLD * sizeof(T) : 0));
  static constexpr size_t V0_OFF =
      align128(A1_OFF + (DKV ? size_t(R) * ALD * 4 : 0));
  static constexpr size_t V1_OFF = align128(V0_OFF + size_t(C) * 4);
  static constexpr size_t SMEM = align128(V1_OFF + size_t(C) * 4);
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
  static_assert(R % 16 == 0 && C % 16 == 0 && 64 % R == 0 && 64 % C == 0,
                "tiles divide the 64-row envelope");
};

// dq: R = 64 query rows per CTA, 32 for f32 with head dim 256; key tiles of
// C = 64, 32 for head dim 256 or f32 with head dim 128.
template <typename T, int D>
using DqL = Layout<T, D, (sizeof(T) == 4 && D == 256) ? 32 : 64,
                   (D == 256 || (sizeof(T) == 4 && D == 128)) ? 32 : 64,
                   false>;
// dkv: R = 64 keys per CTA, 32 for head dim 256; query tiles as dq's key
// tiles.
template <typename T, int D>
using DkvL = Layout<T, D, D == 256 ? 32 : 64,
                    (D == 256 || (sizeof(T) == 4 && D == 128)) ? 32 : 64,
                    true>;

// grid: (bn * s_q / R); q/dout/dq (bn, s_q, D), k/v (bn, s_k, D), lse and
// delta (bn, s_q) f32; bh = batch * n_head + head.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, const Bias bias,
                    T* __restrict__ dq, int s_q, int s_k, float scale,
                    int causal) {
  using L = DqL<T, D>;
  constexpr int R = L::R, C = L::C;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::X_OFF);
  T* DOs = reinterpret_cast<T*>(smem + L::Y_OFF);
  T* Ks = reinterpret_cast<T*>(smem + L::U_OFF);
  T* Vs = reinterpret_cast<T*>(smem + L::W_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* DPs = reinterpret_cast<float*>(smem + L::DP_OFF);
  T* DSs = reinterpret_cast<T*>(smem + L::DS_OFF);
  float* Acc = reinterpret_cast<float*>(smem + L::A0_OFF);
  float* Bs = reinterpret_cast<float*>(smem + L::V0_OFF);

  const int nq = s_q / R;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* kg = k + size_t(bh) * s_k * D;
  const T* vg = v + size_t(bh) * s_k * D;
  const bool has_bias = bias.ptr != nullptr;
  const long long bias_row = bias.row(bh);

  load_tile<T, D, R, L::LD>(Qs, q + (size_t(bh) * s_q + q0) * D);
  load_tile<T, D, R, L::LD>(DOs, dout + (size_t(bh) * s_q + q0) * D);
  for (int i = tid; i < R * L::ALD; i += NTHREADS) Acc[i] = 0.0f;

  // the elementwise step: TPR consecutive threads own one row, CPT
  // consecutive columns each
  const int row = tid / L::TPR, c0 = (tid % L::TPR) * L::CPT;
  const float lse_r = lse[size_t(bh) * s_q + q0 + row];
  const float delta_r = delta[size_t(bh) * s_q + q0 + row];
  const int off = s_k - s_q;  // bottom-right causal alignment
  const int q_pos = q0 + row + off;

  int n_kt = s_k / C;
  if (causal) {
    // key tiles whose first key lies past the tile's last query are dead
    const int last = q0 + R - 1 + off;
    n_kt = last < 0 ? 0 : min(n_kt, last / C + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's K, V, dS and bias are consumed
    load_tile<T, D, C, L::LD>(Ks, kg + size_t(kt) * C * D);
    load_tile<T, D, C, L::LD>(Vs, vg + size_t(kt) * C * D);
    if (has_bias)
      for (int i = tid; i < C; i += NTHREADS)
        Bs[i] = bias.at<T>(bias_row, kt * C + i);
    __syncthreads();

    cta_mm<T, R, C, D, true, false>(Qs, L::LD, Ks, L::LD, Ss, L::SLD, warp,
                                    lane);  // S = Q K^T
    cta_mm<T, R, C, D, true, false>(DOs, L::LD, Vs, L::LD, DPs, L::SLD, warp,
                                    lane);  // dP = dO V^T
    __syncthreads();

    const float* srow = Ss + row * L::SLD + c0;
    const float* dprow = DPs + row * L::SLD + c0;
    T* dsrow = DSs + row * L::PLD + c0;
#pragma unroll
    for (int j = 0; j < L::CPT; ++j) {
      float x = srow[j] * scale;
      if (has_bias) x += Bs[c0 + j];
      if (causal && q_pos < kt * C + c0 + j) x = NEG_INF;
      const float p = expf(x - lse_r);
      dsrow[j] = from_float<T>(p * (dprow[j] - delta_r));
    }
    __syncthreads();

    cta_mm<T, R, D, C, false, true>(DSs, L::PLD, Ks, L::LD, Acc, L::ALD, warp,
                                    lane);  // dQ += dS K
  }
  __syncthreads();

  T* dqg = dq + (size_t(bh) * s_q + q0) * D;
  for (int i = tid; i < R * D; i += NTHREADS)
    dqg[i] = from_float<T>(Acc[(i / D) * L::ALD + i % D] * scale);
}

// grid: (bn * s_k / R); dk/dv (bn, s_k, D); dbias (bn, s_k) f32 or null.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, const Bias bias,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dbias, int s_q, int s_k, float scale,
                     int causal) {
  using L = DkvL<T, D>;
  constexpr int R = L::R, C = L::C;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::X_OFF);
  T* Vs = reinterpret_cast<T*>(smem + L::Y_OFF);
  T* Qs = reinterpret_cast<T*>(smem + L::U_OFF);
  T* DOs = reinterpret_cast<T*>(smem + L::W_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);   // S^T (keys x q)
  float* DPs = reinterpret_cast<float*>(smem + L::DP_OFF); // dP^T
  T* Ps = reinterpret_cast<T*>(smem + L::P_OFF);
  T* DSs = reinterpret_cast<T*>(smem + L::DS_OFF);
  float* DK = reinterpret_cast<float*>(smem + L::A0_OFF);
  float* DV = reinterpret_cast<float*>(smem + L::A1_OFF);
  float* Ls = reinterpret_cast<float*>(smem + L::V0_OFF);
  float* Dl = reinterpret_cast<float*>(smem + L::V1_OFF);

  const int nk = s_k / R;
  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qg = q + size_t(bh) * s_q * D;
  const T* dog = dout + size_t(bh) * s_q * D;
  const bool has_bias = bias.ptr != nullptr;

  load_tile<T, D, R, L::LD>(Ks, k + (size_t(bh) * s_k + k0) * D);
  load_tile<T, D, R, L::LD>(Vs, v + (size_t(bh) * s_k + k0) * D);
  for (int i = tid; i < R * L::ALD; i += NTHREADS) {
    DK[i] = 0.0f;
    DV[i] = 0.0f;
  }

  // elementwise: TPR consecutive threads own one key row, CPT consecutive
  // query columns each
  const int row = tid / L::TPR, c0 = (tid % L::TPR) * L::CPT;
  const int k_pos = k0 + row;
  const float b_r = has_bias ? bias.at<T>(bias.row(bh), k_pos) : 0.0f;
  const int off = s_k - s_q;  // bottom-right causal alignment
  float db = 0.0f;

  for (int qt = 0; qt < s_q / C; ++qt) {
    // query tiles whose last query lies before the tile's first key are
    // dead (the same for every thread of the CTA)
    if (causal && qt * C + C - 1 + off < k0) continue;
    __syncthreads();  // the previous tile's Q, dO, P, dS, lse, delta consumed
    load_tile<T, D, C, L::LD>(Qs, qg + size_t(qt) * C * D);
    load_tile<T, D, C, L::LD>(DOs, dog + size_t(qt) * C * D);
    for (int i = tid; i < C; i += NTHREADS) {
      Ls[i] = lse[size_t(bh) * s_q + qt * C + i];
      Dl[i] = delta[size_t(bh) * s_q + qt * C + i];
    }
    __syncthreads();

    cta_mm<T, R, C, D, true, false>(Ks, L::LD, Qs, L::LD, Ss, L::SLD, warp,
                                    lane);  // S^T = K Q^T
    cta_mm<T, R, C, D, true, false>(Vs, L::LD, DOs, L::LD, DPs, L::SLD, warp,
                                    lane);  // dP^T = V dO^T
    __syncthreads();

    const float* srow = Ss + row * L::SLD + c0;
    const float* dprow = DPs + row * L::SLD + c0;
    T* prow = Ps + row * L::PLD + c0;
    T* dsrow = DSs + row * L::PLD + c0;
#pragma unroll
    for (int j = 0; j < L::CPT; ++j) {
      float x = srow[j] * scale;
      if (has_bias) x += b_r;
      if (causal && qt * C + c0 + j + off < k_pos) x = NEG_INF;
      const float p = expf(x - Ls[c0 + j]);
      const float ds = p * (dprow[j] - Dl[c0 + j]);
      prow[j] = from_float<T>(p);
      dsrow[j] = from_float<T>(ds);
      db += ds;
    }
    __syncthreads();

    cta_mm<T, R, D, C, false, true>(Ps, L::PLD, DOs, L::LD, DV, L::ALD, warp,
                                    lane);  // dV += P^T dO
    cta_mm<T, R, D, C, false, true>(DSs, L::PLD, Qs, L::LD, DK, L::ALD, warp,
                                    lane);  // dK += dS^T Q
  }
  for (int o = 1; o < L::TPR; o <<= 1)
    db += __shfl_xor_sync(0xffffffffu, db, o);
  __syncthreads();

  T* dkg = dk + (size_t(bh) * s_k + k0) * D;
  T* dvg = dv + (size_t(bh) * s_k + k0) * D;
  for (int i = tid; i < R * D; i += NTHREADS) {
    const int a = (i / D) * L::ALD + i % D;
    dkg[i] = from_float<T>(DK[a] * scale);
    dvg[i] = from_float<T>(DV[a]);
  }
  if (dbias != nullptr && tid % L::TPR == 0)
    dbias[size_t(bh) * s_k + k_pos] = db;
}

template <typename KernelFn>
cudaError_t launch_cfg(KernelFn kernel, size_t smem, long long blocks) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  Bias bias;
  void *dq, *dk, *dv, *dbias;
  int bn, s_q, s_k;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  using L = DqL<T, D>;
  if (a.s_q % L::R != 0 || a.s_k % L::C != 0 || a.bias.n_head < 1)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)a.bn * (a.s_q / L::R);
  cudaError_t err = launch_cfg(flash_bwd_dq_kernel<T, D>, L::SMEM, blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  flash_bwd_dq_kernel<T, D><<<unsigned(blocks), NTHREADS, L::SMEM, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      a.bias, static_cast<T*>(a.dq), a.s_q, a.s_k, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  using L = DkvL<T, D>;
  if (a.s_k % L::R != 0 || a.s_q % L::C != 0 || a.bias.n_head < 1)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)a.bn * (a.s_k / L::R);
  cudaError_t err = launch_cfg(flash_bwd_dkv_kernel<T, D>, L::SMEM, blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  flash_bwd_dkv_kernel<T, D><<<unsigned(blocks), NTHREADS, L::SMEM,
                               a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      a.bias, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<float*>(a.dbias), a.s_q, a.s_k, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool DQ, typename T>
cudaError_t launch_d(int d, const Args& a) {
  switch (d) {
    case 64:
      return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128:
      return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    case 256:
      return DQ ? launch_dq<T, 256>(a) : launch_dkv<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int launch(int is_bf16, int d, const Args& a) {
  return int(is_bf16 ? launch_d<DQ, bf16>(d, a) : launch_d<DQ, float>(d, a));
}

}  // namespace

// q/k/v/dout: contiguous (bn, s, d) in f32 (is_bf16 == 0) or bf16, with
// bn = batch * n_head; lse, delta: (bn, s_q) f32. bias: null, or the element
// (batch, head, key) at bias_sb * batch + bias_sh * head + bias_sk * key, in
// f32 (bias_f32 == 1) or the input dtype. dq (bn, s_q, d) in the input
// dtype. d in {64, 128, 256}; s_q and s_k multiples of 64. Launches on
// `stream`; does not synchronise.
extern "C" int azoo_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dq, int bn,
    int s_q, int s_k, int d, int is_bf16, float scale, int causal, int n_head,
    int bias_f32, long long bias_sb, long long bias_sh, long long bias_sk,
    void* stream) {
  const Args a{q, k, v, dout, lse, delta,
               Bias{bias, bias_f32, n_head, bias_sb, bias_sh, bias_sk},
               dq, nullptr, nullptr, nullptr, bn, s_q, s_k, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return launch<true>(is_bf16, d, a);
}

// The same inputs; dk, dv (bn, s_k, d) in the input dtype; dbias (bn, s_k)
// f32, or null when the bias needs no gradient.
extern "C" int azoo_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
    void* dbias, int bn, int s_q, int s_k, int d, int is_bf16, float scale,
    int causal, int n_head, int bias_f32, long long bias_sb,
    long long bias_sh, long long bias_sk, void* stream) {
  const Args a{q, k, v, dout, lse, delta,
               Bias{bias, bias_f32, n_head, bias_sb, bias_sh, bias_sk},
               nullptr, dk, dv, dbias, bn, s_q, s_k, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return launch<false>(is_bf16, d, a);
}
