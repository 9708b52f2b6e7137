// Flash-attention backward for Hopper (sm_90a): dq in one kernel, dk/dv and
// the bias gradient in another, both re-forming the probability tile from
// the forward's per-row logsumexp.
//
// Replaces the TPU kernels analytics_zoo_tpu/ops/flash_attention.py:
// _dq_kernel (:323) and _dkv_kernel (:369), launched by _flash_backward
// (:424), and computes what they compute, for s = (q k^T) * scale
// (+ bias[key]) (causal: -1e30 where q_pos < k_pos, q_pos offset by
// s_k - s_q):
//   p     = exp(s - lse)                     f32
//   dp    = dO v^T                           f32
//   delta = rowsum(dO * out) - g_lse         f32
//   ds    = p * (dp - delta)                 f32
//   dq    = scale * sum_k ds k               (dq kernel)
//   dv    = sum_q p^T dO,  dk = scale * sum_q ds^T q,  dbias = sum_q ds
//                                            (dkv kernel; dbias f32 per key)
// bf16 inputs: every product takes bf16 operands with f32 accumulation, and
// p and ds are rounded to bf16 before p^T dO, ds k and ds^T q, as the TPU
// kernels' _mm(..., cdt) does; p, ds, lse, delta and dbias stay f32. f32
// inputs: plain f32 FMA, no TF32.
//
// The TPU kernels carry their accumulators in scratch across a sequential
// grid axis. Hopper runs blocks in no order, so one CTA owns an output tile
// and loops over the other sequence itself: a dq work item owns query rows
// and walks the key tiles, a dkv work item owns keys and walks the query
// tiles. Every sum is taken in a fixed order inside one CTA, with no
// atomics, so the gradients are the same from run to run (a fused kernel
// with atomic dq, as FlashAttention-2/3 have, would not be); that is why
// the work is split in two kernels, as on the TPU.
//
// Bound. At BERT-base training's attention shape (batch 64, 12 heads, seq
// 128, d 64, bf16, a (batch, 1, 1, s) bf16 padding bias) the dq kernel reads
// q, k, v, dO, out, lse and the bias and writes dq and delta: 76.3 MB, for
// 3 products of 2 s^2 d flop per head (4.8e9 flop); the dkv kernel reads q,
// k, v, dO, lse, delta and the bias and writes dk and dv: 76.3 MB, for 4
// products (6.4e9 flop). At 3.35 TB/s against 989 TF/s both are bound by
// bytes, about 0.023 ms each. The s x s tiles never reach device memory.
//
// bf16 at head dims 64 and 128 (the main path: BERT's d is 64): two
// warp-specialised, persistent wgmma kernels, FlashAttention-3's backward
// (arXiv 2407.08608, section 3) split in two deterministic halves and built
// on this port's forward (flash_attention_fwd.cu; the primitives are in
// hopper.cuh). Against what held the first version (below) back:
// - Half-rate tensor cores, accumulators through shared memory: the
//   products are wgmma (m64n64k16 and m64nDk16). S, dP, p and ds live in
//   registers on the accumulator layout, where the elementwise step runs;
//   p and ds are packed to bf16 there and fed back as wgmma's A operand
//   (register-sourced), so no tile goes through shared memory.
// - Low occupancy: one CTA of 384 threads per SM, three warpgroups
//   (setmaxnreg gives the producer 24 registers and each consumer 240); the
//   two consumer warpgroups, 64 rows each, hide each other's latency and
//   the producer's copies hide the memory's.
// - Synchronous copies: the producer's one thread issues TMA copies
//   (cp.async.bulk.tensor, 64-column boxes, 128-byte swizzle) into rings of
//   STAGES stages with full/empty mbarriers, and the item's resident
//   operands into BUFS buffers, so the next work item's loads run under
//   this one's products and epilogue (one persistent CTA per SM walks the
//   work items blockIdx.x, + gridDim.x, ...). Outputs leave through shared
//   memory and a TMA store.
// - delta outside the kernels (four eager f32 launches): the dq kernel
//   forms delta = rowsum(dO * out) - g_lse for its rows from the out tile it
//   loads beside dO, uses it, and writes it, (bn, s_q) f32, for the dkv
//   kernel, which the wrapper launches after it on the same stream.
// Work items and tiles (BwdTile; the plain loops walk the same tiles,
// azoo_flash_attention_bwd_tiles reports them):
// - dq: 128 query rows of one (batch, head), 64 per consumer warpgroup;
//   Q, dO and out resident; K and V tiles of 64 keys stream through the
//   ring with the key tile's bias, staged as f32 in log2 units by a producer
//   warp as the forward stages it. Per tile: S = Q K^T and dP = dO V^T (both
//   operands K-major in shared memory), p = 2^(S scale log2e + bias log2e -
//   lse log2e), ds = p (dP - delta), dQ += ds K (K MN-major). The flush
//   scales dQ and stores it through the out tile.
// - dkv: 128 keys of one (batch, head), 64 per consumer warpgroup; K and V
//   resident; Q and dO tiles of 64 query rows stream through the ring with
//   their 64 values of lse and delta (plain bulk copies). Per tile:
//   S^T = K Q^T and dP^T = V dO^T, p^T and ds^T as above with lse and delta
//   per column and the bias per row (two values a thread, read once per
//   item), dV += p^T dO and dK += ds^T Q. dbias is the row sum of the
//   unrounded ds^T, kept in registers across the walk and reduced over the
//   lane quad by shfl.xor in a fixed order. The flush scales dK and stores
//   dK and dV through the K and V tiles.
// - Causal: a (64-row, 64-key) pair with no live (q, k) is skipped, as
//   _causal_block_live skips it: not computed by the warpgroup, and not
//   loaded where no warpgroup of the CTA needs it. In a live pair, a masked
//   logit is -1e30 * log2e exactly; a fully masked row (s_q > s_k) has lse
//   -1e30, so in a live pair its p would be 2^0 = 1 on every key, as the
//   plain loop gives (with s_q - s_k a multiple of 64 no such row lies in a
//   live pair, so its p is 0 throughout). lse * log2e is rounded on its own
//   (__fmul_rn) so that no FMA contraction keeps it from cancelling the
//   mask exactly.
// - A warpgroup with no rows (an odd number of 64-row tiles) or a pair it
//   skips still waits on and releases every stage, so no warpgroup runs a
//   round ahead on a barrier's parity.
//
// Other routes (f32 at every head dim, bf16 at head dim 256, where dK and
// dV alone would need 256 accumulator registers a thread): the first
// version, 128 threads per CTA, WMMA (mma.sync) bf16 16x16x16 tiles or
// scalar f32 FMA staged through shared memory, one CTA per R rows walking
// tiles of C, copies through registers; delta comes from the wrapper.
//
// C interface (ctypes): azoo_flash_attention_bwd_dq and
// azoo_flash_attention_bwd_dkv return a cudaError_t;
// azoo_flash_attention_bwd_tiles reports each route's tiles.

#include "hopper.cuh"

#include <mma.h>

#include <type_traits>

namespace {

namespace wmma = nvcuda::wmma;

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB: the most a block may opt in to

// ================== f32, and bf16 at head dim 256: the first version ===

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

// ============================= bf16 at head dims 64 and 128: wgmma + TMA ===

// Tiles, stages and shared memory of the two wgmma kernels (DKV: the
// dk/dv/dbias kernel). A work item is CTA_ROWS rows of the owned sequence
// (q for dq, keys for dkv), WG_ROWS per consumer warpgroup; the other
// sequence streams in tiles of WALK rows. Every tile is 64 rows of D bf16
// columns in D / 64 TMA boxes of 8 KB, so every offset below is a multiple
// of the 1024-byte swizzle atom.
template <int D, bool DKV>
struct BwdTile {
  static constexpr int WALK = 64;  // keys (dq) or queries (dkv) per tile
  static constexpr int STAGES = D == 64 ? 3 : 2;
  // buffers of the item's resident operands: with two, the next item's
  // load runs under this one's walk and flush
  static constexpr int BUFS = (DKV || D == 64) ? 2 : 1;
  static constexpr int CTA_ROWS = 2 * WG_ROWS;
  // registers: 384 threads start with 168 each; the producer warpgroup
  // gives up all but PRODUCER_REGS, each consumer thread takes 240
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr uint32_t TILE = WG_ROWS * D * 2;  // one 64-row tile
  // a buffer: dq Q, dO and out (then dQ) for each warpgroup; dkv K and V
  static constexpr uint32_t BUF_BYTES = (DKV ? 4 : 6) * TILE;
  // a ring stage: K and V (dq) or Q and dO (dkv)
  static constexpr uint32_t RING_OFF = BUFS * BUF_BYTES;
  static constexpr uint32_t STAGE_BYTES = 2 * TILE;
  // per stage: the key tile's bias as f32 (dq), or lse and delta (dkv)
  static constexpr uint32_t SMALL_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr uint32_t SMALL_BYTES = (DKV ? 2 : 1) * WALK * 4;
  // barriers: full and empty per buffer, full and empty per stage
  static constexpr uint32_t BAR_OFF = SMALL_OFF + STAGES * SMALL_BYTES;
  static constexpr uint32_t SMEM = BAR_OFF + (2 * BUFS + 2 * STAGES) * 8 + 1024;
  static_assert(WALK == WG_ROWS, "the walked tiles are 64-row TMA boxes");
  static_assert(SMEM <= SMEM_LIMIT, "bf16 backward tile exceeds shared memory");
};

// The pair (64 query rows from q0, 64 keys from k0) holds a live (q, k):
// its last query sees its first key (_causal_block_live)
__device__ __forceinline__ bool pair_live(int q0, int k0, int off,
                                          int causal) {
  return !causal || q0 + WG_ROWS - 1 + off >= k0;
}

// a warpgroup's accumulator rows -> a 64-row bf16 tile in shared memory
// (swizzled as TMA expects), times `mul`: thread (warp, g, t) holds rows
// 16 warp + g and + 8, columns 8 k + 2 t + {0, 1}
template <int D>
__device__ __forceinline__ void stage_tile(uint32_t tile, const float* acc,
                                           float mul, int warp, int g, int t) {
#pragma unroll
  for (int k = 0; k < D / 8; ++k) {
    const uint32_t box = tile + (k / 8) * WG_ROWS * 128;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + g + 8 * h;
      const uint32_t addr = box + row * 128 + (((k % 8) ^ g) << 4) + t * 4;
      const uint32_t val =
          pack_bf16(acc[4 * k + 2 * h] * mul, acc[4 * k + 2 * h + 1] * mul);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(val)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map,
                                               int boxes, int row,
                                               uint32_t tile) {
  for (int b = 0; b < boxes; ++b)
    tma_store(map, b * BOX_COLS, row, tile + b * WG_ROWS * 128);
}

// The two products of one tile that share the elementwise step, issued as
// one group: a[64 x 64] = X Y^T and b[64 x 64] = U W^T, X/U the warpgroup's
// resident 64-row tiles, Y/W the streamed ones, all K-major in boxes of 64
// columns (D / 16 steps of 16 columns, 32 bytes into a box each)
template <int D>
__device__ __forceinline__ void issue_pair(float* a, float* b, uint32_t x,
                                           uint32_t y, uint32_t u,
                                           uint32_t w) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t o = (kk / 4) * WG_ROWS * 128 + (kk % 4) * 32;
    if (kk == 0)
      wgmma_ss_first<64>(a, smem_desc(x + o, 16, 1024),
                         smem_desc(y + o, 16, 1024));
    else
      wgmma_ss<64>(a, smem_desc(x + o, 16, 1024), smem_desc(y + o, 16, 1024));
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t o = (kk / 4) * WG_ROWS * 128 + (kk % 4) * 32;
    if (kk == 0)
      wgmma_ss_first<64>(b, smem_desc(u + o, 16, 1024),
                         smem_desc(w + o, 16, 1024));
    else
      wgmma_ss<64>(b, smem_desc(u + o, 16, 1024), smem_desc(w + o, 16, 1024));
  }
  wgmma_commit();
}

// acc[64 x D] += A[64 x 64] B[64 x D]: A packed bf16 fragments in registers
// (a 64-column accumulator packed pairwise), B a streamed 64-row tile,
// MN-major (16 rows of 128 bytes per step of 16)
template <int D>
__device__ __forceinline__ void issue_rs(float* acc, const uint32_t* a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D>(acc, a + 4 * kk,
                smem_desc(b + kk * 16 * 128, WG_ROWS * 128, 1024));
}

// grid: up to one CTA per SM, each walking work items (bh, 128-row q block)
// blockIdx.x, + gridDim.x, ...; block: 384. tq/tk/tv/tdo/tout/tdq map
// q/k/v/dO/out/dq as (bn * s, D) bf16 in 64 x 64 boxes; lse, delta and
// g_lse (bn, s_q) f32 (g_lse may be null); bh = batch * n_head + head.
template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tout,
                   const __grid_constant__ CUtensorMap tdq, const Bias bias,
                   const float* __restrict__ lse,
                   const float* __restrict__ g_lse,
                   float* __restrict__ delta, int n_items, int s_q, int s_k,
                   float scale, int causal) {
  using C = BwdTile<D, false>;
  constexpr int ST = C::STAGES, NB = C::BUFS, BK = C::WALK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  float* bias_s = reinterpret_cast<float*>(smem + C::SMALL_OFF);
  // tiles g and work items n are counted over the CTA's whole run, so the
  // ring and the buffers run on from one work item to the next
  const uint32_t bars = base + C::BAR_OFF;
  auto buf_full = [&](int n) { return bars + 8 * (n % NB); };
  auto buf_empty = [&](int n) { return bars + 8 * (NB + n % NB); };
  auto full = [&](int g) { return bars + 8 * (2 * NB + g % ST); };
  auto empty = [&](int g) { return bars + 8 * (2 * NB + ST + g % ST); };
  auto round = [&](int g) { return uint32_t(g / ST) & 1; };
  auto buf_round = [&](int n) { return uint32_t(n / NB) & 1; };

  const int nq = (s_q + C::CTA_ROWS - 1) / C::CTA_ROWS;
  const int n_kt = s_k / BK;
  const int off = s_k - s_q;
  // key tiles a warpgroup's 64 rows from r0 need: all, or (causal) those
  // up to the rows' last live key
  auto live_tiles = [&](int r0) {
    if (r0 >= s_q) return 0;
    if (!causal) return n_kt;
    const int last = r0 + WG_ROWS - 1 + off;
    return last < 0 ? 0 : min(n_kt, last / BK + 1);
  };
  struct Item {
    int bh, q0, live0, live1, n_cta;
  };
  auto item_at = [&](int i) {
    Item it;
    it.bh = i / nq;
    it.q0 = (i % nq) * C::CTA_ROWS;
    it.live0 = live_tiles(it.q0);
    it.live1 = live_tiles(it.q0 + WG_ROWS);
    it.n_cta = max(it.live0, it.live1);  // key tiles the CTA loads
    return it;
  };

  if (threadIdx.x == 0) {
    for (int j = 0; j < NB; ++j) {
      mbar_init(buf_full(j), 1);
      mbar_init(buf_empty(j), 2);  // each consumer warpgroup's first thread
    }
    for (int j = 0; j < ST; ++j) {
      mbar_init(full(j), 1 + 32);  // the TMA thread + the bias warp
      mbar_init(empty(j), 256);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, int(threadIdx.x / 128), 0);
  if (role == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS)
                 : "memory");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    int g = 0, n = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
      const Item it = item_at(i);
      if (warp == 0 && lane == 0) {
        const uint32_t buf = base + (n % NB) * C::BUF_BYTES;
        if (n >= NB) mbar_wait(buf_empty(n), buf_round(n) ^ 1);
        const int n_wg = min(2, (s_q - it.q0) / WG_ROWS);
        mbar_expect_tx(buf_full(n), 3 * n_wg * C::TILE);
        for (int w = 0; w < n_wg; ++w) {
          const int row = it.bh * s_q + it.q0 + w * WG_ROWS;
          for (int b = 0; b < C::BOXES; ++b) {
            const uint32_t o = w * C::TILE + b * WG_ROWS * 128;
            tma_load(buf + o, &tq, b * BOX_COLS, row, buf_full(n));
            tma_load(buf + 2 * C::TILE + o, &tdo, b * BOX_COLS, row,
                     buf_full(n));
            tma_load(buf + 4 * C::TILE + o, &tout, b * BOX_COLS, row,
                     buf_full(n));
          }
        }
        for (int j = 0; j < it.n_cta; ++j, ++g) {
          const uint32_t stage = base + C::RING_OFF + (g % ST) * C::STAGE_BYTES;
          const int row = it.bh * s_k + j * BK;
          if (g >= ST) mbar_wait(empty(g), round(g) ^ 1);
          mbar_expect_tx(full(g), 2 * C::TILE);
          for (int b = 0; b < C::BOXES; ++b) {
            tma_load(stage + b * WG_ROWS * 128, &tk, b * BOX_COLS, row,
                     full(g));
            tma_load(stage + C::TILE + b * WG_ROWS * 128, &tv, b * BOX_COLS,
                     row, full(g));
          }
        }
      } else if (warp == 1) {
        const long long brow = bias.row(it.bh);
        for (int j = 0; j < it.n_cta; ++j, ++g) {
          if (g >= ST) mbar_wait(empty(g), round(g) ^ 1);
          for (int k = lane; k < BK; k += 32) {
            const float x =
                bias.ptr != nullptr ? bias.at<bf16>(brow, j * BK + k) : 0.0f;
            bias_s[(g % ST) * BK + k] = x * LOG2E;  // in log2 units
          }
          mbar_arrive(full(g));
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS)
                 : "memory");
    const int w = role - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g_ = lane / 4, t = lane % 4;
    const float scale2 = scale * LOG2E;

    float dq[D / 2], s[BK / 2], dp[BK / 2];
    uint32_t ds[BK / 4];

    int g0 = 0, n = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
      const Item it = item_at(i);
      const int wg_row = it.q0 + w * WG_ROWS;  // the warpgroup's first row
      const int r0 = wg_row + warp * 16 + g_;  // this thread's rows: r0, +8
      const int live = w == 0 ? it.live0 : it.live1;
      const bool rows = wg_row < s_q;
      const uint32_t buf = base + (n % NB) * C::BUF_BYTES;
      const uint32_t q_s = buf + w * C::TILE;
      const uint32_t do_s = buf + (2 + w) * C::TILE;
      const uint32_t o_s = buf + (4 + w) * C::TILE;
#pragma unroll
      for (int k = 0; k < D / 2; ++k) dq[k] = 0.0f;

      mbar_wait(buf_full(n), buf_round(n));
      // delta of rows r0 and r0 + 8 from dO and out: each lane of the quad
      // sums the 16-byte chunks t and t + 4 of each box, then the quad
      // adds its four partial sums (a fixed order)
      float l0 = 0.0f, l1 = 0.0f, d0 = 0.0f, d1 = 0.0f;
      if (rows) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = warp * 16 + g_ + 8 * h;  // row % 8 == g_
          float acc = 0.0f;
#pragma unroll
          for (int b = 0; b < C::BOXES; ++b)
#pragma unroll
            for (int c = t; c < 8; c += 4) {
              const uint32_t o =
                  b * WG_ROWS * 128 + row * 128 + ((c ^ g_) << 4);
              uint4 x, y;
              asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                           : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
                           : "r"(do_s + o));
              asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                           : "=r"(y.x), "=r"(y.y), "=r"(y.z), "=r"(y.w)
                           : "r"(o_s + o));
              const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
              const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 a = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
                const float2 v = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
                acc = fmaf(a.x, v.x, acc);
                acc = fmaf(a.y, v.y, acc);
              }
            }
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          acc += __shfl_xor_sync(0xffffffffu, acc, 2);
          const size_t at = size_t(it.bh) * s_q + r0 + 8 * h;
          if (g_lse != nullptr) acc -= g_lse[at];
          if (t == 0) delta[at] = acc;
          // lse in log2 units, rounded on its own: a fully masked row's
          // -1e30 becomes exactly the mask value and cancels it
          const float l = __fmul_rn(lse[at], LOG2E);
          if (h == 0) {
            d0 = acc;
            l0 = l;
          } else {
            d1 = acc;
            l1 = l;
          }
        }
      }

      for (int j = 0; j < it.n_cta; ++j) {
        const int g = g0 + j;
        mbar_wait(full(g), round(g));
        if (j < live) {
          const uint32_t k_s = base + C::RING_OFF + (g % ST) * C::STAGE_BYTES;
          const uint32_t v_s = k_s + C::TILE;
          issue_pair<D>(s, dp, q_s, k_s, do_s, v_s);  // S = Q K^T, dP = dO V^T
          wgmma_wait<0>();
          fence_regs<BK / 2>(s);
          fence_regs<BK / 2>(dp);
          const uint32_t brow = base + C::SMALL_OFF + (g % ST) * BK * 4;
          const int k0 = j * BK;
          // only a tile on the causal diagonal holds masked keys
          const bool diag = causal && k0 + BK - 1 > wg_row + off;
#pragma unroll
          for (int jj = 0; jj < BK / 8; ++jj) {
            const float2 bv = lds_f2(brow + (8 * jj + 2 * t) * 4);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float p2[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int idx = 4 * jj + 2 * h + e;
                float x = fmaf(s[idx], scale2, e ? bv.y : bv.x);
                if (diag && r0 + 8 * h + off < k0 + 8 * jj + 2 * t + e)
                  x = NEG_INF2;
                const float p = ex2(x - (h ? l1 : l0));
                p2[e] = p * (dp[idx] - (h ? d1 : d0));
              }
              ds[2 * jj + h] = pack_bf16(p2[0], p2[1]);
            }
          }
          wgmma_fence();
          issue_rs<D>(dq, ds, k_s);  // dQ += ds K
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<D / 2>(dq);
          fence_regs_u32<BK / 4>(ds);
        }
        mbar_arrive(empty(g));
      }
      g0 += it.n_cta;

      if (rows) {
        // flush: dQ through the out tile (its last reader was delta) and a
        // TMA store
        named_bar_sync(1 + w, 128);
        stage_tile<D>(o_s, dq, scale, warp, g_, t);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_bar_sync(1 + w, 128);
        if (threadIdx.x % 128 == 0) {
          tma_store_tile(&tdq, C::BOXES, it.bh * s_q + wg_row, o_s);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
      }
      if (threadIdx.x % 128 == 0) mbar_arrive(buf_empty(n));
    }
  }
}

// grid: up to one CTA per SM, each walking work items (bh, 128-key block)
// blockIdx.x, + gridDim.x, ...; block: 384. tq/tk/tv/tdo/tdk/tdv map
// q/k/v/dO/dk/dv as (bn * s, D) bf16 in 64 x 64 boxes; lse, delta (bn, s_q)
// f32; dbias (bn, s_k) f32 or null.
template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdk,
                    const __grid_constant__ CUtensorMap tdv, const Bias bias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ dbias, int n_items, int s_q, int s_k,
                    float scale, int causal) {
  using C = BwdTile<D, true>;
  constexpr int ST = C::STAGES, NB = C::BUFS, BQ = C::WALK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + C::BAR_OFF;
  auto buf_full = [&](int n) { return bars + 8 * (n % NB); };
  auto buf_empty = [&](int n) { return bars + 8 * (NB + n % NB); };
  auto full = [&](int g) { return bars + 8 * (2 * NB + g % ST); };
  auto empty = [&](int g) { return bars + 8 * (2 * NB + ST + g % ST); };
  auto round = [&](int g) { return uint32_t(g / ST) & 1; };
  auto buf_round = [&](int n) { return uint32_t(n / NB) & 1; };

  const int nk = (s_k + C::CTA_ROWS - 1) / C::CTA_ROWS;
  const int n_qt = s_q / BQ;
  const int off = s_k - s_q;
  // the first q tile live for a warpgroup's 64 keys from k0: 0, or
  // (causal) the first whose last query sees k0; n_qt for no keys
  auto first_live = [&](int k0) {
    if (k0 >= s_k) return n_qt;
    if (!causal) return 0;
    const int need = k0 - off - (BQ - 1);  // the tile's last q must reach it
    return need <= 0 ? 0 : min(n_qt, (need + BQ - 1) / BQ);
  };
  struct Item {
    int bh, k0, first0, first1;  // q tiles first0 .. n_qt - 1 are loaded
  };
  auto item_at = [&](int i) {
    Item it;
    it.bh = i / nk;
    it.k0 = (i % nk) * C::CTA_ROWS;
    it.first0 = first_live(it.k0);
    it.first1 = first_live(it.k0 + WG_ROWS);  // never before first0
    return it;
  };

  if (threadIdx.x == 0) {
    for (int j = 0; j < NB; ++j) {
      mbar_init(buf_full(j), 1);
      mbar_init(buf_empty(j), 2);  // each consumer warpgroup's first thread
    }
    for (int j = 0; j < ST; ++j) {
      mbar_init(full(j), 1);
      mbar_init(empty(j), 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, int(threadIdx.x / 128), 0);
  if (role == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x == 0) {
      int g = 0, n = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
        const Item it = item_at(i);
        const uint32_t buf = base + (n % NB) * C::BUF_BYTES;
        if (n >= NB) mbar_wait(buf_empty(n), buf_round(n) ^ 1);
        const int n_wg = min(2, (s_k - it.k0) / WG_ROWS);
        mbar_expect_tx(buf_full(n), 2 * n_wg * C::TILE);
        for (int w = 0; w < n_wg; ++w) {
          const int row = it.bh * s_k + it.k0 + w * WG_ROWS;
          for (int b = 0; b < C::BOXES; ++b) {
            const uint32_t o = w * C::TILE + b * WG_ROWS * 128;
            tma_load(buf + o, &tk, b * BOX_COLS, row, buf_full(n));
            tma_load(buf + 2 * C::TILE + o, &tv, b * BOX_COLS, row,
                     buf_full(n));
          }
        }
        for (int j = it.first0; j < n_qt; ++j, ++g) {
          const uint32_t stage = base + C::RING_OFF + (g % ST) * C::STAGE_BYTES;
          const uint32_t small = base + C::SMALL_OFF + (g % ST) * C::SMALL_BYTES;
          const int row = it.bh * s_q + j * BQ;
          if (g >= ST) mbar_wait(empty(g), round(g) ^ 1);
          mbar_expect_tx(full(g), C::STAGE_BYTES + C::SMALL_BYTES);
          for (int b = 0; b < C::BOXES; ++b) {
            tma_load(stage + b * WG_ROWS * 128, &tq, b * BOX_COLS, row,
                     full(g));
            tma_load(stage + C::TILE + b * WG_ROWS * 128, &tdo, b * BOX_COLS,
                     row, full(g));
          }
          bulk_load(small, lse + row, BQ * 4, full(g));
          bulk_load(small + BQ * 4, delta + row, BQ * 4, full(g));
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS)
                 : "memory");
    const int w = role - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g_ = lane / 4, t = lane % 4;
    const float scale2 = scale * LOG2E;

    float dk[D / 2], dv[D / 2], s[BQ / 2], dp[BQ / 2];
    uint32_t pk[BQ / 4], dsk[BQ / 4];

    int g0 = 0, n = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
      const Item it = item_at(i);
      const int kw = it.k0 + w * WG_ROWS;      // the warpgroup's first key
      const int key0 = kw + warp * 16 + g_;    // this thread's keys: +0, +8
      const bool keys = kw < s_k;
      const int first = w == 0 ? it.first0 : it.first1;
      const uint32_t buf = base + (n % NB) * C::BUF_BYTES;
      const uint32_t k_s = buf + w * C::TILE;
      const uint32_t v_s = buf + (2 + w) * C::TILE;
#pragma unroll
      for (int k = 0; k < D / 2; ++k) dk[k] = dv[k] = 0.0f;
      float db0 = 0.0f, db1 = 0.0f;
      float b0 = 0.0f, b1 = 0.0f;  // the rows' bias in log2 units
      if (keys && bias.ptr != nullptr) {
        const long long brow = bias.row(it.bh);
        b0 = bias.at<bf16>(brow, key0) * LOG2E;
        b1 = bias.at<bf16>(brow, key0 + 8) * LOG2E;
      }

      mbar_wait(buf_full(n), buf_round(n));
      for (int j = it.first0; j < n_qt; ++j) {
        const int g = g0 + j - it.first0;
        mbar_wait(full(g), round(g));
        if (j >= first) {
          const uint32_t q_s = base + C::RING_OFF + (g % ST) * C::STAGE_BYTES;
          const uint32_t do_s = q_s + C::TILE;
          // S^T = K Q^T, dP^T = V dO^T
          issue_pair<D>(s, dp, k_s, q_s, v_s, do_s);
          wgmma_wait<0>();
          fence_regs<BQ / 2>(s);
          fence_regs<BQ / 2>(dp);
          const uint32_t small =
              base + C::SMALL_OFF + (g % ST) * C::SMALL_BYTES;
          const int q0 = j * BQ;
          // only a tile on the causal diagonal holds masked pairs
          const bool diag = causal && q0 + off < kw + WG_ROWS - 1;
          float tb0 = 0.0f, tb1 = 0.0f;  // this tile's part of dbias
#pragma unroll
          for (int jj = 0; jj < BQ / 8; ++jj) {
            const float2 lv = lds_f2(small + (8 * jj + 2 * t) * 4);
            const float2 dl = lds_f2(small + (BQ + 8 * jj + 2 * t) * 4);
            // lse in log2 units, rounded on its own (see the dq kernel)
            const float la = __fmul_rn(lv.x, LOG2E);
            const float lb = __fmul_rn(lv.y, LOG2E);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float p2[2], ds2[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int idx = 4 * jj + 2 * h + e;
                float x = fmaf(s[idx], scale2, h ? b1 : b0);
                if (diag && q0 + 8 * jj + 2 * t + e + off < key0 + 8 * h)
                  x = NEG_INF2;
                const float p = ex2(x - (e ? lb : la));
                const float d = p * (dp[idx] - (e ? dl.y : dl.x));
                p2[e] = p;
                ds2[e] = d;
                if (h)
                  tb1 += d;
                else
                  tb0 += d;
              }
              pk[2 * jj + h] = pack_bf16(p2[0], p2[1]);
              dsk[2 * jj + h] = pack_bf16(ds2[0], ds2[1]);
            }
          }
          db0 += tb0;
          db1 += tb1;
          wgmma_fence();
          issue_rs<D>(dv, pk, do_s);  // dV += p^T dO
          issue_rs<D>(dk, dsk, q_s);  // dK += ds^T Q
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<D / 2>(dv);
          fence_regs<D / 2>(dk);
          fence_regs_u32<BQ / 4>(pk);
          fence_regs_u32<BQ / 4>(dsk);
        }
        mbar_arrive(empty(g));
      }
      g0 += n_qt - it.first0;

      if (keys) {
        db0 += __shfl_xor_sync(0xffffffffu, db0, 1);
        db1 += __shfl_xor_sync(0xffffffffu, db1, 1);
        db0 += __shfl_xor_sync(0xffffffffu, db0, 2);
        db1 += __shfl_xor_sync(0xffffffffu, db1, 2);
        if (dbias != nullptr && t == 0) {
          dbias[size_t(it.bh) * s_k + key0] = db0;
          dbias[size_t(it.bh) * s_k + key0 + 8] = db1;
        }
        // flush: dK and dV through the K and V tiles and TMA stores
        named_bar_sync(1 + w, 128);
        stage_tile<D>(k_s, dk, scale, warp, g_, t);
        stage_tile<D>(v_s, dv, 1.0f, warp, g_, t);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_bar_sync(1 + w, 128);
        if (threadIdx.x % 128 == 0) {
          const int row = it.bh * s_k + kw;
          tma_store_tile(&tdk, C::BOXES, row, k_s);
          tma_store_tile(&tdv, C::BOXES, row, v_s);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
      }
      if (threadIdx.x % 128 == 0) mbar_arrive(buf_empty(n));
    }
  }
}

// ================================================================ host ===

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *out, *g_lse;
  Bias bias;
  void *dq, *dk, *dv, *dbias;
  int bn, s_q, s_k;
  float scale;
  int causal;
  cudaStream_t stream;
};

// the bf16 head dims on the wgmma kernels (where the dq kernel forms delta)
constexpr bool wgmma_route(bool is_bf16, int d) {
  return is_bf16 && (d == 64 || d == 128);
}

template <typename KernelFn>
cudaError_t launch_cfg(KernelFn kernel, size_t smem, long long blocks) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  using L = DqL<T, D>;
  if (a.s_q % L::R != 0 || a.s_k % L::C != 0) return cudaErrorInvalidValue;
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
  if (a.s_k % L::R != 0 || a.s_q % L::C != 0) return cudaErrorInvalidValue;
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

// work items of 128 rows of the owned sequence, and one persistent CTA per
// SM over them (the shared memory admits one); 0 CTAs for no items
cudaError_t persistent_grid(long long items, int* grid) {
  *grid = 0;
  if (items == 0) return cudaSuccess;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess) *grid = int(items < sms ? items : sms);
  return err;
}

template <int D>
cudaError_t launch_dq_wgmma(const Args& a) {
  using C = BwdTile<D, false>;
  if (a.out == nullptr || a.delta == nullptr) return cudaErrorInvalidValue;
  const long long items =
      (long long)a.bn * ((a.s_q + C::CTA_ROWS - 1) / C::CTA_ROWS);
  int grid;
  cudaError_t err = persistent_grid(items, &grid);
  if (err != cudaSuccess || grid == 0) return err;
  const long long rq = (long long)a.bn * a.s_q, rk = (long long)a.bn * a.s_k;
  CUtensorMap tq, tk, tv, tdo, tout, tdq;
  if (!tensor_map(&tq, a.q, rq, D, WG_ROWS) ||
      !tensor_map(&tk, a.k, rk, D, WG_ROWS) ||
      !tensor_map(&tv, a.v, rk, D, WG_ROWS) ||
      !tensor_map(&tdo, a.dout, rq, D, WG_ROWS) ||
      !tensor_map(&tout, a.out, rq, D, WG_ROWS) ||
      !tensor_map(&tdq, a.dq, rq, D, WG_ROWS))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(C::SMEM));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma<D><<<grid, 384, C::SMEM, a.stream>>>(
      tq, tk, tv, tdo, tout, tdq, a.bias, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.g_lse),
      static_cast<float*>(const_cast<void*>(a.delta)), int(items), a.s_q,
      a.s_k, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const Args& a) {
  using C = BwdTile<D, true>;
  const long long items =
      (long long)a.bn * ((a.s_k + C::CTA_ROWS - 1) / C::CTA_ROWS);
  int grid;
  cudaError_t err = persistent_grid(items, &grid);
  if (err != cudaSuccess || grid == 0) return err;
  const long long rq = (long long)a.bn * a.s_q, rk = (long long)a.bn * a.s_k;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  if (!tensor_map(&tq, a.q, rq, D, WG_ROWS) ||
      !tensor_map(&tk, a.k, rk, D, WG_ROWS) ||
      !tensor_map(&tv, a.v, rk, D, WG_ROWS) ||
      !tensor_map(&tdo, a.dout, rq, D, WG_ROWS) ||
      !tensor_map(&tdk, a.dk, rk, D, WG_ROWS) ||
      !tensor_map(&tdv, a.dv, rk, D, WG_ROWS))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(C::SMEM));
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wgmma<D><<<grid, 384, C::SMEM, a.stream>>>(
      tq, tk, tv, tdo, tdk, tdv, a.bias, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(a.dbias),
      int(items), a.s_q, a.s_k, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool DQ, typename T, int D>
cudaError_t launch_route(const Args& a) {
  if constexpr (wgmma_route(std::is_same<T, bf16>::value, D))
    return DQ ? launch_dq_wgmma<D>(a) : launch_dkv_wgmma<D>(a);
  else
    return DQ ? launch_dq<T, D>(a) : launch_dkv<T, D>(a);
}

template <bool DQ, typename T>
cudaError_t launch_d(int d, const Args& a) {
  switch (d) {
    case 64:
      return launch_route<DQ, T, 64>(a);
    case 128:
      return launch_route<DQ, T, 128>(a);
    case 256:
      return launch_route<DQ, T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int launch(int is_bf16, int d, const Args& a) {
  if (a.s_q % 64 != 0 || a.s_k % 64 != 0 || a.bias.n_head < 1)
    return int(cudaErrorInvalidValue);
  return int(is_bf16 ? launch_d<DQ, bf16>(d, a) : launch_d<DQ, float>(d, a));
}

// a route's tiles: (q rows, keys) of the pairs the dq kernel walks, then the
// dkv kernel's; which 4: 1 where the dq kernel forms delta
template <typename T, int D>
int tiles(int which) {
  if constexpr (wgmma_route(std::is_same<T, bf16>::value, D)) {
    const int t[5] = {WG_ROWS, BwdTile<D, false>::WALK, BwdTile<D, true>::WALK,
                      WG_ROWS, 1};
    return t[which];
  } else {
    const int t[5] = {DqL<T, D>::R, DqL<T, D>::C, DkvL<T, D>::C,
                      DkvL<T, D>::R, 0};
    return t[which];
  }
}

template <typename T>
int tiles_d(int d, int which) {
  return d == 64 ? tiles<T, 64>(which) : d == 128 ? tiles<T, 128>(which)
                                                  : tiles<T, 256>(which);
}

}  // namespace

// q/k/v/dout/out: contiguous (bn, s, d) in f32 (is_bf16 == 0) or bf16, with
// bn = batch * n_head, 16-byte aligned; lse, g_lse: (bn, s_q) f32. bias:
// null, or the element (batch, head, key) at bias_sb * batch + bias_sh *
// head + bias_sk * key, in f32 (bias_f32 == 1) or the input dtype. dq (bn,
// s_q, d) in the input dtype. delta (bn, s_q) f32: where the route forms it
// (azoo_flash_attention_bwd_tiles(is_bf16, d, 4) == 1) the kernel writes
// rowsum(dout * out) - g_lse (g_lse may be null) there; elsewhere it reads
// it, and out and g_lse are not read. d in {64, 128, 256}; s_q and s_k
// multiples of 64. Launches on `stream`; does not synchronise.
extern "C" int azoo_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, const void* bias, const void* out,
    const void* g_lse, void* dq, int bn, int s_q, int s_k, int d,
    int is_bf16, float scale, int causal, int n_head, int bias_f32,
    long long bias_sb, long long bias_sh, long long bias_sk, void* stream) {
  const Args a{q, k, v, dout, lse, delta, out, g_lse,
               Bias{bias, bias_f32, n_head, bias_sb, bias_sh, bias_sk},
               dq, nullptr, nullptr, nullptr, bn, s_q, s_k, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return launch<true>(is_bf16, d, a);
}

// The same inputs, delta read (written by azoo_flash_attention_bwd_dq on
// the wgmma route, launched before on the same stream); dk, dv (bn, s_k, d)
// in the input dtype; dbias (bn, s_k) f32, or null when the bias needs no
// gradient.
extern "C" int azoo_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
    void* dbias, int bn, int s_q, int s_k, int d, int is_bf16, float scale,
    int causal, int n_head, int bias_f32, long long bias_sb,
    long long bias_sh, long long bias_sk, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, nullptr,
               Bias{bias, bias_f32, n_head, bias_sb, bias_sh, bias_sk},
               nullptr, dk, dv, dbias, bn, s_q, s_k, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return launch<false>(is_bf16, d, a);
}

// The tiles of the route (is_bf16, d), d in {64, 128, 256}, which the plain
// loops must walk too (a fully masked row's p is 1 on every key of a live
// pair): which 0/1 the dq kernel's (q rows, keys) per pair, 2/3 the dkv
// kernel's; 4 is 1 where the dq kernel forms delta. 0 for anything else.
extern "C" int azoo_flash_attention_bwd_tiles(int is_bf16, int d,
                                              int which) {
  if ((d != 64 && d != 128 && d != 256) || which < 0 || which > 4) return 0;
  return is_bf16 ? tiles_d<bf16>(d, which) : tiles_d<float>(d, which);
}
