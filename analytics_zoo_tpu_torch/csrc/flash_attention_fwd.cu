// Flash-attention forward for Hopper (sm_90a): tiled online-softmax
// attention with an optional additive key bias and bottom-right causal mask.
//
// Replaces the TPU kernel analytics_zoo_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_forward) and computes what it computes:
//   s   = (q k^T) * scale  (+ bias[key])  (causal: -1e30 where q_pos < k_pos,
//         q_pos offset by s_k - s_q)
//   m, l, acc: running max, denominator and f32 accumulator over key tiles
//   out = acc / max(l, 1e-30)   in the input dtype
//   lse = m + log(max(l, 1e-30)) in f32
// bf16 inputs: q k^T and p v take bf16 operands (p rounded to bf16) with f32
// accumulation; the softmax statistics stay f32. f32 inputs: plain f32 FMA,
// no TF32.
//
// Bound. The kernel must read q, k, v and the bias once and write out (and
// lse) once; it does 2*s_q*s_k*(d + dv) flops of matmul. At the BERT-base
// serving shape (batch 32, 12 heads, seq 512, d 64, bf16, one (batch, s_k)
// bf16 padding-bias row per batch) that is about 101 MB and 2.6e10 flop:
// ~30 us at 3.35 TB/s against ~26 us at 989 TF/s, so the H100 bounds it by
// bytes. The design keeps the s x s logits out of
// device memory (one CTA owns a 64-row q tile and loops over key tiles with
// the running statistics on chip), so device traffic is q/out once and k/v
// once per q tile, mostly served from L2.
//
// Design (first version: right and simple; TMA, wgmma and pipelining come
// later). 128 threads per CTA; warp w owns q rows [16w, 16w+16) of the tile:
// it computes their S rows with WMMA (mma.sync) bf16 16x16x16 tiles (scalar
// FMA for f32), keeps m and l in registers (two lanes per row), writes p to
// shared memory and accumulates p v into an f32 accumulator in shared memory.
// Key tiles are 64 wide (32 for f32 with head dim 256, to fit shared memory).
// Causal key tiles past the tile's last live key are never loaded. The bias
// is read through strides in its own dtype (the input dtype or f32) and
// widened to f32 in the tile load, so a (batch, 1, 1, s_k) padding mask
// reaches the kernel as it is, without a per-head or f32 copy.
//
// C interface (ctypes): azoo_flash_attention_fwd returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BQ = 64;  // q rows per CTA
constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr float NEG_INF = -1e30f;

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

template <typename T, int D>
struct Cfg {
  static constexpr int BK = (sizeof(T) == 4 && D > 128) ? 32 : 64;
  // 16 bytes of padding per row: rows stay 16-byte aligned for vector
  // copies and 32-byte aligned every 16 rows for WMMA, and bank conflicts drop
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = D + PAD;    // Q/K/V row stride (elements)
  static constexpr int SLD = BK + 4;    // S row stride (floats)
  static constexpr int PLD = BK + PAD;  // P row stride (elements)
  static constexpr int OLD = D + 4;     // accumulator row stride (floats)
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = align128(Q_OFF + size_t(BQ) * LD * sizeof(T));
  static constexpr size_t V_OFF = align128(K_OFF + size_t(BK) * LD * sizeof(T));
  static constexpr size_t S_OFF = align128(V_OFF + size_t(BK) * LD * sizeof(T));
  static constexpr size_t P_OFF = align128(S_OFF + size_t(BQ) * SLD * sizeof(float));
  static constexpr size_t O_OFF = align128(P_OFF + size_t(BQ) * PLD * sizeof(T));
  static constexpr size_t B_OFF = align128(O_OFF + size_t(BQ) * OLD * sizeof(float));
  static constexpr size_t SMEM = align128(B_OFF + size_t(BK) * sizeof(float));
};

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

// S[16 rows of warp w, BK] = Q K^T
template <typename T, int D>
__device__ __forceinline__ void warp_qk(const T* Qs, const T* Ks, float* Ss,
                                        int warp, int lane) {
  using C = Cfg<T, D>;
  if constexpr (std::is_same<T, bf16>::value) {
    for (int n = 0; n < C::BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + warp * 16 * C::LD + kk * 16, C::LD);
        wmma::load_matrix_sync(b, Ks + n * 16 * C::LD + kk * 16, C::LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * C::SLD + n * 16, acc, C::SLD,
                              wmma::mem_row_major);
    }
  } else {
    // lane owns key columns lane + 32 j for the warp's 16 rows
    constexpr int NC = C::BK / 32;
    float acc[16][NC];
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float kv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) kv[j] = Ks[(lane + 32 * j) * C::LD + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float qv = Qs[(warp * 16 + r) * C::LD + d];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(qv, kv[j], acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j)
        Ss[(warp * 16 + r) * C::SLD + lane + 32 * j] = acc[r][j];
  }
}

// O[16 rows of warp w, D] += P V
template <typename T, int D>
__device__ __forceinline__ void warp_pv(const T* Ps, const T* Vs, float* Os,
                                        int warp, int lane) {
  using C = Cfg<T, D>;
  if constexpr (std::is_same<T, bf16>::value) {
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o = Os + warp * 16 * C::OLD + n * 16;
      wmma::load_matrix_sync(acc, o, C::OLD, wmma::mem_row_major);
      for (int kk = 0; kk < C::BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + warp * 16 * C::PLD + kk * 16, C::PLD);
        wmma::load_matrix_sync(b, Vs + kk * 16 * C::LD + n * 16, C::LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(o, acc, C::OLD, wmma::mem_row_major);
    }
  } else {
    // lane owns value columns lane + 32 j, one row at a time
    constexpr int NC = D / 32;
    for (int r = 0; r < 16; ++r) {
      float* o = Os + (warp * 16 + r) * C::OLD;
      const T* p = Ps + (warp * 16 + r) * C::PLD;
      float acc[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = o[lane + 32 * j];
      for (int key = 0; key < C::BK; ++key) {
        const float pv = p[key];
#pragma unroll
        for (int j = 0; j < NC; ++j)
          acc[j] = fmaf(pv, Vs[key * C::LD + lane + 32 * j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) o[lane + 32 * j] = acc[j];
    }
  }
}

// grid: (bn * s_q / BQ); block: NTHREADS. q/out (bn, s_q, D), k/v (bn, s_k, D),
// lse (bn, s_q) f32; bh = batch * n_head + head.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const Bias bias,
                 T* __restrict__ out, float* __restrict__ lse, int s_q,
                 int s_k, float scale, int causal) {
  using C = Cfg<T, D>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + C::Q_OFF);
  T* Ks = reinterpret_cast<T*>(smem + C::K_OFF);
  T* Vs = reinterpret_cast<T*>(smem + C::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + C::S_OFF);
  T* Ps = reinterpret_cast<T*>(smem + C::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + C::O_OFF);
  float* Bs = reinterpret_cast<float*>(smem + C::B_OFF);

  const int nq = s_q / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kg = k + size_t(bh) * s_k * D;
  const T* vg = v + size_t(bh) * s_k * D;
  const bool has_bias = bias.ptr != nullptr;
  const long long bias_row = (bh / bias.n_head) * bias.sb +
                             (bh % bias.n_head) * bias.sh;

  load_tile<T, D, BQ, C::LD>(Qs, q + (size_t(bh) * s_q + q0) * D);
  for (int i = threadIdx.x; i < BQ * C::OLD; i += NTHREADS) Os[i] = 0.0f;
  __syncthreads();

  // lanes 2r and 2r+1 of warp w own row 16w + r, each half of its columns
  const int row = warp * 16 + lane / 2;
  const int half = lane & 1;
  const int off = s_k - s_q;  // bottom-right causal alignment
  const int q_pos = q0 + row + off;
  float m_i = NEG_INF, l_i = 0.0f;

  int n_kt = s_k / BK;
  if (causal) {
    // key tiles whose first key lies past the tile's last query are dead
    const int last = q0 + BQ - 1 + off;
    n_kt = last < 0 ? 0 : min(n_kt, last / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's K, V, P and bias are consumed
    load_tile<T, D, BK, C::LD>(Ks, kg + size_t(kt) * BK * D);
    load_tile<T, D, BK, C::LD>(Vs, vg + size_t(kt) * BK * D);
    if (has_bias)
      for (int i = threadIdx.x; i < BK; i += NTHREADS) {
        const long long at = bias_row + (long long)(kt * BK + i) * bias.sk;
        Bs[i] = bias.f32 ? static_cast<const float*>(bias.ptr)[at]
                         : to_float(static_cast<const T*>(bias.ptr)[at]);
      }
    __syncthreads();

    warp_qk<T, D>(Qs, Ks, Ss, warp, lane);
    __syncwarp();

    constexpr int CPL = BK / 2;
    const int c0 = half * CPL;
    const float* srow = Ss + row * C::SLD + c0;
    float s[CPL];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float x = srow[j] * scale;
      if (has_bias) x += Bs[c0 + j];
      if (causal && q_pos < kt * BK + c0 + j) x = NEG_INF;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float sum = 0.0f;
    T* prow = Ps + row * C::PLD + c0;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      prow[j] = from_float<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = alpha * l_i + sum;
    m_i = m_new;
    float* orow = Os + row * C::OLD + half * (D / 2);
    for (int j = 0; j < D / 2; ++j) orow[j] *= alpha;
    __syncwarp();

    warp_pv<T, D>(Ps, Vs, Os, warp, lane);
    __syncwarp();
  }

  const float l_c = fmaxf(l_i, 1e-30f);
  const float* orow = Os + row * C::OLD + half * (D / 2);
  T* og = out + (size_t(bh) * s_q + q0 + row) * D + half * (D / 2);
  for (int j = 0; j < D / 2; ++j) og[j] = from_float<T>(orow[j] / l_c);
  if (half == 0) lse[size_t(bh) * s_q + q0 + row] = m_i + logf(l_c);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const Bias& bias, void* out, void* lse, int bn, int s_q,
                   int s_k, float scale, int causal, cudaStream_t stream) {
  using C = Cfg<T, D>;
  if (s_q % BQ != 0 || s_k % C::BK != 0 || bias.n_head < 1)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(C::SMEM));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)bn * (s_q / BQ);
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, D><<<unsigned(blocks), NTHREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias,
      static_cast<T*>(out), static_cast<float*>(lse), s_q, s_k, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     const Bias& bias, void* out, void* lse, int bn, int s_q,
                     int s_k, float scale, int causal, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, bias, out, lse, bn, s_q, s_k, scale,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, bias, out, lse, bn, s_q, s_k, scale,
                            causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, bias, out, lse, bn, s_q, s_k, scale,
                            causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/out: contiguous (bn, s, d) in f32 (is_bf16 == 0) or bf16, with
// bn = batch * n_head; lse: (bn, s_q) f32. bias: null, or the element
// (batch, head, key) at bias_sb * batch + bias_sh * head + bias_sk * key, in
// f32 (bias_f32 == 1) or the input dtype. d in {64, 128, 256}; s_q and s_k
// multiples of 64. Launches on `stream`; does not synchronise.
extern "C" int azoo_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* lse, int bn, int s_q, int s_k, int d, int is_bf16, float scale,
    int causal, int n_head, int bias_f32, long long bias_sb,
    long long bias_sh, long long bias_sk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bias b{bias, bias_f32, n_head, bias_sb, bias_sh, bias_sk};
  const cudaError_t err =
      is_bf16 ? launch_d<bf16>(d, q, k, v, b, out, lse, bn, s_q, s_k, scale,
                               causal, st)
              : launch_d<float>(d, q, k, v, b, out, lse, bn, s_q, s_k, scale,
                                causal, st);
  return int(err);
}
