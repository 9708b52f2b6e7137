// Flash-attention forward for Hopper (sm_90a): tiled online-softmax
// attention with an optional additive key bias and bottom-right causal mask.
//
// Replaces the TPU kernel analytics_zoo_tpu/ops/flash_attention.py:_fwd_kernel
// (:156, launched by _flash_forward) and computes what it computes:
//   s   = (q k^T) * scale  (+ bias[key])  (causal: -1e30 where q_pos < k_pos,
//         q_pos offset by s_k - s_q)
//   m, l, acc: running max, denominator and f32 accumulator over key tiles
//   out = acc / max(l, 1e-30)   in the input dtype
//   lse = m + log(max(l, 1e-30)) in f32, natural-log units (the backward
//         kernels re-form p = exp(s - lse) from it)
// bf16 inputs: q k^T and p v take bf16 operands (p rounded to bf16) with f32
// accumulation; the softmax statistics stay f32. f32 inputs: plain f32 FMA,
// no TF32 (wgmma has no full-f32 mode), in the scalar kernel at the end.
//
// Bound. The kernel must read q, k, v and the bias once and write out and
// lse once; it does 2 * s_q * s_k * (d + dv) flops of matmul. At the
// BERT-base serving shape (batch 32, 12 heads, seq 512, d 64, bf16, one
// (batch, 1, 1, s_k) bf16 padding-bias row per batch) that is 100.7 MB and
// 2.6e10 flop: 0.030 ms at 3.35 TB/s against 0.026 ms at 989 TF/s. At the
// training shape (64, 12, 128, 64) it is 50.3 MB and 3.2e9 flop: 0.015 ms
// against 0.0033 ms. The H100 bounds both by bytes.
//
// bf16 design (FlashAttention-3's forward, arXiv 2407.08608), per CTA of
// 384 threads; a work item is 128 q rows of one (batch, head):
// - Persistent: one CTA per SM walks the work items blockIdx.x, + gridDim.x,
//   ... The rings below run on from one item to the next, and at head dims
//   64 and 128 (where out has staging tiles of its own) the next item's Q
//   loads as soon as the last S product has read this one's, so the next
//   item's loads overlap this one's last tile and epilogue.
// - Warp specialisation. Warpgroup 0 produces: one thread issues every TMA
//   load (cp.async.bulk.tensor) and one warp stages the key tile's bias as
//   f32 in shared memory. Warpgroups 1 and 2 consume, 64 q rows each.
//   setmaxnreg gives the producer 24 registers and each consumer 240.
// - Q is loaded once per warpgroup by TMA. K and V tiles of BK keys sit in
//   two rings of STAGES stages filled by TMA; each stage of each ring has a
//   "full" mbarrier (the TMA bytes, and for K the bias warp's 32 arrivals)
//   and an "empty" one (the 256 consumer threads' arrivals), with the phase
//   parity tracked per round. K and V are released separately, since a
//   tile's K is done before its V. Copies of later tiles overlap the
//   products on earlier ones; the old kernel copied K and V synchronously
//   through registers between two __syncthreads.
// - Tiles are TMA boxes of 64 columns (128 bytes) with 128-byte swizzle;
//   head dims 128 and 256 are two or four boxes side by side, as CUTLASS
//   splits them. q/k/v/out are viewed as 2-D (bn * s, d): s is a multiple
//   of 64, so a 64-row box never straddles two heads.
// - S = Q K^T is wgmma m64nBKk16 with both operands in shared memory
//   (K-major), accumulating f32 in registers. The old kernel's WMMA
//   (mma.sync 16x16x16, half of Hopper's tensor-core rate) hid its
//   register layout and sent S and P through shared memory.
// - The softmax works on the accumulator layout: a thread holds rows
//   16 * warp + lane / 4 and + 8, columns 8 j + 2 (lane % 4) + {0, 1}, so a
//   row's max takes two shfl.xor steps; m and l stay in registers, and the
//   O accumulator is rescaled in registers (the old kernel walked it
//   through shared memory). Logits are formed in log2 units, scale * log2(e)
//   and the bias (scaled as it is staged) in one FFMA, and p is ex2.approx
//   of x - m; lse goes back to natural-log units. Only tiles that hold a
//   masked key (ragged or on the causal diagonal) run the masking code.
// - O += P V is wgmma with A = P from registers (rounded to bf16 there,
//   where _flash_forward_plain rounds it; the accumulator layout packs
//   straight into wgmma's A fragments) and B = V from shared memory,
//   MN-major (the transpose flag).
// - Within a warpgroup, tile j's S product and tile j - 1's P V product are
//   issued together, and tile j's softmax runs while P V is on the tensor
//   cores (wgmma.wait_group 1); the rescale of O waits for P V. The two
//   consumer warpgroups interleave on their own besides.
// - Causal key tiles past a warpgroup's last live query are never computed,
//   and past the work item's last live query never loaded; tiles on the
//   diagonal are masked in registers. Each warpgroup walks exactly its own
//   64 rows' tiles (as the plain version does per 64-row block), and waits
//   on and releases the stages it skips. A ragged last key tile (s_k a
//   multiple of 64 but not of BK) is masked to -inf, not left to TMA's zero
//   fill (a zero logit is not masked). Where s_q is an odd number of 64-row
//   tiles, the second warpgroup of a head's last work item has no rows: it
//   still takes part in every barrier and writes nothing.
// - The bias is read through its (batch, head, key) strides in its own dtype
//   (bf16 or f32), so a (batch, 1, 1, s_k) padding mask needs no per-head or
//   f32 copy.
// - Epilogue: out = acc / max(l, 1e-30) in bf16 goes through shared memory
//   (the warpgroup's staging tile, or its Q tile at head dim 256) and a TMA
//   store; lse from registers.
// At head dim 64 (BERT's) the key tile (128), the ring stages (3) and the
// producer's registers (24) were chosen by timing variants on the card
// (PERF.md); at 128 and 256 they are set by registers and shared memory,
// not measured.
//
// f32 design (the golden path, not the main one): 128 threads per CTA own a
// 64-row q tile; scalar FMA products through shared memory; the running
// statistics in registers (two lanes per row).
//
// C interface (ctypes): azoo_flash_attention_fwd returns a cudaError_t; the
// TMA descriptors are encoded in it, with cuTensorMapEncodeTiled taken from
// the driver through cudaGetDriverEntryPoint (no -lcuda).

#include <cuda.h>  // CUtensorMap and the encoder's types (no driver calls)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// the mask value in log2 units: a row whose every logit so far is masked
// has exactly this running max, and p = 2^0 = 1, as exp(-1e30 - -1e30)
// gives in natural units
constexpr float NEG_INF2 = NEG_INF * LOG2E;

// The additive key bias: element (batch, head, key) at
// row(bh) + key * sk, in the input dtype or (f32 == 1) in f32; null for no
// bias.
struct Bias {
  const void* ptr;
  int f32;
  int n_head;
  long long sb, sh, sk;  // element strides of batch, head and key
};

__device__ __forceinline__ long long bias_row(const Bias& b, int bh) {
  return (bh / b.n_head) * b.sb + (bh % b.n_head) * b.sh;
}

// ===================================================== bf16: wgmma + TMA ===

constexpr int WG_ROWS = 64;    // q rows per consumer warpgroup
constexpr int BOX_COLS = 64;   // bf16 columns per TMA box (128 bytes)

template <int D>
struct Tile {
  // key tile and ring stages (the plain version walks the same key tiles:
  // azoo_flash_attention_fwd_bf16_block_k reports BK)
  static constexpr int BK = D == 256 ? 64 : 128;
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int CTA_ROWS = 2 * WG_ROWS;  // two consumer warpgroups
  // registers: 384 threads start with 168 each (the SM's 65536 over 384,
  // a multiple of 8); the producer warpgroup gives up all but
  // PRODUCER_REGS and each consumer thread takes an equal part of the rest
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS =
      (168 * 384 - PRODUCER_REGS * 128) / 256 / 8 * 8 > 240
          ? 240
          : (168 * 384 - PRODUCER_REGS * 128) / 256 / 8 * 8;
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr uint32_t Q_BYTES = WG_ROWS * D * 2;  // one warpgroup's Q
  static constexpr uint32_t KV_BYTES = BK * D * 2;      // one K or V tile
  // out is staged in its own tiles where shared memory allows, so the next
  // work item's Q loads under the epilogue; at head dim 256 in the Q tiles
  static constexpr bool OWN_O = D <= 128;
  // every tile offset is a multiple of 1024 bytes, the swizzle atom
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t O_OFF = OWN_O ? 2 * Q_BYTES : Q_OFF;
  static constexpr uint32_t K_OFF = (OWN_O ? 4 : 2) * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t B_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = B_OFF + STAGES * BK * 4;
  // barriers: Q full and empty, and full and empty for K and for V per
  // stage; 1024 bytes of slack to align the dynamic shared memory's base
  // to the swizzle atom
  static constexpr uint32_t SMEM = BAR_OFF + (2 + 4 * STAGES) * 8 + 1024;
  static_assert(BK % 64 == 0 && BK <= 256, "key tile: 64 to 256 keys");
  static_assert(SMEM <= 232448, "bf16 forward tile exceeds shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed; a wait
// of some 2^36 cycles (tens of seconds) can only be a broken protocol, and
// traps, so that the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 36)) __trap();
  }
}

// one 2-D box (column c0, row c1) of a tensor map into shared memory,
// completing its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0,
                                          int c1, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed product groups run
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins an accumulator's registers in place around asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs_u32(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A thread's place in a warpgroup's m64nN f32 accumulator d[N / 2]: warp w
// of the warpgroup owns rows 16 w .. 16 w + 15; lane holds, for each 8-column
// chunk j, d[4j] and d[4j + 1] at row 16 w + lane / 4, columns
// 8 j + 2 (lane % 4) + {0, 1}, and d[4j + 2], d[4j + 3] at the row 8 below.
// wgmma.mma_async m64nNk16, bf16 in, f32 accumulators d[N / 2] per thread
// (see the accumulator mapping above). The "+f" operands keep the compiler
// from moving reads or writes of d across the asynchronous product; the
// caller fences (wgmma_fence) before and waits (wgmma_wait) after.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db);
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);
template <int N>
__device__ __forceinline__ void wgmma_ss_first(float* d, uint64_t da,
                                               uint64_t db);

// d[64 x 64] += A[64 x 16] B[16 x 64]: A and B K-major in shared memory
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A and B K-major in shared memory
template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B MN-major in
// shared memory (the transpose flag set)
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A in registers, B MN-major in
// shared memory (the transpose flag set)
template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d[64 x 256] += A[64 x 16] B[16 x 256]: A in registers, B MN-major in
// shared memory (the transpose flag set)
template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d[64 x 64] = A[64 x 16] B[16 x 64], the first step of a product: d is
// written, not read, so its registers need not hold a value before it
template <>
__device__ __forceinline__ void wgmma_ss_first<64>(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0)
      : "memory");
}

// d[64 x 128] = A[64 x 16] B[16 x 128], the first step of a product: d is
// written, not read, so its registers need not hold a value before it
template <>
__device__ __forceinline__ void wgmma_ss_first<128>(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0)
      : "memory");
}

// key tiles a 64-row block from q row r0 needs: all of them, or (causal)
// those up to the block's last live key
__device__ __forceinline__ int live_tiles(int r0, int s_q, int s_k, int bk,
                                          int n_kt, int causal) {
  if (r0 >= s_q) return 0;
  if (!causal) return n_kt;
  const int last = r0 + WG_ROWS - 1 + (s_k - s_q);
  return last < 0 ? 0 : min(n_kt, last / bk + 1);
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// The online softmax of one key tile on the accumulator layout, in log2
// units: x = S * scale * log2(e) + bias * log2(e) (the bias row at `bias`
// in shared memory, already scaled). s holds S and becomes p = 2^(x - m) in
// f32; m and l are the running max and this thread's partial row sums of
// its two rows, whose causal positions are qpos0 and qpos0 + 8; a0/a1
// receive the factors that rescale the rows' accumulators. MASK: the tile
// holds keys past s_k (-inf: not keys) or past a row's causal position
// (-1e30, as the plain version masks them).
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float& m0, float& m1, float& l0, float& l1,
    float& a0, float& a1, uint32_t bias, float scale2, int k0, int s_k,
    int causal, int qpos0, int t) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float2 bv = lds_f2(bias + (8 * j + 2 * t) * 4);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x0 = fmaf(s[4 * j + e], scale2, e ? bv.y : bv.x);
      float x1 = fmaf(s[4 * j + 2 + e], scale2, e ? bv.y : bv.x);
      if (MASK) {
        const int key = k0 + 8 * j + 2 * t + e;
        const bool cut0 = causal && qpos0 < key;
        const bool cut1 = causal && qpos0 + 8 < key;
        x0 = key >= s_k ? -INFINITY : cut0 ? NEG_INF2 : x0;
        x1 = key >= s_k ? -INFINITY : cut1 ? NEG_INF2 : x1;
      }
      s[4 * j + e] = x0;
      s[4 * j + 2 + e] = x1;
      mx0 = fmaxf(mx0, x0);
      mx1 = fmaxf(mx1, x1);
    }
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh *= 2) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  a0 = ex2(m0 - mn0);
  a1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p0 = ex2(s[4 * j + e] - mn0);
      const float p1 = ex2(s[4 * j + 2 + e] - mn1);
      s[4 * j + e] = p0;
      s[4 * j + 2 + e] = p1;
      ps0 += p0;
      ps1 += p1;
    }
  l0 = a0 * l0 + ps0;  // per-thread partial sums, reduced at the end
  l1 = a1 * l1 + ps1;
}

// grid: up to one CTA per SM, each walking work items (bh, 128-row q block)
// blockIdx.x, + gridDim.x, ...; block: 384. tq/tk/tv/to map q/k/v/out as
// (bn * s, D) bf16 in boxes of 64 columns (rows: 64 for q/out, BK for k/v);
// lse (bn, s_q) f32; bh = batch * n_head + head.
template <int D>
__global__ void __launch_bounds__(384, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to, const Bias bias,
                float* __restrict__ lse, int n_items, int s_q, int s_k,
                float scale, int causal) {
  using C = Tile<D>;
  constexpr int BK = C::BK, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  float* bias_s = reinterpret_cast<float*>(smem + C::B_OFF);
  // barriers: Q full and empty, then per stage "full" and "empty" for K
  // (with its bias row) and for V. Tiles are counted over the CTA's whole
  // run (g), so the rings run on from one work item to the next.
  const uint32_t q_full = base + C::BAR_OFF, q_empty = q_full + 8;
  auto full_k = [&](int g) { return q_full + 8 * (2 + g % ST); };
  auto full_v = [&](int g) { return q_full + 8 * (2 + ST + g % ST); };
  auto empty_k = [&](int g) { return q_full + 8 * (2 + 2 * ST + g % ST); };
  auto empty_v = [&](int g) { return q_full + 8 * (2 + 3 * ST + g % ST); };
  // the parity a consumer waits on for tile g's data; a producer waits on
  // the other one for the release of the stage's previous round
  auto round = [&](int g) { return uint32_t(g / ST) & 1; };

  const int nq = (s_q + C::CTA_ROWS - 1) / C::CTA_ROWS;
  const int n_kt = (s_k + BK - 1) / BK;
  // a work item's head, first q row and key tiles per warpgroup
  struct Item {
    int bh, q0, live0, live1, n_cta;
  };
  auto item_at = [&](int i) {
    Item it;
    it.bh = i / nq;
    it.q0 = (i % nq) * C::CTA_ROWS;
    it.live0 = live_tiles(it.q0, s_q, s_k, BK, n_kt, causal);
    it.live1 = live_tiles(it.q0 + WG_ROWS, s_q, s_k, BK, n_kt, causal);
    it.n_cta = max(it.live0, it.live1);  // key tiles the CTA loads
    return it;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);  // every consumer thread
    for (int j = 0; j < ST; ++j) {
      mbar_init(full_k(j), 1 + 32);  // the TMA thread + the bias warp
      mbar_init(full_v(j), 1);
      mbar_init(empty_k(j), 256);
      mbar_init(empty_v(j), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, warp-uniform as the compiler sees it (a shuffle
  // from lane 0)
  const int role = __shfl_sync(0xffffffffu, int(threadIdx.x / 128), 0);
  if (role == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS)
                 : "memory");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    int g = 0, n = 0;  // tiles and work items so far
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
      const Item it = item_at(i);
      if (warp == 0 && lane == 0) {
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        const int n_wg = min(2, (s_q - it.q0) / WG_ROWS);
        mbar_expect_tx(q_full, n_wg * C::Q_BYTES);
        for (int w = 0; w < n_wg; ++w)
          for (int b = 0; b < C::BOXES; ++b)
            tma_load(base + C::Q_OFF + w * C::Q_BYTES + b * WG_ROWS * 128,
                     &tq, b * BOX_COLS, it.bh * s_q + it.q0 + w * WG_ROWS,
                     q_full);
        for (int j = 0; j < it.n_cta; ++j, ++g) {
          const uint32_t stage = (g % ST) * C::KV_BYTES;
          const int row = it.bh * s_k + j * BK;
          if (g >= ST) mbar_wait(empty_k(g), round(g) ^ 1);
          mbar_expect_tx(full_k(g), C::KV_BYTES);
          for (int b = 0; b < C::BOXES; ++b)
            tma_load(base + C::K_OFF + stage + b * BK * 128, &tk,
                     b * BOX_COLS, row, full_k(g));
          if (g >= ST) mbar_wait(empty_v(g), round(g) ^ 1);
          mbar_expect_tx(full_v(g), C::KV_BYTES);
          for (int b = 0; b < C::BOXES; ++b)
            tma_load(base + C::V_OFF + stage + b * BK * 128, &tv,
                     b * BOX_COLS, row, full_v(g));
        }
      } else if (warp == 1) {
        const long long brow = bias_row(bias, it.bh);
        for (int j = 0; j < it.n_cta; ++j, ++g) {
          if (g >= ST) mbar_wait(empty_k(g), round(g) ^ 1);
          for (int k = lane; k < BK; k += 32) {
            const int key = j * BK + k;
            float x = 0.0f;  // keys past s_k are masked by the consumers
            if (bias.ptr != nullptr && key < s_k) {
              const long long at = brow + key * bias.sk;
              x = bias.f32 ? static_cast<const float*>(bias.ptr)[at]
                           : __bfloat162float(
                                 static_cast<const bf16*>(bias.ptr)[at]);
            }
            bias_s[(g % ST) * BK + k] = x * LOG2E;  // in log2 units
          }
          mbar_arrive(full_k(g));
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
    const int off = s_k - s_q;
    const float scale2 = scale * LOG2E;
    const uint32_t q_smem = base + C::Q_OFF + w * C::Q_BYTES;
    const uint32_t o_smem = base + C::O_OFF + w * C::Q_BYTES;

    float o[D / 2], s[BK / 2];
    uint32_t p[BK / 4];
    float m0, m1, l0, l1, a0, a1;

    // S = Q K^T of tile g, issued: D / 16 steps of 16 columns, 32 bytes
    // into a box each
    auto issue_s = [&](int g) {
      const uint32_t k_smem = base + C::K_OFF + (g % ST) * C::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = kk / 4, in_box = (kk % 4) * 32;
        const uint64_t da =
            smem_desc(q_smem + box * WG_ROWS * 128 + in_box, 16, 1024);
        const uint64_t db =
            smem_desc(k_smem + box * BK * 128 + in_box, 16, 1024);
        if (kk == 0)
          wgmma_ss_first<BK>(s, da, db);
        else
          wgmma_ss<BK>(s, da, db);
      }
      wgmma_commit();
    };
    // O += P V of tile g, issued: BK / 16 steps of 16 keys (16 rows of 128
    // bytes)
    auto issue_pv = [&](int g) {
      const uint32_t v_smem = base + C::V_OFF + (g % ST) * C::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(o, p + 4 * kk,
                    smem_desc(v_smem + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit();
    };
    // P in bf16 as wgmma's A fragments: for 16 keys kk, rows g / g + 8 of
    // columns 16 kk + 2t and 16 kk + 8 + 2t
    auto pack_p = [&]() {
#pragma unroll
      for (int i = 0; i < BK / 4; ++i)
        p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };

    int g0 = 0, n = 0;  // the work item's first tile; work items so far
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
      const Item it = item_at(i);
      const int wg_row = it.q0 + w * WG_ROWS;  // the warpgroup's first row
      const int r0 = wg_row + warp * 16 + g_;  // this thread's rows: r0, +8
      const int live = w == 0 ? it.live0 : it.live1;
      // tile j's softmax (stage of tile g0 + j)
      auto softmax = [&](int j) {
        const int k0 = j * BK;
        const uint32_t brow = base + C::B_OFF + ((g0 + j) % ST) * BK * 4;
        if (k0 + BK > s_k || (causal && k0 + BK - 1 > wg_row + off))
          softmax_tile<BK, true>(s, m0, m1, l0, l1, a0, a1, brow, scale2,
                                 k0, s_k, causal, r0 + off, t);
        else
          softmax_tile<BK, false>(s, m0, m1, l0, l1, a0, a1, brow, scale2,
                                  k0, s_k, causal, r0 + off, t);
      };
#pragma unroll
      for (int k = 0; k < D / 2; ++k) o[k] = 0.0f;
      m0 = m1 = NEG_INF2;
      l0 = l1 = 0.0f;

      // every consumer thread sees each Q load complete before it releases
      // it, so no warpgroup runs a round ahead of the other
      mbar_wait(q_full, n & 1);
      if (live > 0) {
        mbar_wait(full_k(g0), round(g0));
        issue_s(g0);
        wgmma_wait<0>();
        fence_regs<BK / 2>(s);
        if (C::OWN_O && live == 1) mbar_arrive(q_empty);  // last use of Q
        softmax(0);  // o is still zero: nothing to rescale
        mbar_arrive(empty_k(g0));
        pack_p();
        // tile j's softmax runs while the tensor cores do tile j - 1's P V
        for (int j = 1; j < live; ++j) {
          const int g = g0 + j;
          mbar_wait(full_k(g), round(g));
          issue_s(g);
          mbar_wait(full_v(g - 1), round(g - 1));
          issue_pv(g - 1);
          wgmma_wait<1>();  // S of tile j is done; P V of j - 1 may run on
          fence_regs<BK / 2>(s);
          if (C::OWN_O && j == live - 1) mbar_arrive(q_empty);
          softmax(j);
          mbar_arrive(empty_k(g));
          wgmma_wait<0>();
          fence_regs<D / 2>(o);
          fence_regs_u32<BK / 4>(p);
          mbar_arrive(empty_v(g - 1));
#pragma unroll
          for (int k = 0; k < D / 8; ++k) {
            o[4 * k] *= a0;
            o[4 * k + 1] *= a0;
            o[4 * k + 2] *= a1;
            o[4 * k + 3] *= a1;
          }
          pack_p();
        }
        const int g = g0 + live - 1;
        mbar_wait(full_v(g), round(g));
        issue_pv(g);
        wgmma_wait<0>();
        fence_regs<D / 2>(o);
        mbar_arrive(empty_v(g));
      } else if (C::OWN_O) {
        mbar_arrive(q_empty);
      }
      for (int j = live; j < it.n_cta; ++j) {  // tiles this warpgroup skips
        const int g = g0 + j;
        mbar_wait(full_k(g), round(g));
        mbar_arrive(empty_k(g));
        mbar_wait(full_v(g), round(g));
        mbar_arrive(empty_v(g));
      }
      g0 += it.n_cta;

      if (wg_row < s_q) {
        // epilogue: out through shared memory (swizzled as TMA expects)
        // and a TMA store; lse from the quad's first lane. The barrier
        // orders this item's staging after the last item's store read it.
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
#pragma unroll
        for (int sh = 1; sh <= 2; sh *= 2) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
          l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
        }
        const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
#pragma unroll
        for (int k = 0; k < D / 8; ++k) {
          const uint32_t box = o_smem + (k / 8) * WG_ROWS * 128;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = warp * 16 + g_ + 8 * h;
            const float lc = h ? lc1 : lc0;
            const uint32_t addr =
                box + row * 128 + (((k % 8) ^ g_) << 4) + t * 4;
            const uint32_t val = pack_bf16(o[4 * k + 2 * h] / lc,
                                           o[4 * k + 2 * h + 1] / lc);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(val)
                         : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
        if (threadIdx.x % 128 == 0) {
          for (int b = 0; b < C::BOXES; ++b)
            tma_store(&to, b * BOX_COLS, it.bh * s_q + wg_row,
                      o_smem + b * WG_ROWS * 128);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        if (t == 0) {  // natural-log units; a fully masked row's max is -1e30
          float* lrow = lse + size_t(it.bh) * s_q + r0;
          lrow[0] = (m0 == NEG_INF2 ? NEG_INF : m0 * LN2) + logf(lc0);
          lrow[8] = (m1 == NEG_INF2 ? NEG_INF : m1 * LN2) + logf(lc1);
        }
        // out staged in the Q tile: release Q once the store has read it
        if (!C::OWN_O)
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
      }
      if (!C::OWN_O) mbar_arrive(q_empty);
    }
  }
}

// ===================================================== f32: scalar FMA ===

constexpr int F32_BQ = 64;  // q rows per CTA
constexpr int F32_THREADS = 128;

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

template <int D>
struct F32Cfg {
  static constexpr int BK = D > 128 ? 32 : 64;
  static constexpr int LD = D + 4;    // Q/K/V row stride (floats)
  static constexpr int SLD = BK + 4;  // S/P row stride
  static constexpr int OLD = D + 4;   // accumulator row stride
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = align128(Q_OFF + size_t(F32_BQ) * LD * 4);
  static constexpr size_t V_OFF = align128(K_OFF + size_t(BK) * LD * 4);
  static constexpr size_t S_OFF = align128(V_OFF + size_t(BK) * LD * 4);
  static constexpr size_t O_OFF = align128(S_OFF + size_t(F32_BQ) * SLD * 4);
  static constexpr size_t B_OFF = align128(O_OFF + size_t(F32_BQ) * OLD * 4);
  static constexpr size_t SMEM = align128(B_OFF + size_t(BK) * 4);
  static_assert(SMEM <= 232448, "f32 forward tile exceeds shared memory");
};

// ROWS x D tile from a contiguous (rows, D) global array into shared memory
// with row stride LD, 16 bytes per thread per step.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += F32_THREADS) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<float4*>(dst + r * LD + c * 4) =
        *reinterpret_cast<const float4*>(src + size_t(r) * D + c * 4);
  }
}

// grid: (bn * s_q / 64); block: 128. q/out (bn, s_q, D), k/v (bn, s_k, D),
// lse (bn, s_q). Warp w owns q rows [16w, 16w + 16) of the tile.
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const Bias bias,
              float* __restrict__ out, float* __restrict__ lse, int s_q,
              int s_k, float scale, int causal) {
  using C = F32Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + C::Q_OFF);
  float* Ks = reinterpret_cast<float*>(smem + C::K_OFF);
  float* Vs = reinterpret_cast<float*>(smem + C::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + C::S_OFF);
  float* Os = reinterpret_cast<float*>(smem + C::O_OFF);
  float* Bs = reinterpret_cast<float*>(smem + C::B_OFF);

  const int nq = s_q / F32_BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * F32_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* kg = k + size_t(bh) * s_k * D;
  const float* vg = v + size_t(bh) * s_k * D;
  const bool has_bias = bias.ptr != nullptr;
  const long long brow = bias_row(bias, bh);

  load_tile<D, F32_BQ, C::LD>(Qs, q + (size_t(bh) * s_q + q0) * D);
  for (int i = threadIdx.x; i < F32_BQ * C::OLD; i += F32_THREADS)
    Os[i] = 0.0f;
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
    const int last = q0 + F32_BQ - 1 + off;
    n_kt = last < 0 ? 0 : min(n_kt, last / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's K, V, P and bias are consumed
    load_tile<D, BK, C::LD>(Ks, kg + size_t(kt) * BK * D);
    load_tile<D, BK, C::LD>(Vs, vg + size_t(kt) * BK * D);
    if (has_bias)
      for (int i = threadIdx.x; i < BK; i += F32_THREADS) {
        const long long at = brow + (long long)(kt * BK + i) * bias.sk;
        Bs[i] = static_cast<const float*>(bias.ptr)[at];
      }
    __syncthreads();

    {  // S[16 rows of warp w, BK] = Q K^T; lane owns columns lane + 32 j
      constexpr int NC = BK / 32;
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
    __syncwarp();

    constexpr int CPL = BK / 2;
    const int c0 = half * CPL;
    float* srow = Ss + row * C::SLD + c0;
    float sv[CPL];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float x = srow[j] * scale;
      if (has_bias) x += Bs[c0 + j];
      if (causal && q_pos < kt * BK + c0 + j) x = NEG_INF;
      sv[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float p = expf(sv[j] - m_new);
      sum += p;
      srow[j] = p;  // P over S, in place: the row is this lane pair's alone
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = alpha * l_i + sum;
    m_i = m_new;
    float* orow = Os + row * C::OLD + half * (D / 2);
    for (int j = 0; j < D / 2; ++j) orow[j] *= alpha;
    __syncwarp();

    {  // O[16 rows of warp w, D] += P V; lane owns columns lane + 32 j
      constexpr int NC = D / 32;
      for (int r = 0; r < 16; ++r) {
        float* o = Os + (warp * 16 + r) * C::OLD;
        const float* p = Ss + (warp * 16 + r) * C::SLD;
        float acc[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] = o[lane + 32 * j];
        for (int key = 0; key < BK; ++key) {
          const float pv = p[key];
#pragma unroll
          for (int j = 0; j < NC; ++j)
            acc[j] = fmaf(pv, Vs[key * C::LD + lane + 32 * j], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) o[lane + 32 * j] = acc[j];
      }
    }
    __syncwarp();
  }

  const float l_c = fmaxf(l_i, 1e-30f);
  const float* orow = Os + row * C::OLD + half * (D / 2);
  float* og = out + (size_t(bh) * s_q + q0 + row) * D + half * (D / 2);
  for (int j = 0; j < D / 2; ++j) og[j] = orow[j] / l_c;
  if (half == 0) lse[size_t(bh) * s_q + q0 + row] = m_i + logf(l_c);
}

// ================================================================ host ===

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;  // the same value from every thread
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, d) bf16 at ptr, read in boxes of 64 columns x box_rows rows with
// 128-byte swizzle
bool tensor_map(CUtensorMap* map, const void* ptr, long long rows, int d,
                int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(d), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(d) * 2};
  const cuuint32_t box[2] = {cuuint32_t(BOX_COLS), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const Bias& bias, void* out, void* lse, int bn,
                        int s_q, int s_k, float scale, int causal,
                        cudaStream_t stream) {
  using C = Tile<D>;
  const long long items =
      (long long)bn * ((s_q + C::CTA_ROWS - 1) / C::CTA_ROWS);
  if (items == 0) return cudaSuccess;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(&tq, q, (long long)bn * s_q, D, WG_ROWS) ||
      !tensor_map(&tk, k, (long long)bn * s_k, D, C::BK) ||
      !tensor_map(&tv, v, (long long)bn * s_k, D, C::BK) ||
      !tensor_map(&to, out, (long long)bn * s_q, D, WG_ROWS))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(C::SMEM));
  if (err != cudaSuccess) return err;
  // one persistent CTA per SM (the shared memory admits one)
  const int grid = int(items < sms ? items : sms);
  flash_fwd_wgmma<D><<<grid, 384, C::SMEM, stream>>>(
      tq, tk, tv, to, bias, static_cast<float*>(lse), int(items), s_q, s_k,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const Bias& bias, void* out, void* lse, int bn,
                       int s_q, int s_k, float scale, int causal,
                       cudaStream_t stream) {
  using C = F32Cfg<D>;
  if (s_k % C::BK != 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(C::SMEM));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)bn * (s_q / F32_BQ);
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_f32<D><<<unsigned(blocks), F32_THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(out),
      static_cast<float*>(lse), s_q, s_k, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int is_bf16, const void* q, const void* k, const void* v,
                   const Bias& bias, void* out, void* lse, int bn, int s_q,
                   int s_k, float scale, int causal, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(q, k, v, bias, out, lse, bn, s_q, s_k,
                                  scale, causal, stream)
                 : launch_f32<D>(q, k, v, bias, out, lse, bn, s_q, s_k,
                                 scale, causal, stream);
}

}  // namespace

// q/k/v/out: contiguous (bn, s, d) in f32 (is_bf16 == 0) or bf16, with
// bn = batch * n_head, 16-byte aligned; lse: (bn, s_q) f32. bias: null, or
// the element (batch, head, key) at bias_sb * batch + bias_sh * head +
// bias_sk * key, in f32 (bias_f32 == 1) or the input dtype. d in {64, 128,
// 256}; s_q and s_k multiples of 64. Launches on `stream`; does not
// synchronise.
extern "C" int azoo_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* lse, int bn, int s_q, int s_k, int d, int is_bf16, float scale,
    int causal, int n_head, int bias_f32, long long bias_sb,
    long long bias_sh, long long bias_sk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bias b{bias, bias_f32, n_head, bias_sb, bias_sh, bias_sk};
  if (s_q % 64 != 0 || s_k % 64 != 0 || n_head < 1)
    return int(cudaErrorInvalidValue);
  switch (d) {
    case 64:
      return int(launch<64>(is_bf16, q, k, v, b, out, lse, bn, s_q, s_k,
                            scale, causal, st));
    case 128:
      return int(launch<128>(is_bf16, q, k, v, b, out, lse, bn, s_q, s_k,
                             scale, causal, st));
    case 256:
      return int(launch<256>(is_bf16, q, k, v, b, out, lse, bn, s_q, s_k,
                             scale, causal, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The bf16 kernel's key tile at head dim d (64, 128 or 256; 0 otherwise),
// which the plain version must walk too.
extern "C" int azoo_flash_attention_fwd_bf16_block_k(int d) {
  return d == 64 ? Tile<64>::BK : d == 128 ? Tile<128>::BK
                                : d == 256 ? Tile<256>::BK : 0;
}
