// Gradient of blocked (flash) attention on Hopper's tensor cores, sm_90a:
// dQ, dK and dV of softmax attention for bf16 operands, with wgmma on bf16
// tiles fed by TMA through shared-memory rings.
//
// Replaces no TPU kernel.  The Pallas kernel this port follows
// (src/repro/kernels/flash_attention.py, pl.pallas_call at line 150) has
// no backward: the JAX package trains through jax.grad of its softmax
// attention.  The port's training step takes this gradient in
// FlashAttentionFn's backward, whose plain version is attention_backward
// (repro_torch.kernels.flash_attention); this kernel takes its place on
// the card for bf16 at head dims up to 128.  For each (batch*head), with
// scale = 1/sqrt(d) of the real d and the forward's causal mask
// q_pos + q_offset < k_pos:
//   LSE_i = log sum_j exp(s_ij) over visible keys, s = scale * q . k^T;
//   P_ij  = exp(s_ij - LSE_i);
//   dP    = dO . V^T;
//   D_i   = sum_j P_ij * dP_ij, from the fp32 P and dP tiles;
//   dS    = P * (dP - D);
//   dV = P^T . dO,  dQ = scale * dS . K,  dK = scale * dS^T . Q.
// D never comes from rowsum(dO * O).  The forward rounds p to bf16 for
// its P . V product and stores O in bf16; at a sharp softmax (this init's
// scores reach the hundreds) dS is a small difference of large terms, and
// that rounding moves dQ by several per cent.
//
// Numerics: every product takes bf16 operands (q, k, v and dO are bf16,
// and bf16 x bf16 products are exact in fp32) and accumulates in fp32.
// The only roundings beyond summation order: P is rounded to bf16 as the
// A operand of dV, and dS as the operand of dQ and dK.  dQ's fp32 shares
// are summed in ascending kv order (below), so two runs give the same
// bits.  tests/test_torch_flash_backward.py
// emulates exactly this and holds it to jax.grad of the JAX reference at
// the bf16 tolerance, 2e-2 of each gradient's largest entry.  The softmax
// runs in the base-2 domain (s * scale * log2(e), exp2f), and LSE is kept
// there.
//
// Causal blocks wholly above the diagonal are not visited, by the
// forward's rule (flash_attention_wgmma.cu): the pair (q block of rows
// [q0, q0 + 64), kv block of keys [k0, k0 + 64)) is visited iff
//   k0 <= q0 + 63 + q_offset,
// its first key at or before its last query's position.  The rows pass
// visits exactly those pairs; the fused pass visits, for 128 kv rows, the
// q blocks that see the first 64 (masking whole a step where the other
// 64 are not seen).
//
// What bounds it on the H100: operations.  Five products of 2*d flops per
// visible (query, key) pair are needed (S, dP, dV, dQ, dK: 10*d), against
// q, k, v, dO, dq, dk and dv moving once: at d = 128 hundreds of flops
// per byte.  This design does seven (14*d) in two passes and a cast:
// (a) Rows pass, one CTA per (batch*head, 64 q rows), one consumer
//     warpgroup and a producer warp.  Q and dO are loaded once; K and V
//     stream through a ring of STAGES stages.  S = Q . K^T and dP = dO .
//     V^T (both operands K-major from shared memory), the online max and
//     sum of exp(S) and, rescaled by the same factors, the sum of exp(S) *
//     dP, so that LSE and D come out of one sweep.  It writes LSE and D
//     (fp32, b*h*sq each), and zeroes the fused pass's counters.
// (b) Fused pass, a persistent grid of one CTA per SM, 384 threads: two
//     consumer warpgroups at 240 registers and a producer warpgroup at 24
//     (setmaxnreg).  An item is 128 kv rows of one (batch*head), 64 for
//     each consumer, which holds their dK and dV in registers; items go
//     to CTAs in rounds, heavy first (all (batch*head)s' first 128 rows,
//     then the next), so that the items running at once belong mostly to
//     different (batch*head)s.  The producer's warp 0 loads K and V once
//     an item, then Q, dO and their rows' LSE and D (a bulk copy each)
//     through a ring of FUSED_STAGES stages, 64 q rows a step, the q
//     blocks that see the item from the last to the first.  A step, per
//     consumer, in the transposed orientation: S^T = K . Q^T and dP^T =
//     V . dO^T in two halves of 32 q columns (so that their accumulators
//     fit beside dK and dV), P^T and dS^T from LSE and D with P^T kept in
//     registers and dS^T stored to shared memory as bf16 (128-byte
//     swizzle, double-buffered by step); then, after a barrier of both
//     consumers, dQ's share of the item (below), and dK += dS^T . Q and
//     dV += P^T . dO (Q and dO MN-major), which run while the share is
//     staged in shared memory as fp32 (double-buffered by step).
//     dQ's share of a q block from an item: at D = 128 dS . K over the
//     item's 128 kv rows (both consumers' dS^T read through the transpose
//     bit), each consumer computing one 64-column panel of K; below, each
//     consumer's own over its 64 kv rows.  The shares are summed in fp32
//     in global memory (b*h*sq*D), in ascending kv order: a counter per
//     (batch*head, q block), zeroed by (a), holds how many items have
//     added.  The producer's warps 1-3 take the steps in turn; for its
//     step, an adder waits for the staged share and for the counter to
//     reach the item's index, stores (the first item) or adds (the
//     others, cp.reduce.async.bulk .add.f32; below D = 128 consumer 0's
//     share completes before consumer 1's is added) the share with bulk
//     operations, frees the staging once they have read it, and bumps
//     the counter after they complete and a fence.  A fence costs several
//     consumer steps; three adders and two staging buffers keep it off
//     the consumers' path, and no consumer waits on another CTA.  An
//     item waits only on items of lower kv rows, which come earlier in
//     every CTA's order, so with the grid resident the smallest
//     unfinished item always runs and the order cannot deadlock.
// (c) dQ cast, a CTA per (batch*head, q block): dQ = scale * its sums, in
//     bf16, through shared memory so that rows go out whole.
// All control flow around the wgmma of a consumer is uniform over the
// CTA (masked elements are selected, never branched over), and no path
// that may trap runs while a wgmma is in flight: either would make the
// compiler serialize every wgmma.  A step whose q block does not see a
// consumer's keys (or whose keys lie past skv, at an odd number of
// 64-row kv blocks) runs masked whole, its dS zero.
// Seven products of 2*d flops a visible pair in all.  Not taken: the
// next step's S^T and dP^T issued before this step's softmax (they do not
// fit 240 registers beside dK and dV at d = 128), clusters, fp8.
//
// Head dims between the instantiated ones (a multiple of 8 up to 128)
// run at D = tc_head_dim(d), the columns past d zero-filled by TMA, as in
// the forward; the outputs store the first d columns.
//
// Launch limits (mirrored by repro_torch.kernels.flash_attention
// .backward_launch_limits, and reported by
// repro_flash_attention_bwd_limits below): D in {32, 64, 96, 128}; sq and
// skv multiples of 64; q_offset >= 0; (a) 160 threads and
//   1024 + 2 * D * (2 * 64 + 2 * STAGES * 64) + 64 bytes,
// (b) 384 threads and
//   1024 + 2 * D * (4 * 64 + 2 * FUSED_STAGES * 64) + 4 * 8192
//        + 4 * 64 * dq_cols(D) * 4 + 8 * FUSED_STAGES * 64 + 128 bytes
// of dynamic shared memory, opted in above 48 KB; (c) 128 threads and
// 128 * D bytes of static shared memory.  Operands start on 16 bytes.
// Scratch, from the caller: LSE and D (fp32, b*h*sq each), dQ's fp32
// sums (b*h*sq*D) and b*h*(sq/64) int32 counters.
//
// C interface (bound with ctypes): repro_flash_attention_bwd(...) encodes
// the TMA descriptors on the host, launches (a), (b) and (c) on the given
// stream, does not synchronise, and returns cudaGetLastError().
#include "flash_attention_tc.cuh"

namespace {

constexpr int BM = 64;            // rows of every tile: q rows, kv rows
constexpr int FUSED_STAGES = 2;   // ring depth of the fused pass
constexpr int FUSED_THREADS = 3 * WG;
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
constexpr int DS_TILE = BM * BM * 2;    // a bf16 64 x 64 P^T or dS^T tile
constexpr int FUSED_BAR_BYTES = 128;    // 2 * FUSED_STAGES + 8 mbarriers

__host__ __device__ constexpr size_t rows_smem(int D) {
  return ALIGN + 2 * (size_t)D * (2 * BM + 2 * STAGES * BM) + BAR_BYTES;
}

// dQ's share of a q block from an item: at D = 128 one dS . K product
// over the item's 128 kv rows, each consumer computing a 64-column panel
// of K (its accumulator beside dK and dV in flight fits 240 registers);
// below, each consumer's own product over its 64 kv rows, whole (half a
// panel would split a swizzle atom of K), consumer 0's added first.
__host__ __device__ constexpr int dq_cols(int D) { return D == 128 ? 64 : D; }

__host__ __device__ constexpr size_t fused_smem(int D) {
  return ALIGN + 2 * (size_t)D * (4 * BM + 2 * FUSED_STAGES * BM)
         + 4 * DS_TILE + 4 * BM * dq_cols(D) * 4 + 8 * FUSED_STAGES * BM
         + FUSED_BAR_BYTES;
}

// a 1-D bulk copy of `bytes` (a multiple of 16) from global memory,
// counted on the mbarrier like a TMA tile
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}


// Store a 64 x D fp32 accumulator times `mul` as bf16 rows of d columns.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, int d,
                                           const float (&acc)[D / 2],
                                           float mul, int t) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = acc_row(t, i), c = acc_col(t, i);
    if (c < d)     // c even, d a multiple of 8
      *reinterpret_cast<__nv_bfloat162*>(dst + (int64_t)r * d + c) =
          __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
  }
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Wait until the counter reaches `want`.  As mbar_wait: 2^32 cycles is
// a lost count, so trap rather than hang the card.
__device__ __forceinline__ void wait_count(const int* c, int want) {
  const long long t0 = clock64();
  for (;;) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v) : "l"(c) : "memory");
    if (v >= want) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// Thread 0 of the calling warpgroup copies (`first`) or adds (.add.f32)
// `bytes` of shared memory at src to global memory at dst, as one bulk
// operation in a bulk group of its own, after a proxy fence that orders
// it behind the counter it has acquired.  Predicated, not branched.
__device__ __forceinline__ void bulk_put(float* dst, uint32_t src,
                                         uint32_t bytes, bool first, int t) {
  asm volatile(
      "{\n.reg .pred f, c, a;\n"
      "setp.ne.s32 f, %4, 0;\n"
      "setp.eq.and.s32 c, %3, 0, f;\n"       // thread 0 and first
      "setp.eq.and.s32 a, %3, 0, !f;\n"      // thread 0 and not first
      "fence.proxy.async.global;\n"
      "@c cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "@a cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n}\n"
      ::"l"(dst), "r"(src), "r"(bytes), "r"(t), "r"((int)first)
      : "memory");
}

// Wait until this thread's bulk operations are complete: their writes
// performed, their shared memory free.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 2^x, one MUFU op: the fused pass's P (its inputs are at most 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The first q block whose last row sees key k0 under the causal mask,
// q0 + BM - 1 + q_offset >= k0; 0 without the mask.
__device__ __forceinline__ int first_q(int k0, int causal, int q_offset) {
  const int need = k0 - q_offset - (BM - 1);
  return causal && need > 0 ? (need + BM - 1) / BM : 0;
}

// wgmma.mma_async m64nNk16, fp32 += bf16 x bf16, both operands from
// shared memory, A transposed (MN-major) if TA and B if TB.  Overloaded
// on the accumulator's size: N = 32, 64, 96, 128.
template <int TA, int TB>
__device__ __forceinline__ void mma_t(float (&d)[16], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_t(float (&d)[32], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_t(float (&d)[48], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_t(float (&d)[64], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}


// Store columns [c0, c0 + 32) of a 64 x 64 fp32 tile (P^T or dS^T: rows
// keys, columns queries) as bf16 in the 128-byte-swizzled layout TMA
// would give it: the 16-byte chunk of column c in row r sits at chunk
// (c / 8) ^ (r % 8) of the row.
__device__ __forceinline__ void store_t(uint32_t tile,
                                         const float (&x)[BM / 4], int c0,
                                         int t) {
#pragma unroll
  for (int i = 0; i < BM / 4; i += 2) {
    const int r = acc_row(t, i), c = c0 + acc_col(t, i);
    asm volatile("st.shared.b32 [%0], %1;\n"
                 ::"r"(tile + r * 128 + (((c >> 3) ^ (r & 7)) << 4)
                       + (c & 7) * 2), "r"(pack_bf16(x[i], x[i + 1])));
  }
}

// Shared memory by 32-bit address (a generic pointer would hold two
// registers): two floats, and four.
__device__ __forceinline__ float2 lds2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts4(uint32_t a, float x, float y, float z,
                                     float w) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(a), "f"(x), "f"(y), "f"(z), "f"(w));
}

// dQ's fp32 sums of q block ci: column block h (QN = dq_cols(D)
// columns) at h * 64 * QN floats, in its accumulator's order (register
// 4m..4m+3 of thread t at float4 m * WG + t).
template <int D>
__device__ __forceinline__ float* dq_sums(float* dq_acc, int ci, int h) {
  return dq_acc + (int64_t)ci * BM * D + h * BM * dq_cols(D);
}

// ------------------------------------------------------------ (a) rows

template <int D>
__global__ void __launch_bounds__(WG + 32, min_ctas(rows_smem(D)))
flash_attention_bwd_rows_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __grid_constant__ CUtensorMap omap,
                                float* __restrict__ lse,
                                float* __restrict__ dsum,
                                int* __restrict__ counters, int sq, int skv,
                                int causal, int q_offset, float scale_log2) {
  using P = Panel<D>;
  constexpr int TILE = BM * D * 2;            // bytes of one 64-row tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~uint32_t(ALIGN - 1);
  const uint32_t q_s = base, o_s = base + TILE;
  const uint32_t kv_s = base + 2 * TILE;                 // stage: k, then v
  const uint32_t bars = kv_s + STAGES * 2 * TILE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t qbar = bars + 8 * 2 * STAGES;

  const int g = blockIdx.x;                             // batch * head
  const int qi = gridDim.y - 1 - blockIdx.y;            // heavy blocks first
  const int q0 = qi * BM;
  const int nk = skv / BM;
  const int visit = causal ? min(nk, (q0 + q_offset + BM - 1) / BM + 1)
                           : nk;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    counters[(int64_t)g * gridDim.y + qi] = 0;   // for the fused pass
  }
  __syncthreads();

  if (tid >= WG) {  // producer warp: one lane issues every copy
    if (tid == WG) {
      mbar_expect_tx(qbar, 2 * TILE);
      for (int p = 0; p < P::N; ++p) {
        tma_load(q_s + p * BM * P::ROW, &qmap, qbar, p * P::W,
                 g * sq + q0);
        tma_load(o_s + p * BM * P::ROW, &omap, qbar, p * P::W,
                 g * sq + q0);
      }
      for (int it = 0; it < visit; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), (it / STAGES - 1) & 1);
        mbar_expect_tx(full(s), 2 * TILE);
        const uint32_t k_t = kv_s + s * 2 * TILE, v_t = k_t + TILE;
        for (int p = 0; p < P::N; ++p) {
          tma_load(k_t + p * BM * P::ROW, &kmap, full(s), p * P::W,
                   g * skv + it * BM);
          tma_load(v_t + p * BM * P::ROW, &vmap, full(s), p * P::W,
                   g * skv + it * BM);
        }
      }
    }
    return;
  }

  const int t = tid;
  // per thread's two rows (acc_row(t, 0) and +8): the running max, the
  // sum of exp and the sum of exp * dP, both rescaled on a new max
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  // S = Q . K^T and dP = dO . V^T of kv block it into (s_, dp_)
  auto issue = [&](float (&s_)[BM / 2], float (&dp_)[BM / 2], int it) {
    const int st = it % STAGES;
    mbar_wait(full(st), (it / STAGES) & 1);
    const uint32_t k_t = kv_s + st * 2 * TILE, v_t = k_t + TILE;
    hold(s_);
    hold(dp_);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BM>(s_, kmajor<D>(q_s, BM, kk), kmajor<D>(k_t, BM, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BM>(dp_, kmajor<D>(o_s, BM, kk), kmajor<D>(v_t, BM, kk), kk > 0);
    wg_commit();
  };
  // the online max and sums over kv block it, once its products are in
  auto absorb = [&](float (&s_)[BM / 2], float (&dp_)[BM / 2], int it) {
    hold(s_);
    hold(dp_);
    mbar_arrive(empty(it % STAGES));
    // masked: key it * BM + col after query q0 + q_offset + row
    const int lim = causal ? q0 + q_offset - it * BM : (1 << 30);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const float x = acc_col(t, i) - acc_row(t, i) > lim
                      ? NEG_INF : s_[i] * scale_log2;
      s_[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float alpha = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha;
      dd[h] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const float p = exp2f(s_[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += p;
      dd[(i >> 1) & 1] += p * dp_[i];
    }
  };
  float s_acc[BM / 2], dp[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) s_acc[i] = dp[i] = 0.f;
  mbar_wait(qbar, 0);
  for (int it = 0; it < visit; ++it) {
    issue(s_acc, dp, it);
    wg_wait0();
    absorb(s_acc, dp, it);
  }
  // the row sums across the quad; LSE (base 2) and D of the two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    dd[h] += __shfl_xor_sync(0xffffffffu, dd[h], 1);
    dd[h] += __shfl_xor_sync(0xffffffffu, dd[h], 2);
  }
  if (t % 4 == 0) {
    const int64_t r = (int64_t)g * sq + q0 + acc_row(t, 0);
    lse[r] = m[0] + log2f(l[0]);
    lse[r + 8] = m[1] + log2f(l[1]);
    dsum[r] = dd[0] / l[0];
    dsum[r + 8] = dd[1] / l[1];
  }
}

// ----------------------------------------------------------- (b) fused

// wgmma descriptors from a base descriptor built once a step: the offset
// of a k16 step (K-major) or chunk (MN-major) added to the address field
// (16-byte units; shared addresses stay below 2^18).  `fresh` keeps the
// compiler from hoisting every step's descriptors out of the loop, where
// they would hold dozens of registers for the whole pass.
__device__ __forceinline__ uint64_t fresh(uint64_t x) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(x));
  return x;
}

template <int D>
__device__ __forceinline__ uint64_t kbase(uint32_t tile) {
  using P = Panel<D>;
  return fresh(desc(tile, 16, 8 * P::ROW, P::LAYOUT));
}

template <int D>
__device__ __forceinline__ uint64_t kstep(uint64_t base, int kk) {
  using P = Panel<D>;
  const int p = kk * 16 / P::W, e = kk * 16 % P::W;
  return base + ((p * BM * P::ROW + e * 2) >> 4);
}

template <int D>
__device__ __forceinline__ uint64_t mbase(uint32_t tile) {
  using P = Panel<D>;
  return fresh(desc(tile, BM * P::ROW, 8 * P::ROW, P::LAYOUT));
}

template <int D>
__device__ __forceinline__ uint64_t mstep(uint64_t base, int c) {
  return base + ((c * 16 * Panel<D>::ROW) >> 4);
}

// Adder warp k (0..2) of the producer warpgroup, lane 0: walks the CTA's
// items and steps as the consumers do, and takes every third step: once
// the consumers have staged the item's share of the step's q block
// (share_full) and the q block's counter shows that the items of lower
// kv rows have added theirs, copies it (the first item) or adds it to the
// fp32 sums with bulk operations, frees the staging (share_empty) once
// they have read it, and bumps the counter once they are complete, after
// a fence.  Three adders take turns because the fence costs several
// consumer steps; the consumers never wait on another CTA.
template <int D>
__device__ __forceinline__ void add_shares(int k, int* counters,
                                           float* dq_acc, uint32_t stage_s,
                                           uint32_t full, uint32_t empty,
                                           int bh, int nq, int items, int G,
                                           int c, int causal, int q_offset) {
  constexpr int QN = dq_cols(D);
  int it = 0;
  for (int r = 0;; ++r) {
    const int w = r * G + (r & 1 ? G - 1 - c : c);
    if (w >= items) break;
    const int j = w / bh;
    for (int i = nq - 1; i >= first_q(j * 2 * BM, causal, q_offset);
         --i, ++it) {
      if (it % 3 != k) continue;
      const int ci = w % bh * nq + i;
      mbar_wait(full, it / 3 & 1);
      wait_count(counters + ci, j);
      const uint32_t src = stage_s + (it & 1) * 2 * BM * QN * 4;
      if (QN < D) {   // two column halves, in any order
        for (int h = 0; h < 2; ++h)
          bulk_put(dq_sums<D>(dq_acc, ci, h), src + h * BM * QN * 4,
                   BM * QN * 4, j == 0, 0);
      } else {        // consumer 0's share, complete, then consumer 1's
        bulk_put(dq_sums<D>(dq_acc, ci, 0), src, BM * QN * 4, j == 0, 0);
        bulk_wait();
        bulk_put(dq_sums<D>(dq_acc, ci, 0), src + BM * QN * 4, BM * QN * 4,
                 false, 0);
      }
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(empty);
      bulk_wait();
      asm volatile("fence.acq_rel.gpu;\n"
                   "red.relaxed.gpu.global.add.s32 [%0], 1;\n"
                   ::"l"(counters + ci) : "memory");
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FUSED_THREADS, 1)
flash_attention_bwd_fused_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const __grid_constant__ CUtensorMap omap,
                                 __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ dsum,
                                 float* __restrict__ dq_acc,
                                 int* __restrict__ counters, int bh, int sq,
                                 int skv, int d, int causal, int q_offset,
                                 float scale, float scale_log2) {
  using P = Panel<D>;
  constexpr int TILE = BM * D * 2;            // bytes of one 64-row tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~uint32_t(ALIGN - 1);
  const uint32_t k_s = base, v_s = base + 2 * TILE;   // a tile a consumer
  const uint32_t ring = base + 4 * TILE;               // stage: q, then dO
  // dS^T tiles by step parity and consumer; the consumers' staging of
  // dQ's share by step parity; a stage's LSE and D
  const uint32_t ds_s = ring + FUSED_STAGES * 2 * TILE;
  const uint32_t stage_s = ds_s + 4 * DS_TILE;
  const uint32_t rows_s = stage_s + 4 * BM * dq_cols(D) * 4;
  const uint32_t bars = rows_s + FUSED_STAGES * 8 * BM;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (FUSED_STAGES + s); };
  const uint32_t kv_full = bars + 16 * FUSED_STAGES, kv_empty = kv_full + 8;
  // the staged shares of dQ of adder warp k's steps: ready, and taken
  auto share_full = [&](int k) { return kv_full + 16 + 8 * k; };
  auto share_empty = [&](int k) { return kv_full + 40 + 8 * k; };

  // Items: the 128-kv-row blocks j of each (batch*head) g, j-major (w = j
  // * bh + g), so the heavy ones come first and kv block b's item comes
  // before block b + 2's; CTA c takes w = r * G + c in even rounds r and
  // r * G + G - 1 - c in odd ones.  All of it is uniform over the CTA.
  const int nq = sq / BM, nk = skv / BM, nkb = (nk + 1) / 2;
  const int items = bh * nkb, G = gridDim.x, c = blockIdx.x;
  const int tid = threadIdx.x;
  const int wg = tid / WG;

  if (tid == 0) {
    for (int s = 0; s < FUSED_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * WG);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 2 * WG);
    for (int k = 0; k < 3; ++k) {
      mbar_init(share_full(k), 2 * WG);
      mbar_init(share_empty(k), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    const int lane = tid % 32, warp = tid / 32 % 4;
    if (warp > 0) {
      if (lane == 0) add_shares<D>(warp - 1, counters, dq_acc, stage_s,
                                   share_full(warp - 1),
                                   share_empty(warp - 1), bh, nq, items, G,
                                   c, causal, q_offset);
    } else if (lane == 0) {   // warp 0: every copy
      int it = 0;
      for (int r = 0;; ++r) {
        const int w = r * G + (r & 1 ? G - 1 - c : c);
        if (w >= items) break;
        const int row = w % bh * skv + w / bh * 2 * BM;
        if (r > 0) mbar_wait(kv_empty, (r - 1) & 1);
        // both tiles, also past skv (the next rows, or TMA's zeros past
        // the end: finite, and masked)
        mbar_expect_tx(kv_full, 4 * TILE);
        for (int h = 0; h < 2; ++h)
          for (int p = 0; p < P::N; ++p) {
            const uint32_t off = h * TILE + p * BM * P::ROW;
            tma_load(k_s + off, &kmap, kv_full, p * P::W, row + h * BM);
            tma_load(v_s + off, &vmap, kv_full, p * P::W, row + h * BM);
          }
        const int first = first_q(w / bh * 2 * BM, causal, q_offset);
        for (int i = nq - 1; i >= first; --i, ++it) {
          const int s = it % FUSED_STAGES;
          if (it >= FUSED_STAGES)
            mbar_wait(empty(s), (it / FUSED_STAGES - 1) & 1);
          mbar_expect_tx(full(s), 2 * TILE + 8 * BM);
          const uint32_t q_t = ring + s * 2 * TILE;
          const int qrow = w % bh * sq + i * BM;
          for (int p = 0; p < P::N; ++p) {
            tma_load(q_t + p * BM * P::ROW, &qmap, full(s), p * P::W, qrow);
            tma_load(q_t + TILE + p * BM * P::ROW, &omap, full(s), p * P::W,
                     qrow);
          }
          const uint32_t r_t = rows_s + s * 8 * BM;
          bulk_load(r_t, lse + qrow, 4 * BM, full(s));
          bulk_load(r_t + 4 * BM, dsum + qrow, 4 * BM, full(s));
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: kv rows [kc + 64 wg, kc + 64 wg + 64) of item
  // w.  The item adds its share (dq_cols) to each of its q blocks' dQ,
  // computed also where the q block does not see a consumer's keys (its
  // dS is zero there) and past skv, so a q block's counter runs over the
  // items of kv rows up to the last it sees, and all control flow is
  // uniform over the CTA.
  reg_alloc<CONSUMER_REGS>();
  constexpr int QN = dq_cols(D);
  constexpr bool SPLIT = QN < D;
  const int t = tid % WG;
  const uint32_t k_t = k_s + wg * TILE, v_t = v_s + wg * TILE;
  const uint32_t st_t = stage_s + wg * BM * QN * 4;
  int it = 0;
  for (int r = 0;; ++r) {
    const int w = r * G + (r & 1 ? G - 1 - c : c);
    if (w >= items) break;
    const int g = w % bh, kc = w / bh * 2 * BM;
    const int k0 = kc + wg * BM;
    const bool valid = k0 < skv;
    const int first = first_q(kc, causal, q_offset);
    // the first q block that sees this warpgroup's keys (none past skv)
    const int mine_from = valid ? first_q(k0, causal, q_offset) : nq;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;
    mbar_wait(kv_full, r & 1);
    for (int i = nq - 1; i >= first; --i, ++it) {
      const int s = it % FUSED_STAGES;
      mbar_wait(full(s), (it / FUSED_STAGES) & 1);
      const uint32_t q_t = ring + s * 2 * TILE, o_t = q_t + TILE;
      const uint32_t ds0 = ds_s + (it & 1) * 2 * DS_TILE;  // this step's
      uint32_t pa[BM / 16][4];            // P^T as dV's A operand
      const uint32_t ds_t = ds0 + wg * DS_TILE;
      const uint32_t lse_s = rows_s + s * 8 * BM, d_s = lse_s + 4 * BM;
      // masked: key k0 + row after query q0 + col, i.e. row - col > lim,
      // with lim moved out of reach without the causal mask and below
      // every row - col where the q block does not see these keys
      const int lim = i < mine_from ? -(1 << 30)
                      : causal ? i * BM + q_offset - k0 : (1 << 30);
      // S^T = K . Q^T, dP^T = V . dO^T (rows keys, columns queries), P^T
      // and dS^T, 32 query columns at a time: their accumulators beside dK
      // and dV fit the registers
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float st[BM / 4], dpt[BM / 4];
#pragma unroll
        for (int x = 0; x < BM / 4; ++x) st[x] = dpt[x] = 0.f;
        {
          const uint32_t off = hh * 32 * Panel<D>::ROW;   // 32 rows of q
          const uint64_t kd = kbase<D>(k_t), qd = kbase<D>(q_t + off);
          const uint64_t vd = kbase<D>(v_t), od = kbase<D>(o_t + off);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            mma_ss<BM / 2>(st, kstep<D>(kd, kk), kstep<D>(qd, kk), 1);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            mma_ss<BM / 2>(dpt, kstep<D>(vd, kk), kstep<D>(od, kk), 1);
          wg_commit();
          wg_wait0();
        }
        hold(st);
        hold(dpt);
#pragma unroll
        for (int cc = 0; cc < BM / 16; ++cc) {  // cols 32hh + 8cc + 2(t%4) + e
          const int col = 32 * hh + 8 * cc + 2 * (t % 4);
          const float2 l = lds2(lse_s + 4 * col);
          const float2 dd = lds2(d_s + 4 * col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * cc + e;
            const bool masked =
                acc_row(t, x) - (32 * hh + acc_col(t, x)) > lim;
            const float p = masked ? 0.f
                : fast_exp2(st[x] * scale_log2 - (e & 1 ? l.y : l.x));
            st[x] = p;
            dpt[x] = masked ? 0.f : p * (dpt[x] - (e & 1 ? dd.y : dd.x));
          }
        }
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
          for (int r2 = 0; r2 < 4; ++r2)
            pa[2 * hh + c2][r2] = pack_bf16(st[8 * c2 + 2 * r2],
                                            st[8 * c2 + 2 * r2 + 1]);
        store_t(ds_t, dpt, 32 * hh, t);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // both consumers' dS^T, for the share
      asm volatile("bar.sync 3, %0;\n" ::"n"(2 * WG) : "memory");
      // this step's staging is free again: step it - 2's shares are read
      if (it > 1) mbar_wait(share_empty((it - 2) % 3), (it - 2) / 3 & 1);
      float dqs[QN / 2];
#pragma unroll
      for (int x = 0; x < QN / 2; ++x) dqs[x] = 0.f;
      hold(dk_acc);
      hold(dv_acc);
      hold(pa);
      {
        const uint64_t sk = kbase<BM>(ds_t);
        const uint64_t qd = mbase<D>(q_t), od = mbase<D>(o_t);
        wg_fence();
        // the share dS . K (at D = 128 over both consumers' kv rows,
        // K's panel wg) in a group of its own, then dK += dS^T . Q and
        // dV += P^T . dO, which run while the share is staged
        if (SPLIT) {
#pragma unroll
          for (int cc = 0; cc < 2 * BM / 16; ++cc)
            mma_t<1, 1>(dqs, mstep<BM>(mbase<BM>(ds0 + cc / 4 * DS_TILE),
                                       cc % 4),
                        mstep<D>(mbase<D>(k_s + cc / 4 * TILE
                                          + wg * BM * Panel<D>::ROW),
                                 cc % 4), 1);
        } else {
          const uint64_t sd = mbase<BM>(ds_t), kd = mbase<D>(k_t);
#pragma unroll
          for (int cc = 0; cc < BM / 16; ++cc)
            mma_t<1, 1>(dqs, mstep<BM>(sd, cc), mstep<D>(kd, cc), 1);
        }
        wg_commit();
#pragma unroll
        for (int cc = 0; cc < BM / 16; ++cc)
          mma_t<0, 1>(dk_acc, kstep<BM>(sk, cc), mstep<D>(qd, cc), 1);
#pragma unroll
        for (int cc = 0; cc < BM / 16; ++cc)
          mma_rs<D>(dv_acc, pa[cc], mstep<D>(od, cc), 1);
        wg_commit();
        wg_wait<1>();
        hold(dqs);
#pragma unroll
        for (int m = 0; m < QN / 8; ++m)
          sts4(st_t + (it & 1) * 2 * BM * QN * 4 + 16 * (m * WG + t),
               dqs[4 * m], dqs[4 * m + 1],
               dqs[4 * m + 2], dqs[4 * m + 3]);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(share_full(it % 3));   // to this step's adder warp
        wg_wait0();
      }
      hold(dk_acc);
      hold(dv_acc);
      hold(pa);
      mbar_arrive(empty(s));
    }
    mbar_arrive(kv_empty);
    if (valid) {
      const int64_t out = ((int64_t)g * skv + k0) * d;
      store_rows<D>(dk + out, d, dk_acc, scale, t);
      store_rows<D>(dv + out, d, dv_acc, 1.f, t);
    }
  }
}

// ---------------------------------------------------------- (c) dQ cast

// dQ = scale * its fp32 sums, as bf16 rows of d columns: a CTA of 128
// threads per (batch*head, q block), thread t taking the registers of
// thread t of the share's accumulators, through shared memory so that
// the rows go out whole.
template <int D>
__global__ void __launch_bounds__(WG)
flash_attention_bwd_dq_kernel(float* __restrict__ dq_acc,
                              __nv_bfloat16* __restrict__ dq, int d,
                              float scale) {
  constexpr int QN = dq_cols(D);
  __shared__ __align__(16) __nv_bfloat16 tile[BM * D];
  const int ci = blockIdx.x, t = threadIdx.x;
  const float4* const acc =
      reinterpret_cast<const float4*>(dq_sums<D>(dq_acc, ci, 0));
#pragma unroll
  for (int mm = 0; mm < D / 8; ++mm) {
    const float4 v = __ldcs(acc + mm * WG + t);
    const int m = mm % (QN / 8), h = mm / (QN / 8);
    const int r = acc_row(t, 4 * m), c = h * QN + acc_col(t, 4 * m);
    *reinterpret_cast<__nv_bfloat162*>(tile + r * D + c) =
        __floats2bfloat162_rn(v.x * scale, v.y * scale);
    *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * D + c) =
        __floats2bfloat162_rn(v.z * scale, v.w * scale);
  }
  __syncthreads();
  // 16-byte pieces of the d columns of each row (d a multiple of 8)
  __nv_bfloat16* const out = dq + (int64_t)ci * BM * d;
  for (int k = t; k < BM * d / 8; k += WG) {
    const int r = k / (d / 8), c = k % (d / 8) * 8;
    *reinterpret_cast<uint4*>(out + (int64_t)r * d + c) =
        *reinterpret_cast<const uint4*>(tile + r * D + c);
  }
}

// ----------------------------------------------------------------- host

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* dsum,
           float* dq_acc, int* counters, long long bh, int sq, int skv,
           int d, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  auto ka = flash_attention_bwd_rows_kernel<D>;
  auto kb = flash_attention_bwd_fused_kernel<D>;
  const size_t sa = rows_smem(D), sb = fused_smem(D);
  cudaError_t e = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sb);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qm, km, vm, om;
  if (!tensor_map<D>(&qm, q, bh * sq, BM, d)
      || !tensor_map<D>(&om, dout, bh * sq, BM, d)
      || !tensor_map<D>(&km, k, bh * skv, BM, d)
      || !tensor_map<D>(&vm, v, bh * skv, BM, d))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * LOG2E;
  ka<<<dim3((unsigned)bh, (unsigned)(sq / BM)), WG + 32, sa, stream>>>(
      qm, km, vm, om, lse, dsum, counters, sq, skv, causal, q_offset,
      scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long items = bh * ((skv / BM + 1) / 2);
  const int grid = (int)(items < sms ? items : sms);
  kb<<<grid, FUSED_THREADS, sb, stream>>>(
      qm, km, vm, om, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), lse, dsum, dq_acc, counters, (int)bh,
      sq, skv, d, causal, q_offset, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_attention_bwd_dq_kernel<D><<<(unsigned)(bh * (sq / BM)), WG, 0,
                                     stream>>>(
      dq_acc, static_cast<__nv_bfloat16*>(dq), d, scale);
  return (int)cudaGetLastError();
}

// D: an instantiated head dim (tc_head_dim) the backward is built for
bool bwd_built(int D) { return D == 32 || D == 64 || D == 96 || D == 128; }

}  // namespace

// The launch limits at head dim d: dynamic shared memory and threads of
// the rows pass's CTA and of the fused pass's; returns 0, or
// cudaErrorInvalidValue for a head dim it is not built for.
extern "C" int repro_flash_attention_bwd_limits(int d, long long* smem_rows,
                                                long long* smem_fused,
                                                int* threads_rows,
                                                int* threads_fused) {
  const int D = tc_head_dim(d);
  if (!bwd_built(D)) return (int)cudaErrorInvalidValue;
  *smem_rows = (long long)rows_smem(D);
  *smem_fused = (long long)fused_smem(D);
  *threads_rows = WG + 32;
  *threads_fused = FUSED_THREADS;
  return (int)cudaSuccess;
}

// bf16 q and dout (bh, sq, d), k and v (bh, skv, d); dq, dk, dv of their
// operands' shapes; scratch: lse and dsum fp32 of bh * sq, dq_acc fp32 of
// bh * sq * tc_head_dim(d), counters int32 of bh * (sq / 64) + 1; all
// contiguous.  The wrapper has checked shapes, types and alignment; the
// checks here only keep a bad call from launching.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         void* dq, void* dk, void* dv,
                                         void* lse, void* dsum, void* dq_acc,
                                         void* counters, long long bh,
                                         int sq, int skv, int d, int causal,
                                         int q_offset, float scale,
                                         void* stream) {
  if (bh <= 0 || sq <= 0) return (int)cudaSuccess;
  const long long rows = bh * (sq > skv ? sq : skv);
  const int D = tc_head_dim(d);
  if (!bwd_built(D) || skv <= 0 || sq % BM || skv % BM || q_offset < 0
      || rows >= (1ll << 31) || sq / BM > 65535 || skv / BM > 65535
      || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout
          | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv | (uintptr_t)lse
          | (uintptr_t)dsum | (uintptr_t)dq_acc | (uintptr_t)counters) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  float* ds = static_cast<float*>(dsum);
  float* acc = static_cast<float*>(dq_acc);
  int* cnt = static_cast<int*>(counters);
#define REPRO_CASE(D_)                                                      \
  if (D == D_)                                                              \
    return launch<D_>(q, k, v, dout, dq, dk, dv, l, ds, acc, cnt, bh, sq,   \
                      skv, d, causal, q_offset, scale, st);
  REPRO_CASE(32)
  REPRO_CASE(64)
  REPRO_CASE(96)
  REPRO_CASE(128)
#undef REPRO_CASE
  return (int)cudaErrorInvalidValue;
}
