// Blocked online-softmax (flash) attention on Hopper's tensor cores,
// sm_90a: wgmma on bf16 tiles fed by TMA through a shared-memory ring.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel /
// flash_attention() (pl.pallas_call at line 150) for bfloat16 inputs, and
// computes what it computes: for each (batch*head, query row),
//   s = (q . k^T) * scale, scale = 1/sqrt(d), in fp32;
//   causal: s = -2^30 where q_pos + q_offset < k_pos;
//   online softmax over kv blocks (m, l, alpha);
//   out = acc / max(l, 1e-30), rounded to bf16.
// Causal kv blocks wholly above the diagonal are not visited: the kv loop
// of q block qi stops at
//   min(nk, (qi*block_q + q_offset + block_q - 1) / block_kv + 1),
// the rule of the Pallas kernel's pl.when, of flash_attention.cu and of
// the tuner's FlashAttentionSpace._steps.
//
// Numerics: q and k are bf16, and bf16 x bf16 products are exact in fp32,
// so s differs from the reference only in summation order.  The one
// departure: p is rounded to bf16 to be the A operand of the p . v
// product, where the JAX kernel multiplies in fp32 (l sums the unrounded
// p).  tests/test_torch_flash.py emulates exactly this and holds it to the
// reference at its bf16 tolerance, 2e-2.  The softmax runs in the base-2
// domain (s * scale * log2(e), exp2f), which is the same function.
//
// What bounds it on the H100: operations.  4*d flops per visible (query,
// key) pair against four tensors that each move once: at d = 128 hundreds
// of flops per byte, far above the card's balance point, so only the
// tensor cores (989 TFLOP/s bf16 against 67 fp32) bring the time near
// the bound.  What each part of the design does about it:
// - Products on the tensor cores.  One consumer warpgroup owns a 64-row q
//   tile (block_q 128: two warpgroups).  S = Q . K^T is
//   wgmma.m64n{BKV}k16 with Q and K both K-major in shared memory; the
//   fp32 S accumulator stays in registers, where the softmax runs, and its
//   m64nN layout is converted in place to the bf16 A fragments of
//   O += P . V (wgmma.m64n{D}k16, A from registers).  S and P never touch
//   shared memory.  V is used as it lies (block_kv x d, row-major, i.e.
//   MN-major for the B operand) through wgmma's B-transpose bit: no
//   transposed staging.
// - Softmax in registers.  A row of the accumulator lives in the 4
//   threads of a quad, so the row max is two __shfl_xor_sync; the row sum
//   is kept per thread and reduced once at the end.  acc_row / acc_col map
//   an accumulator register to its (row, col) for the causal mask.
// - Loads by TMA.  Q is loaded once; K and V go through a ring of STAGES
//   shared-memory stages with a full/empty mbarrier pair each, filled by a
//   producer warp (no register reallocation: that, persistent CTAs,
//   ping-pong between warpgroups and fp8 are later work), so the next kv
//   tile's copy runs under the current tile's wgmmas.  Tiles are stored in
//   panels of 128-byte rows (64 elements, 128-byte swizzle) for d = 64 and
//   128, or 64-byte rows (32 elements, 64-byte swizzle) for d = 32 and 96;
//   the panel is the swizzle span, which sets the descriptors' strides.
// - Occupancy.  No fp32 staging: shared memory is the bf16 q tile plus
//   the ring, so a (64, 64) CTA at d = 128 takes 81 KB and two fit an SM.
// - q blocks below 64 rows (short and decode-like q) run in a 64-row tile
//   whose rows past block_q are zero-filled once and never stored; they
//   still take the tensor cores.  Heavier causal q blocks launch first.
//
// Launch limits (mirrored by repro_torch.kernels.flash_attention
// .launch_limits, which every caller reads, and reported by
// repro_flash_attention_wgmma_limits below): instantiated for
// d in {32, 64, 96, 128}, block_kv in {64, 128}, block_q in
// {4, 8, 16, 32, 64, 128}; 128 threads per consumer warpgroup plus a
// producer warp; dynamic shared memory
//   1024 (alignment) + 2 * d * (64 * warpgroups + 2 * STAGES * block_kv)
//   + 64 (barriers) bytes,
// opted in above 48 KB per instantiation.  Operands start on 16 bytes and
// rows of d bf16 are a multiple of 16 bytes, as TMA needs.
//
// C interface (bound with ctypes): repro_flash_attention_wgmma(...)
// encodes the three TMA descriptors on the host (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint so nothing links libcuda),
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 2;             // ring depth for K and V
constexpr int TILE_M = 64;            // rows of one wgmma tile
constexpr int WG = 128;               // threads of a warpgroup
constexpr int ALIGN = 1024;           // the 128-byte swizzle's atom
constexpr int BAR_BYTES = 64;         // room for 2 * STAGES + 1 mbarriers
constexpr float NEG_INF = -1073741824.0f;  // -2^30, finite as in the reference
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr size_t smem_bytes(int d, int bkv, int nwg) {
  return ALIGN + 2 * (size_t)d * (TILE_M * nwg + 2 * STAGES * bkv) + BAR_BYTES;
}

// A tile row of d elements is cut into panels of W elements, one swizzle
// span each; a panel holds all rows of the tile.
template <int D>
struct Panel {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  static constexpr int W = D % 64 == 0 ? 64 : 32;      // elements per row
  static constexpr int ROW = 2 * W;                    // bytes per row
  static constexpr int N = D / W;                      // panels per row
  static constexpr int LAYOUT = ROW == 128 ? 1 : 2;    // desc: B128 / B64
  static constexpr CUtensorMapSwizzle SWIZZLE =
      ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Wait for the phase of parity `parity` to complete.  A wait of 2^32
// cycles (about 2 s) is a lost phase, not a slow copy: trap, so that the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep registers that an in-flight wgmma reads or writes live and in place
// up to this point (the compiler sees only the issuing asm).
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | ((uint64_t)layout << 62);
}

// K-major operand (Q as A, K as B): k16 step kk of a tile of `rows` rows.
// Within a panel a step moves 32 bytes along the swizzled row; 8 rows (one
// swizzle atom) are ROW * 8 bytes apart; LBO is unused for K-major.
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int kk) {
  using P = Panel<D>;
  const int p = kk * 16 / P::W, e = kk * 16 % P::W;
  return desc(tile + p * rows * P::ROW + e * 2, 16, 8 * P::ROW, P::LAYOUT);
}

// V as the MN-major B operand of P . V (wgmma's transpose bit): k16 chunk
// c is rows [16c, 16c + 16) of the (BKV x d) tile.  8 k-rows (one atom)
// are ROW * 8 bytes apart (SBO); the next W columns, the next panel, are
// BKV * ROW bytes on (LBO).
template <int D, int BKV>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int c) {
  using P = Panel<D>;
  return desc(tile + c * 16 * P::ROW, BKV * P::ROW, 8 * P::ROW, P::LAYOUT);
}

// (row, col) within the 64 x N tile of fp32 accumulator register i of
// thread t (0..127) of a warpgroup: m64nNk16's layout, in which warp w
// owns rows 16w..16w+15, a quad of lanes shares a row, and registers come
// in (row, col), (row, col+1), (row+8, col), (row+8, col+1) per 8 columns.
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t % 4) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma.mma_async m64nNk16, fp32 += bf16 x bf16: A and B from shared
// memory (both K-major), or A from registers and B MN-major (transposed).
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d);
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d);

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<96>(float (&d)[48],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, "
      "1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
      "%67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// --------------------------------------------------------------- kernel

// One CTA per (batch*head, q block): NWG consumer warpgroups of 64 q rows
// each, then one producer warp.  block_q is 128 with NWG = 2, and 64 or
// fewer rows (padded to 64) with NWG = 1.
template <int D, int BKV, int NWG>
__global__ void __launch_bounds__(NWG * WG + 32, NWG == 1 ? 2 : 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ out, int sq,
                             int skv, int bq, int causal, int q_offset,
                             float scale_log2) {
  using P = Panel<D>;
  constexpr int THREADS = NWG * WG + 32;
  constexpr int Q_TILE = TILE_M * D * 2;      // bytes of one 64-row q tile
  constexpr int KV_TILE = BKV * D * 2;        // bytes of one k or v tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~uint32_t(ALIGN - 1);
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;                           // NWG q tiles
  const uint32_t kv_s = base + NWG * Q_TILE;           // stage: k, then v
  const uint32_t bars = kv_s + STAGES * 2 * KV_TILE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t qbar = bars + 8 * 2 * STAGES;

  const int g = blockIdx.x;                            // batch * head
  const int qi = gridDim.y - 1 - blockIdx.y;           // heavy blocks first
  const int first_q = qi * bq;
  const int nk = skv / BKV;
  const int visit = causal ? min(nk, (first_q + q_offset + bq - 1) / BKV + 1)
                           : nk;
  const int tid = threadIdx.x;

  if (bq < TILE_M) {  // rows [bq, 64) of each panel: zero once, never stored
    constexpr int PANEL = TILE_M * P::ROW;
    const int n16 = (TILE_M - bq) * P::ROW / 16;       // 16-byte words
    for (int idx = tid; idx < P::N * n16; idx += THREADS) {
      const int p = idx / n16, w = idx % n16;
      *reinterpret_cast<uint4*>(gbase + p * PANEL + bq * P::ROW + 16 * w) =
          make_uint4(0, 0, 0, 0);
    }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NWG * WG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the zeros above are generic-proxy writes that wgmma reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (tid >= NWG * WG) {  // producer warp: one lane issues every copy
    if (tid == NWG * WG) {
      mbar_expect_tx(qbar, bq * D * 2);
      for (int w = 0; w < NWG; ++w)
        for (int p = 0; p < P::N; ++p)
          tma_load(q_s + w * Q_TILE + p * TILE_M * P::ROW, &qmap, qbar,
                   p * P::W, g * sq + first_q + w * TILE_M);
      for (int ki = 0; ki < visit; ++ki) {
        const int s = ki % STAGES;
        if (ki >= STAGES) mbar_wait(empty(s), (ki / STAGES - 1) & 1);
        mbar_expect_tx(full(s), 2 * KV_TILE);
        const uint32_t k_t = kv_s + s * 2 * KV_TILE, v_t = k_t + KV_TILE;
        const int row = g * skv + ki * BKV;
        for (int p = 0; p < P::N; ++p) {
          tma_load(k_t + p * BKV * P::ROW, &kmap, full(s), p * P::W, row);
          tma_load(v_t + p * BKV * P::ROW, &vmap, full(s), p * P::W, row);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows [64*wg, 64*wg + 64) of the block
  const int wg = tid / WG, t = tid % WG;
  const uint32_t q_t = q_s + wg * Q_TILE;
  const int row0 = first_q + wg * TILE_M + q_offset;   // q_pos of tile row 0
  float s_acc[BKV / 2], o[D / 2];
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t pa[BKV / 16][4];

  mbar_wait(qbar, 0);
  for (int ki = 0; ki < visit; ++ki) {
    const int s = ki % STAGES;
    mbar_wait(full(s), (ki / STAGES) & 1);
    const uint32_t k_t = kv_s + s * 2 * KV_TILE, v_t = k_t + KV_TILE;

    // S = Q . K^T on the tensor cores
    hold(s_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BKV>(s_acc, kmajor<D>(q_t, TILE_M, kk), kmajor<D>(k_t, BKV, kk),
                  kk > 0);
    wg_commit();
    wg_wait0();
    hold(s_acc);

    // online softmax in registers, base 2; a row lives in a quad of lanes
    const int k0 = ki * BKV;
    const bool diag = causal && k0 + BKV - 1 > row0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      float x = s_acc[i] * scale_log2;
      if (diag && row0 + acc_row(t, i) < k0 + acc_col(t, i)) x = NEG_INF;
      s_acc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const float p = exp2f(s_acc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += p;
      s_acc[i] = p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    // the S accumulator of k16 chunk c is the A fragment of P . V: its
    // registers 8c..8c+7 in pairs, rounded to bf16
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[c][r] = pack_bf16(s_acc[8 * c + 2 * r], s_acc[8 * c + 2 * r + 1]);

    // O += P . V, P from registers, V as it lies (transposed B)
    hold(o);
    hold(pa);
    wg_fence();
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c)
      mma_rs<D>(o, pa[c], mnmajor<D, BKV>(v_t, c), 1);
    wg_commit();
    wg_wait0();
    hold(o);
    hold(pa);
    mbar_arrive(empty(s));
  }

  // out = o / max(l, 1e-30): the row sum across the quad, then bf16 pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  __nv_bfloat16* const og =
      out + ((int64_t)g * sq + first_q + wg * TILE_M) * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = acc_row(t, i);
    if (wg * TILE_M + r < bq)
      *reinterpret_cast<__nv_bfloat162*>(og + (int64_t)r * D + acc_col(t, i)) =
          __floats2bfloat162_rn(o[i] / l[(i >> 1) & 1],
                                o[i + 1] / l[(i >> 1) & 1]);
  }
}

// ----------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D (rows x d) bf16 view, copied in boxes of box_rows x W elements.
template <int D>
bool tensor_map(CUtensorMap* map, const void* ptr, long long rows,
                int box_rows) {
  using P = Panel<D>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)P::W, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            P::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BKV, int NWG>
int launch(const void* q, const void* k, const void* v, void* out,
           long long bh, int sq, int skv, int bq, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  auto kernel = flash_attention_wgmma_kernel<D, BKV, NWG>;
  const size_t smem = smem_bytes(D, BKV, NWG);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qm, km, vm;
  if (!tensor_map<D>(&qm, q, bh * sq, bq < TILE_M ? bq : TILE_M)
      || !tensor_map<D>(&km, k, bh * skv, BKV)
      || !tensor_map<D>(&vm, v, bh * skv, BKV))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)bh, (unsigned)(sq / bq));
  kernel<<<grid, NWG * WG + 32, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), sq, skv, bq, causal,
      q_offset, scale * LOG2E);
  return (int)cudaGetLastError();
}

bool block_q_ok(int bq) {
  return bq == 4 || bq == 8 || bq == 16 || bq == 32 || bq == 64 || bq == 128;
}

bool instantiated(int d, int bkv) {
  return (d == 32 || d == 64 || d == 96 || d == 128)
         && (bkv == 64 || bkv == 128);
}

}  // namespace

// The instantiated set's launch limits: dynamic shared memory and threads
// of one CTA; returns 0, or cudaErrorInvalidValue outside the set.
extern "C" int repro_flash_attention_wgmma_limits(int d, int bkv, int bq,
                                                  long long* smem,
                                                  int* threads) {
  if (!instantiated(d, bkv) || !block_q_ok(bq))
    return (int)cudaErrorInvalidValue;
  const int nwg = bq > TILE_M ? 2 : 1;
  *smem = (long long)smem_bytes(d, bkv, nwg);
  *threads = nwg * WG + 32;
  return (int)cudaSuccess;
}

// bf16 q (bh, sq, d), k and v (bh, skv, d), out (bh, sq, d), contiguous.
// The wrapper has checked shapes, divisibility, the instantiated set and
// alignment; the checks here only keep a bad call from launching.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* out,
                                           long long bh, int sq, int skv,
                                           int d, int bq, int bkv, int causal,
                                           int q_offset, float scale,
                                           void* stream) {
  if (bh <= 0 || sq <= 0) return (int)cudaSuccess;
  const long long rows = bh * (sq > skv ? sq : skv);
  if (!instantiated(d, bkv) || !block_q_ok(bq) || sq % bq || skv % bkv
      || (causal && q_offset < 0) || rows >= (1ll << 31)
      || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool two = bq > TILE_M;
#define REPRO_CASE(D_, BKV_)                                               \
  if (d == D_ && bkv == BKV_)                                              \
    return two ? launch<D_, BKV_, 2>(q, k, v, out, bh, sq, skv, bq, causal, \
                                     q_offset, scale, st)                  \
               : launch<D_, BKV_, 1>(q, k, v, out, bh, sq, skv, bq, causal, \
                                     q_offset, scale, st);
  REPRO_CASE(32, 64)
  REPRO_CASE(32, 128)
  REPRO_CASE(64, 64)
  REPRO_CASE(64, 128)
  REPRO_CASE(96, 64)
  REPRO_CASE(96, 128)
  REPRO_CASE(128, 64)
  REPRO_CASE(128, 128)
#undef REPRO_CASE
  return (int)cudaErrorInvalidValue;
}
