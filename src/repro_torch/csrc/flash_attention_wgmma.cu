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
//   panels of 128-byte rows (64 elements, 128-byte swizzle) for d = 64,
//   128 and 256, or 64-byte rows (32 elements, 64-byte swizzle) for d = 32
//   and 96; the panel is the swizzle span, which sets the descriptors'
//   strides.
// - Head dims between the instantiated ones.  A head dim d, a multiple of
//   8 up to 256, runs the instantiation D = tc_head_dim(d) (112 runs at
//   128).  The TMA views are d wide with rows of 2d bytes, the boxes
//   still W wide: TMA fills the columns d..D-1 of every tile with zeros,
//   counted in the transaction bytes like the rest of the box, so the
//   mbarrier byte counts do not change.  Zero columns add nothing to
//   q . k^T and give output columns that are never stored; the scale is
//   1/sqrt(d) of the real d, and the output rows are d wide.  The cost is
//   the arithmetic of D (128/112 at zamba2-7b's head dim).
// - d = 256 (gemma-7b): P . V is one m64n256k16 wgmma per k16 chunk into
//   an O accumulator of 128 registers a thread.  Only one warpgroup per
//   CTA is built there: with two (nine warps) ptxas holds a thread to 168
//   registers, and O spills (224 bytes at block_kv 64).  One warpgroup at
//   block_kv 64 takes 204 registers and 164,928 bytes of shared memory,
//   one CTA per SM.
// - Occupancy.  No fp32 staging: shared memory is the bf16 q tile plus
//   the ring, so a (64, 64) CTA at d = 128 takes 81 KB and two fit an SM.
// - q blocks below 64 rows (short and decode-like q) run in a 64-row tile
//   whose rows past block_q are zero-filled once and never stored; they
//   still take the tensor cores.  Heavier causal q blocks launch first.
//
// Launch limits (mirrored by repro_torch.kernels.flash_attention
// .launch_limits, which every caller reads, and reported by
// repro_flash_attention_wgmma_limits below): instantiated for
// D in {32, 64, 96, 128} with block_kv in {64, 128} and block_q in
// {4, 8, 16, 32, 64, 128}, and for D = 256 with block_kv 64 and block_q
// at most 64 (built() below); 128 threads per consumer warpgroup plus a
// producer warp; dynamic shared memory
//   1024 (alignment) + 2 * D * (64 * warpgroups + 2 * STAGES * block_kv)
//   + 64 (barriers) bytes,
// opted in above 48 KB per instantiation.  __launch_bounds__ asks for
// registers for two resident CTAs only where two fit an SM's shared
// memory.  Operands start on 16 bytes and rows of d bf16 are a multiple
// of 16 bytes (d % 8 == 0), as TMA needs.
//
// C interface (bound with ctypes): repro_flash_attention_wgmma(...)
// encodes the three TMA descriptors on the host (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint so nothing links libcuda),
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().
//
// The panel layout, descriptors, PTX wrappers and TMA encoding are in
// flash_attention_tc.cuh, shared with flash_attention_bf16x3.cu.
#include "flash_attention_tc.cuh"

namespace {

__host__ __device__ constexpr size_t smem_bytes(int d, int bkv, int nwg) {
  return ALIGN + 2 * (size_t)d * (TILE_M * nwg + 2 * STAGES * bkv) + BAR_BYTES;
}

// The instantiated (D, block_kv, warpgroups): block_kv 64 and 128 at D up
// to 128; at D = 256 block_kv 64 with one warpgroup only.  There block_kv
// 128's CTA exceeds the 232,448 bytes a CTA can use, and two warpgroups
// (nine warps) hold a thread to 168 registers, where the 128 of the O
// accumulator spill (ptxas: 224 bytes).
constexpr bool built(int D, int bkv, int nwg) {
  return D == 256 ? bkv == 64 && nwg == 1
                  : (D == 32 || D == 64 || D == 96 || D == 128)
                        && (bkv == 64 || bkv == 128);
}

// --------------------------------------------------------------- kernel

// One CTA per (batch*head, q block): NWG consumer warpgroups of 64 q rows
// each, then one producer warp.  block_q is 128 with NWG = 2, and 64 or
// fewer rows (padded to 64) with NWG = 1.
template <int D, int BKV, int NWG>
__global__ void __launch_bounds__(NWG * WG + 32,
                                  NWG == 1 ? min_ctas(smem_bytes(D, BKV, 1))
                                           : 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ out, int sq,
                             int skv, int d, int bq, int causal,
                             int q_offset, float scale_log2) {
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
      out + ((int64_t)g * sq + first_q + wg * TILE_M) * d;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = acc_row(t, i), c = acc_col(t, i);
    if (wg * TILE_M + r < bq && c < d)    // c even, d a multiple of 8
      *reinterpret_cast<__nv_bfloat162*>(og + (int64_t)r * d + c) =
          __floats2bfloat162_rn(o[i] / l[(i >> 1) & 1],
                                o[i + 1] / l[(i >> 1) & 1]);
  }
}

// ----------------------------------------------------------------- host

template <int D, int BKV, int NWG>
int launch(const void* q, const void* k, const void* v, void* out,
           long long bh, int sq, int skv, int d, int bq, int causal,
           int q_offset, float scale, cudaStream_t stream) {
  if constexpr (!built(D, BKV, NWG)) {
    return (int)cudaErrorInvalidValue;
  } else {
    auto kernel = flash_attention_wgmma_kernel<D, BKV, NWG>;
    const size_t smem = smem_bytes(D, BKV, NWG);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    CUtensorMap qm, km, vm;
    if (!tensor_map<D>(&qm, q, bh * sq, bq < TILE_M ? bq : TILE_M, d)
        || !tensor_map<D>(&km, k, bh * skv, BKV, d)
        || !tensor_map<D>(&vm, v, bh * skv, BKV, d))
      return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)bh, (unsigned)(sq / bq));
    kernel<<<grid, NWG * WG + 32, smem, stream>>>(
        qm, km, vm, static_cast<__nv_bfloat16*>(out), sq, skv, d, bq,
        causal, q_offset, scale * LOG2E);
    return (int)cudaGetLastError();
  }
}

// D: an instantiated head dim (tc_head_dim)
bool instantiated(int D, int bkv, int bq) {
  return block_q_ok(bq) && built(D, bkv, bq > TILE_M ? 2 : 1);
}

}  // namespace

// The instantiated set's launch limits: dynamic shared memory and threads
// of one CTA; returns 0, or cudaErrorInvalidValue outside the set.
extern "C" int repro_flash_attention_wgmma_limits(int d, int bkv, int bq,
                                                  long long* smem,
                                                  int* threads) {
  const int D = tc_head_dim(d);
  if (!instantiated(D, bkv, bq)) return (int)cudaErrorInvalidValue;
  const int nwg = bq > TILE_M ? 2 : 1;
  *smem = (long long)smem_bytes(D, bkv, nwg);
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
  const int D = tc_head_dim(d);
  if (!instantiated(D, bkv, bq) || sq % bq || skv % bkv
      || (causal && q_offset < 0) || rows >= (1ll << 31)
      || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool two = bq > TILE_M;
#define REPRO_CASE(D_, BKV_)                                               \
  if (D == D_ && bkv == BKV_)                                              \
    return two ? launch<D_, BKV_, 2>(q, k, v, out, bh, sq, skv, d, bq,      \
                                     causal, q_offset, scale, st)          \
               : launch<D_, BKV_, 1>(q, k, v, out, bh, sq, skv, d, bq,      \
                                     causal, q_offset, scale, st);
  REPRO_CASE(32, 64)
  REPRO_CASE(32, 128)
  REPRO_CASE(64, 64)
  REPRO_CASE(64, 128)
  REPRO_CASE(96, 64)
  REPRO_CASE(96, 128)
  REPRO_CASE(128, 64)
  REPRO_CASE(128, 128)
  REPRO_CASE(256, 64)
#undef REPRO_CASE
  return (int)cudaErrorInvalidValue;
}
