// Float32 flash attention on Hopper's tensor cores as three bf16 passes,
// sm_90a: a split pass, then wgmma on bf16 hi/lo tiles fed by TMA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel /
// flash_attention() (pl.pallas_call at line 150) for float32 inputs at the
// instantiated shapes, and computes what it computes: for each
// (batch*head, query row),
//   s = (q . k^T) * scale, scale = 1/sqrt(d);
//   causal: s = -2^30 where q_pos + q_offset < k_pos;
//   online softmax over kv blocks (m, l, alpha);
//   out = acc / max(l, 1e-30), stored in fp32.
// Causal kv blocks wholly above the diagonal are not visited: the rule of
// the Pallas kernel's pl.when, of flash_attention_wgmma.cu and of the
// tuner's FlashAttentionSpace._steps.
//
// Numerics.  The reference multiplies in f32 and its f32 tolerance is
// 2e-3.  One bf16 pass (8 mantissa bits) misses that, and one TF32 pass
// (10 bits) misses it once the logits grow.  As the TPU's matrix unit does
// for f32 at JAX's Precision.HIGH, each f32 operand x is split into
// hi = bf16(x) and lo = bf16(x - hi), and a product a . b is taken as
// hi_a . hi_b + hi_a . lo_b + lo_a . hi_b, summed in the fp32 accumulator:
// about 16 mantissa bits (lo_a . lo_b, below 2^-16 relative, is dropped).
// Both products do this: S = Qh.Kh^T + Qh.Kl^T + Ql.Kh^T, and, with p split
// in registers after the softmax, O += Ph.Vh + Ph.Vl + Pl.Vh.  l sums the
// unrounded fp32 p.  tests/test_torch_flash.py emulates exactly this and
// holds it to the reference at its f32 tolerance.
//
// The split pass (repro_flash_attention_bf16x3_split) reads q, k and v
// once and writes hi and lo for each, as many bytes as it reads; it
// rounds with __float2bfloat16_rn, so hi is bit-identical to torch's
// .bfloat16().  It is bound by bytes: 16-byte loads and 8-byte stores in
// a grid-stride loop.  Fusing it into the attention kernel (fp32 tiles by
// TMA, split in shared memory) is later work.
//
// What bounds the attention kernel on the H100: operations, three times
// the bf16 kernel's, at the bf16 rate (989 TFLOP/s, against 67 on the
// fp32 CUDA cores).  The design is the bf16 kernel's
// (flash_attention_wgmma.cu): a producer warp keeps K/V tiles in flight by
// TMA through a ring of STAGES full/empty mbarrier pairs; consumer
// warpgroups each own a 64-row q tile (block_q 128: two); S and P stay in
// registers; V is read as it lies through wgmma's B-transpose bit; q
// blocks below 64 rows run in a zero-filled 64-row tile and store only
// their rows; a lost mbarrier phase traps.  What changes: every tile is a
// hi and a lo tile, so shared memory doubles and, at d = 128, one CTA
// fills an SM (no second resident CTA hides the softmax); the P fragments
// are split in registers into a hi and a lo set; the epilogue stores fp32
// pairs.
//
// Launch limits (mirrored by repro_torch.kernels.flash_attention
// .launch_limits, which every caller reads, and reported by
// repro_flash_attention_bf16x3_limits below): D in {32, 64, 96, 128}
// with block_kv in {64, 128}, and D = 256 with block_kv 32, block_q in
// {4, 8, 16, 32, 64, 128}, where the CTA's dynamic shared memory
//   1024 (alignment) + 4 * D * (64 * warpgroups + 2 * STAGES * block_kv)
//   + 64 (barriers) bytes
// fits the 232,448 bytes a CTA can use: at D = 128 only block_kv 64, at
// D = 96 block_kv 128 only with one warpgroup, at D = 256 only block_q up
// to 64 (197,696 bytes; S of block_kv 32 is one m64n32k16 wgmma per
// pass).  Only triples that fit are instantiated.  A head dim d between
// the instantiated ones runs D = tc_head_dim(d) with zero columns, as in
// flash_attention_wgmma.cu; the split pass is elementwise and writes hi
// and lo at d.  128 threads per consumer warpgroup plus a producer warp.
//
// C interface (bound with ctypes): repro_flash_attention_bf16x3_split(...)
// and repro_flash_attention_bf16x3(...) launch on the given stream, do not
// synchronise, and return cudaGetLastError().  The panel layout,
// descriptors, PTX wrappers and TMA encoding are in flash_attention_tc.cuh,
// shared with flash_attention_wgmma.cu.
#include "flash_attention_tc.cuh"

namespace {

constexpr size_t SMEM_MAX = 232448;   // dynamic shared memory a CTA can use
constexpr int SPLIT_THREADS = 256;

__host__ __device__ constexpr size_t smem_bytes(int d, int bkv, int nwg) {
  return ALIGN + 4 * (size_t)d * (TILE_M * nwg + 2 * STAGES * bkv) + BAR_BYTES;
}

// The instantiated (D, block_kv, warpgroups): those of the bf16 kernel
// whose CTA fits the bytes a CTA can use, and at D = 256 block_kv 32 (64
// does not fit), which fits with one warpgroup only.
constexpr bool built(int D, int bkv, int nwg) {
  return (D == 256 ? bkv == 32
                   : (D == 32 || D == 64 || D == 96 || D == 128)
                         && (bkv == 64 || bkv == 128))
         && smem_bytes(D, bkv, nwg) <= SMEM_MAX;
}

// hi = bf16(a), lo = bf16(a - hi) for a pair (a, b), each packed as bf16x2
// with a in the low half.  a - float(hi) is exact in fp32.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------------- split

struct SplitArgs {
  const float4* x[3];
  uint2* hi[3];
  uint2* lo[3];
  long long n4[3];                    // float4 words of each tensor
};

// blockIdx.y picks q, k or v; a grid-stride loop over its float4 words
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kernel(const __grid_constant__ SplitArgs a) {
  const int t = blockIdx.y;
  const float4* __restrict__ x = a.x[t];
  uint2* __restrict__ hi = a.hi[t];
  uint2* __restrict__ lo = a.lo[t];
  const long long n = a.n4[t];
  for (long long i = blockIdx.x * (long long)SPLIT_THREADS + threadIdx.x;
       i < n; i += (long long)gridDim.x * SPLIT_THREADS) {
    const float4 v = x[i];
    uint2 h, l;
    split2(v.x, v.y, h.x, l.x);
    split2(v.z, v.w, h.y, l.y);
    hi[i] = h;
    lo[i] = l;
  }
}

// --------------------------------------------------------------- kernel

// One CTA per (batch*head, q block): NWG consumer warpgroups of 64 q rows
// each, then one producer warp.  Shared memory: per warpgroup a q hi tile
// then a q lo tile; per ring stage k hi, k lo, v hi, v lo; the mbarriers.
template <int D, int BKV, int NWG>
__global__ void __launch_bounds__(NWG * WG + 32, 1)
flash_attention_bf16x3_kernel(const __grid_constant__ CUtensorMap qh_map,
                              const __grid_constant__ CUtensorMap ql_map,
                              const __grid_constant__ CUtensorMap kh_map,
                              const __grid_constant__ CUtensorMap kl_map,
                              const __grid_constant__ CUtensorMap vh_map,
                              const __grid_constant__ CUtensorMap vl_map,
                              float* __restrict__ out, int sq, int skv,
                              int d, int bq, int causal, int q_offset,
                              float scale_log2) {
  using P = Panel<D>;
  constexpr int THREADS = NWG * WG + 32;
  constexpr int Q_TILE = TILE_M * D * 2;      // bytes of one bf16 q tile
  constexpr int KV_TILE = BKV * D * 2;        // bytes of one bf16 k or v tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~uint32_t(ALIGN - 1);
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;                           // NWG x (hi, lo)
  const uint32_t kv_s = base + NWG * 2 * Q_TILE;       // stage: kh kl vh vl
  const uint32_t bars = kv_s + STAGES * 4 * KV_TILE;
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

  if (bq < TILE_M) {  // rows [bq, 64) of each panel of the q hi and lo
    constexpr int PANEL = TILE_M * P::ROW;             // tiles: zero once
    const int n16 = (TILE_M - bq) * P::ROW / 16;       // 16-byte words
    for (int idx = tid; idx < 2 * P::N * n16; idx += THREADS) {
      const int p = idx / n16, w = idx % n16;          // hi panels, then lo
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
      mbar_expect_tx(qbar, 2 * bq * D * 2);
      for (int w = 0; w < NWG; ++w)
        for (int p = 0; p < P::N; ++p) {
          const uint32_t dst = q_s + w * 2 * Q_TILE + p * TILE_M * P::ROW;
          const int row = g * sq + first_q + w * TILE_M;
          tma_load(dst, &qh_map, qbar, p * P::W, row);
          tma_load(dst + Q_TILE, &ql_map, qbar, p * P::W, row);
        }
      for (int ki = 0; ki < visit; ++ki) {
        const int s = ki % STAGES;
        if (ki >= STAGES) mbar_wait(empty(s), (ki / STAGES - 1) & 1);
        mbar_expect_tx(full(s), 4 * KV_TILE);
        const uint32_t kh_t = kv_s + s * 4 * KV_TILE;
        const int row = g * skv + ki * BKV;
        for (int p = 0; p < P::N; ++p) {
          const uint32_t off = p * BKV * P::ROW;
          tma_load(kh_t + off, &kh_map, full(s), p * P::W, row);
          tma_load(kh_t + KV_TILE + off, &kl_map, full(s), p * P::W, row);
          tma_load(kh_t + 2 * KV_TILE + off, &vh_map, full(s), p * P::W, row);
          tma_load(kh_t + 3 * KV_TILE + off, &vl_map, full(s), p * P::W, row);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows [64*wg, 64*wg + 64) of the block
  const int wg = tid / WG, t = tid % WG;
  const uint32_t qh_t = q_s + wg * 2 * Q_TILE, ql_t = qh_t + Q_TILE;
  const int row0 = first_q + wg * TILE_M + q_offset;   // q_pos of tile row 0
  float s_acc[BKV / 2], o[D / 2];
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t ph[BKV / 16][4], pl[BKV / 16][4];

  mbar_wait(qbar, 0);
  for (int ki = 0; ki < visit; ++ki) {
    const int s = ki % STAGES;
    mbar_wait(full(s), (ki / STAGES) & 1);
    const uint32_t kh_t = kv_s + s * 4 * KV_TILE, kl_t = kh_t + KV_TILE;
    const uint32_t vh_t = kh_t + 2 * KV_TILE, vl_t = kh_t + 3 * KV_TILE;

    // S = Qh.Kh^T + Qh.Kl^T + Ql.Kh^T: three chains, one fp32 accumulator
    hold(s_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t qh = kmajor<D>(qh_t, TILE_M, kk);
      const uint64_t kh = kmajor<D>(kh_t, BKV, kk);
      mma_ss<BKV>(s_acc, qh, kh, kk > 0);
      mma_ss<BKV>(s_acc, qh, kmajor<D>(kl_t, BKV, kk), 1);
      mma_ss<BKV>(s_acc, kmajor<D>(ql_t, TILE_M, kk), kh, 1);
    }
    wg_commit();
    wg_wait0();
    hold(s_acc);

    // online softmax in registers, base 2, as in the bf16 kernel
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
    // the S accumulator of k16 chunk c, split into the hi and lo bf16 A
    // fragments of P . V
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split2(s_acc[8 * c + 2 * r], s_acc[8 * c + 2 * r + 1], ph[c][r],
               pl[c][r]);

    // O += Ph.Vh + Ph.Vl + Pl.Vh, P from registers, V as it lies
    hold(o);
    hold(ph);
    hold(pl);
    wg_fence();
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) {
      const uint64_t vh = mnmajor<D, BKV>(vh_t, c);
      mma_rs<D>(o, ph[c], vh, 1);
      mma_rs<D>(o, ph[c], mnmajor<D, BKV>(vl_t, c), 1);
      mma_rs<D>(o, pl[c], vh, 1);
    }
    wg_commit();
    wg_wait0();
    hold(o);
    hold(ph);
    hold(pl);
    mbar_arrive(empty(s));
  }

  // out = o / max(l, 1e-30): the row sum across the quad, then fp32 pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  float* const og = out + ((int64_t)g * sq + first_q + wg * TILE_M) * d;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = acc_row(t, i), c = acc_col(t, i);
    if (wg * TILE_M + r < bq && c < d)    // c even, d a multiple of 8
      *reinterpret_cast<float2*>(og + (int64_t)r * d + c) =
          make_float2(o[i] / l[(i >> 1) & 1], o[i + 1] / l[(i >> 1) & 1]);
  }
}

// ----------------------------------------------------------------- host

// ptr: qh, ql, kh, kl, vh, vl
template <int D, int BKV, int NWG>
int launch(const void* const* ptr, void* out, long long bh, int sq, int skv,
           int d, int bq, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  if constexpr (!built(D, BKV, NWG)) {
    return (int)cudaErrorInvalidValue;
  } else {
    auto kernel = flash_attention_bf16x3_kernel<D, BKV, NWG>;
    const size_t smem = smem_bytes(D, BKV, NWG);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    CUtensorMap m[6];
    const int qbox = bq < TILE_M ? bq : TILE_M;
    for (int i = 0; i < 6; ++i)
      if (!tensor_map<D>(&m[i], ptr[i], bh * (i < 2 ? sq : skv),
                         i < 2 ? qbox : BKV, d))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)bh, (unsigned)(sq / bq));
    kernel<<<grid, NWG * WG + 32, smem, stream>>>(
        m[0], m[1], m[2], m[3], m[4], m[5], static_cast<float*>(out), sq,
        skv, d, bq, causal, q_offset, scale * LOG2E);
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
extern "C" int repro_flash_attention_bf16x3_limits(int d, int bkv, int bq,
                                                   long long* smem,
                                                   int* threads) {
  const int D = tc_head_dim(d);
  if (!instantiated(D, bkv, bq)) return (int)cudaErrorInvalidValue;
  const int nwg = bq > TILE_M ? 2 : 1;
  *smem = (long long)smem_bytes(D, bkv, nwg);
  *threads = nwg * WG + 32;
  return (int)cudaSuccess;
}

// fp32 q (nq elements), k and v (nkv each), contiguous, 16-byte aligned,
// counts multiples of 4; writes bf16 hi and lo tensors of the same sizes.
extern "C" int repro_flash_attention_bf16x3_split(
    const void* q, const void* k, const void* v, void* qh, void* ql,
    void* kh, void* kl, void* vh, void* vl, long long nq, long long nkv,
    void* stream) {
  if (nq % 4 || nkv % 4 || nq < 0 || nkv < 0
      || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)qh
          | (uintptr_t)ql | (uintptr_t)kh | (uintptr_t)kl | (uintptr_t)vh
          | (uintptr_t)vl) % 16)
    return (int)cudaErrorInvalidValue;
  const long long most = (nq > nkv ? nq : nkv) / 4;
  if (most == 0) return (int)cudaSuccess;
  SplitArgs a;
  const void* xs[3] = {q, k, v};
  void* his[3] = {qh, kh, vh};
  void* los[3] = {ql, kl, vl};
  for (int i = 0; i < 3; ++i) {
    a.x[i] = static_cast<const float4*>(xs[i]);
    a.hi[i] = static_cast<uint2*>(his[i]);
    a.lo[i] = static_cast<uint2*>(los[i]);
    a.n4[i] = (i == 0 ? nq : nkv) / 4;
  }
  // enough CTAs to fill the card several times over; the loop strides
  long long blocks = (most + SPLIT_THREADS - 1) / SPLIT_THREADS;
  if (blocks > 2048) blocks = 2048;
  split_kernel<<<dim3((unsigned)blocks, 3), SPLIT_THREADS, 0,
                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16 hi/lo halves of fp32 q (bh, sq, d), k and v (bh, skv, d); fp32 out
// (bh, sq, d); contiguous.  The wrapper has checked shapes, divisibility,
// the instantiated set and alignment; the checks here only keep a bad
// call from launching.
extern "C" int repro_flash_attention_bf16x3(
    const void* qh, const void* ql, const void* kh, const void* kl,
    const void* vh, const void* vl, void* out, long long bh, int sq,
    int skv, int d, int bq, int bkv, int causal, int q_offset, float scale,
    void* stream) {
  if (bh <= 0 || sq <= 0) return (int)cudaSuccess;
  const long long rows = bh * (sq > skv ? sq : skv);
  const void* ptr[6] = {qh, ql, kh, kl, vh, vl};
  uintptr_t align = (uintptr_t)out;
  for (int i = 0; i < 6; ++i) align |= (uintptr_t)ptr[i];
  const int D = tc_head_dim(d);
  if (!instantiated(D, bkv, bq) || sq % bq || skv % bkv
      || (causal && q_offset < 0) || rows >= (1ll << 31) || align % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool two = bq > TILE_M;
#define REPRO_CASE(D_, BKV_)                                                 \
  if (D == D_ && bkv == BKV_)                                                \
    return two ? launch<D_, BKV_, 2>(ptr, out, bh, sq, skv, d, bq, causal,   \
                                     q_offset, scale, st)                    \
               : launch<D_, BKV_, 1>(ptr, out, bh, sq, skv, d, bq, causal,   \
                                     q_offset, scale, st);
  REPRO_CASE(32, 64)
  REPRO_CASE(32, 128)
  REPRO_CASE(64, 64)
  REPRO_CASE(64, 128)
  REPRO_CASE(96, 64)
  REPRO_CASE(96, 128)
  REPRO_CASE(128, 64)
  REPRO_CASE(128, 128)
  REPRO_CASE(256, 32)
#undef REPRO_CASE
  return (int)cudaErrorInvalidValue;
}
