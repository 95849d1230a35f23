// Gradient of blocked (flash) attention on Hopper's tensor cores, sm_90a:
// dQ, dK and dV of softmax attention for bf16 operands, with wgmma on bf16
// tiles fed by TMA through a shared-memory ring.
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
// A operand of dV, and dS as the A operand of dQ and dK.
// tests/test_torch_flash_backward.py emulates exactly this and holds it
// to jax.grad of the JAX reference at the bf16 tolerance, 2e-2 of each
// gradient's largest entry.  The softmax runs in the base-2 domain
// (s * scale * log2(e), exp2f), and LSE is kept there.
//
// Causal blocks wholly above the diagonal are not visited, by the
// forward's rule (flash_attention_wgmma.cu): the pair (q block of rows
// [q0, q0 + bq), kv block of keys [k0, k0 + 64)) is visited iff
//   k0 <= q0 + bq - 1 + q_offset,
// its first key at or before its last query's position.  Both kernels
// below visit exactly those pairs, so masked-out blocks (P = 0 exactly)
// cost nothing.
//
// What bounds it on the H100: operations.  Five products of 2*d flops per
// visible (query, key) pair are needed (S, dP, dV, dQ, dK: 10*d), against
// q, k, v, dO, dq, dk and dv moving once: at d = 128 hundreds of flops
// per byte.  The design recomputes S and dP in each of two kernels, so
// deterministic sums need no atomics:
// (a) dQ kernel, one CTA per (batch*head, 64 q rows), one consumer
//     warpgroup and a producer warp.  Q and dO are loaded once; K and V
//     stream through a ring of STAGES stages twice.  Sweep 1: S = Q . K^T
//     and dP = dO . V^T (both operands K-major from shared memory), the
//     online max and sum of exp(S) and, rescaled by the same factors, the
//     sum of exp(S) * dP, so that LSE and D come out of one sweep.
//     Sweep 2: S and dP again, P from LSE, dS, then dQ += dS . K with dS
//     from registers (the accumulator's m64nN layout is the A fragment's,
//     as P is in the forward) and K MN-major through the transpose bit.
//     It writes LSE and D (fp32, b*h*sq each) for (b) and dQ.
// (b) dK/dV kernel, one CTA per (batch*head, 64 kv rows), in the
//     transposed orientation: S^T = K . Q^T and dP^T = V . dO^T, so that
//     P^T and dS^T lie in registers as the A operands of dV += P^T . dO
//     and dK += dS^T . Q (dO and Q MN-major).  K and V are loaded once;
//     Q, dO and their rows' LSE and D (a bulk copy each) stream through
//     the ring, 64 q rows a step.  At D = 96 and 128 the dK and dV
//     accumulators (D registers a thread) and S^T and dP^T need more than
//     the 168 registers a thread gets with two 5-warp CTAs on an SM: one
//     CTA per SM there, with 255.  (On the H100, 32 q rows a step with
//     two CTAs spilled at D = 128 and ran slower than this at granite's
//     shape.)
// Nine products of 2*d flops a visible pair in all (10*d needed, 18*d
// done).  No warp specialisation beyond the producer warp, no register
// reallocation, no persistent grid: later work.
//
// Head dims between the instantiated ones (a multiple of 8 up to 128)
// run at D = tc_head_dim(d), the columns past d zero-filled by TMA, as in
// the forward; the outputs store the first d columns.
//
// Launch limits (mirrored by repro_torch.kernels.flash_attention
// .backward_launch_limits, and reported by
// repro_flash_attention_bwd_limits below): D in {32, 64, 96, 128}; sq and
// skv multiples of 64; q_offset >= 0; 160 threads a CTA; dynamic shared
// memory
//   (a) 1024 + 2 * D * (2 * 64 + 2 * STAGES * 64) + 64 bytes,
//   (b) 1024 + 2 * D * (2 * 64 + 2 * STAGES * 64) + 8 * STAGES * 64 + 64,
// opted in above 48 KB.  Operands start on 16 bytes.
//
// C interface (bound with ctypes): repro_flash_attention_bwd(...) encodes
// the TMA descriptors on the host, launches (a) then (b) on the given
// stream, does not synchronise, and returns cudaGetLastError().
#include "flash_attention_tc.cuh"

namespace {

constexpr int BM = 64;   // rows of every tile: q rows of a dQ CTA and
                         // of a dK/dV CTA's step, kv rows of a dK/dV CTA
                         // and of a dQ CTA's step

__host__ __device__ constexpr size_t dq_smem(int D) {
  return ALIGN + 2 * (size_t)D * (2 * BM + 2 * STAGES * BM) + BAR_BYTES;
}

__host__ __device__ constexpr size_t dkv_smem(int D) {
  return dq_smem(D) + 8 * STAGES * BM;
}

// CTAs per SM the dK/dV kernel asks registers for (see the header)
constexpr int dkv_ctas(int D) { return D <= 64 ? min_ctas(dkv_smem(D)) : 1; }

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

// Issue S = A . B^T and dP = A2 . B2^T for one tile pair (all four
// operands K-major in shared memory) and wait for both.
template <int D, int N>
__device__ __forceinline__ void two_products(float (&s)[N / 2],
                                             float (&dp)[N / 2], uint32_t a,
                                             uint32_t b, uint32_t a2,
                                             uint32_t b2) {
  hold(s);
  hold(dp);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss<N>(s, kmajor<D>(a, BM, kk), kmajor<D>(b, N, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss<N>(dp, kmajor<D>(a2, BM, kk), kmajor<D>(b2, N, kk), kk > 0);
  wg_commit();
  wg_wait0();
  hold(s);
  hold(dp);
}

// The fp32 accumulator of a 64 x N product as the bf16 A fragments of its
// k16 chunks: registers 8c..8c+7 in pairs (the forward's P -> A step).
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&x)[N / 2]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[c][r] = pack_bf16(x[8 * c + 2 * r], x[8 * c + 2 * r + 1]);
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

// --------------------------------------------------------------- (a) dQ

template <int D>
__global__ void __launch_bounds__(WG + 32, min_ctas(dq_smem(D)))
flash_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap omap,
                              __nv_bfloat16* __restrict__ dq,
                              float* __restrict__ lse,
                              float* __restrict__ dsum, int sq, int skv,
                              int d, int causal, int q_offset, float scale,
                              float scale_log2) {
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
  const int first_q = qi * BM;
  const int nk = skv / BM;
  const int visit = causal ? min(nk, (first_q + q_offset + BM - 1) / BM + 1)
                           : nk;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG) {  // producer warp: one lane issues every copy
    if (tid == WG) {
      mbar_expect_tx(qbar, 2 * TILE);
      for (int p = 0; p < P::N; ++p) {
        tma_load(q_s + p * BM * P::ROW, &qmap, qbar, p * P::W,
                 g * sq + first_q);
        tma_load(o_s + p * BM * P::ROW, &omap, qbar, p * P::W,
                 g * sq + first_q);
      }
      for (int it = 0; it < 2 * visit; ++it) {   // K and V, twice
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), (it / STAGES - 1) & 1);
        mbar_expect_tx(full(s), 2 * TILE);
        const uint32_t k_t = kv_s + s * 2 * TILE, v_t = k_t + TILE;
        const int row = g * skv + (it < visit ? it : it - visit) * BM;
        for (int p = 0; p < P::N; ++p) {
          tma_load(k_t + p * BM * P::ROW, &kmap, full(s), p * P::W, row);
          tma_load(v_t + p * BM * P::ROW, &vmap, full(s), p * P::W, row);
        }
      }
    }
    return;
  }

  const int t = tid;
  const int row0 = first_q + q_offset;           // q_pos of tile row 0
  float s_acc[BM / 2], dp[BM / 2], dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) s_acc[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  // per thread's two rows (acc_row(t, 0) and +8): the running max, the
  // sum of exp and the sum of exp * dP, both rescaled on a new max
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  // sweep 1: LSE and D
  for (int it = 0; it < visit; ++it) {
    const int s = it % STAGES;
    mbar_wait(full(s), (it / STAGES) & 1);
    const uint32_t k_t = kv_s + s * 2 * TILE, v_t = k_t + TILE;
    two_products<D, BM>(s_acc, dp, q_s, k_t, o_s, v_t);
    mbar_arrive(empty(s));

    const int k0 = it * BM;
    const bool diag = causal && k0 + BM - 1 > row0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      float x = s_acc[i] * scale_log2;
      if (diag && row0 + acc_row(t, i) < k0 + acc_col(t, i)) x = NEG_INF;
      s_acc[i] = x;
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
      const float p = exp2f(s_acc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += p;
      dd[(i >> 1) & 1] += p * dp[i];
    }
  }
  // the row sums across the quad; LSE (base 2) and D of the two rows
  float lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    dd[h] += __shfl_xor_sync(0xffffffffu, dd[h], 1);
    dd[h] += __shfl_xor_sync(0xffffffffu, dd[h], 2);
    lse2[h] = m[h] + log2f(l[h]);
    dd[h] /= l[h];
  }
  if (t % 4 == 0) {
    const int64_t r = (int64_t)g * sq + first_q + acc_row(t, 0);
    lse[r] = lse2[0];
    lse[r + 8] = lse2[1];
    dsum[r] = dd[0];
    dsum[r + 8] = dd[1];
  }

  // sweep 2: dS, and dQ += dS . K
  uint32_t da[BM / 16][4];
  for (int it = visit; it < 2 * visit; ++it) {
    const int s = it % STAGES;
    mbar_wait(full(s), (it / STAGES) & 1);
    const uint32_t k_t = kv_s + s * 2 * TILE, v_t = k_t + TILE;
    two_products<D, BM>(s_acc, dp, q_s, k_t, o_s, v_t);

    const int k0 = (it - visit) * BM;
    const bool diag = causal && k0 + BM - 1 > row0;
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const int h = (i >> 1) & 1;
      const bool masked =
          diag && row0 + acc_row(t, i) < k0 + acc_col(t, i);
      const float p = masked ? 0.f : exp2f(s_acc[i] * scale_log2 - lse2[h]);
      s_acc[i] = p * (dp[i] - dd[h]);
    }
    to_a<BM>(da, s_acc);
    hold(dq_acc);
    hold(da);
    wg_fence();
#pragma unroll
    for (int c = 0; c < BM / 16; ++c)
      mma_rs<D>(dq_acc, da[c], mnmajor<D, BM>(k_t, c), 1);
    wg_commit();
    wg_wait0();
    hold(dq_acc);
    hold(da);
    mbar_arrive(empty(s));
  }
  store_rows<D>(dq + ((int64_t)g * sq + first_q) * d, d, dq_acc, scale, t);
}

// ------------------------------------------------------------ (b) dK, dV

template <int D>
__global__ void __launch_bounds__(WG + 32, dkv_ctas(D))
flash_attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap omap,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv,
                               const float* __restrict__ lse,
                               const float* __restrict__ dsum, int sq,
                               int skv, int d, int causal, int q_offset,
                               float scale, float scale_log2) {
  using P = Panel<D>;
  constexpr int N = BM;                     // q rows a step
  constexpr int KV_TILE = BM * D * 2;
  constexpr int Q_TILE = N * D * 2;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~uint32_t(ALIGN - 1);
  const uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + KV_TILE;
  const uint32_t ring = base + 2 * KV_TILE;            // stage: q, then dO
  const uint32_t rows_s = ring + STAGES * 2 * Q_TILE;  // stage: LSE, then D
  const uint32_t bars = rows_s + STAGES * 8 * N;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t kvbar = bars + 8 * 2 * STAGES;

  const int g = blockIdx.x;                             // batch * head
  const int k0 = blockIdx.y * BM;
  const int nq = sq / N;
  // the first q block that sees key k0: q0 + N - 1 + q_offset >= k0
  const int need = k0 - q_offset - (N - 1);
  const int first = causal && need > 0 ? (need + N - 1) / N : 0;
  const int count = nq > first ? nq - first : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG) {  // producer warp
    if (tid == WG) {
      mbar_expect_tx(kvbar, 2 * KV_TILE);
      for (int p = 0; p < P::N; ++p) {
        tma_load(k_s + p * BM * P::ROW, &kmap, kvbar, p * P::W, g * skv + k0);
        tma_load(v_s + p * BM * P::ROW, &vmap, kvbar, p * P::W, g * skv + k0);
      }
      for (int it = 0; it < count; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), (it / STAGES - 1) & 1);
        mbar_expect_tx(full(s), 2 * Q_TILE + 8 * N);
        const uint32_t q_t = ring + s * 2 * Q_TILE, o_t = q_t + Q_TILE;
        const int row = g * sq + (first + it) * N;
        for (int p = 0; p < P::N; ++p) {
          tma_load(q_t + p * N * P::ROW, &qmap, full(s), p * P::W, row);
          tma_load(o_t + p * N * P::ROW, &omap, full(s), p * P::W, row);
        }
        const uint32_t r_t = rows_s + s * 8 * N;
        bulk_load(r_t, lse + row, 4 * N, full(s));
        bulk_load(r_t + 4 * N, dsum + row, 4 * N, full(s));
      }
    }
    return;
  }

  const int t = tid;
  float st[N / 2], dpt[N / 2], dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  uint32_t pa[N / 16][4], da[N / 16][4];

  mbar_wait(kvbar, 0);
  for (int it = 0; it < count; ++it) {
    const int s = it % STAGES;
    mbar_wait(full(s), (it / STAGES) & 1);
    const uint32_t q_t = ring + s * 2 * Q_TILE, o_t = q_t + Q_TILE;
    const float* const lse_s =
        reinterpret_cast<const float*>(gbase + (rows_s + s * 8 * N - base));
    const float* const d_s = lse_s + N;
    // S^T = K . Q^T, dP^T = V . dO^T: rows are keys, columns queries
    two_products<D, N>(st, dpt, k_s, q_t, v_s, o_t);

    const int q0 = (first + it) * N + q_offset;   // q_pos of column 0
    const bool diag = causal && k0 + BM - 1 > q0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int c = acc_col(t, i);
      const bool masked = diag && k0 + acc_row(t, i) > q0 + c;
      const float p = masked ? 0.f : exp2f(st[i] * scale_log2 - lse_s[c]);
      st[i] = p;
      dpt[i] = p * (dpt[i] - d_s[c]);
    }
    to_a<N>(pa, st);
    to_a<N>(da, dpt);
    hold(dv_acc);
    hold(dk_acc);
    hold(pa);
    hold(da);
    wg_fence();
#pragma unroll
    for (int c = 0; c < N / 16; ++c)
      mma_rs<D>(dv_acc, pa[c], mnmajor<D, N>(o_t, c), 1);
#pragma unroll
    for (int c = 0; c < N / 16; ++c)
      mma_rs<D>(dk_acc, da[c], mnmajor<D, N>(q_t, c), 1);
    wg_commit();
    wg_wait0();
    hold(dv_acc);
    hold(dk_acc);
    hold(pa);
    hold(da);
    mbar_arrive(empty(s));
  }
  const int64_t out = ((int64_t)g * skv + k0) * d;
  store_rows<D>(dk + out, d, dk_acc, scale, t);
  store_rows<D>(dv + out, d, dv_acc, 1.f, t);
}

// ----------------------------------------------------------------- host

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* dsum,
           long long bh, int sq, int skv, int d, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  auto ka = flash_attention_bwd_dq_kernel<D>;
  auto kb = flash_attention_bwd_dkv_kernel<D>;
  const size_t sa = dq_smem(D), sb = dkv_smem(D);
  cudaError_t e = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sb);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qm, km, vm, om;
  if (!tensor_map<D>(&qm, q, bh * sq, BM, d)
      || !tensor_map<D>(&om, dout, bh * sq, BM, d)
      || !tensor_map<D>(&km, k, bh * skv, BM, d)
      || !tensor_map<D>(&vm, v, bh * skv, BM, d))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * LOG2E;
  ka<<<dim3((unsigned)bh, (unsigned)(sq / BM)), WG + 32, sa, stream>>>(
      qm, km, vm, om, static_cast<__nv_bfloat16*>(dq), lse, dsum, sq, skv, d,
      causal, q_offset, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kb<<<dim3((unsigned)bh, (unsigned)(skv / BM)), WG + 32, sb, stream>>>(
      qm, km, vm, om, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), lse, dsum, sq, skv, d, causal,
      q_offset, scale, scale_log2);
  return (int)cudaGetLastError();
}

// D: an instantiated head dim (tc_head_dim) the backward is built for
bool bwd_built(int D) { return D == 32 || D == 64 || D == 96 || D == 128; }

}  // namespace

// The launch limits at head dim d: dynamic shared memory of the dQ and
// the dK/dV CTAs and threads of each; returns 0, or
// cudaErrorInvalidValue for a head dim it is not built for.
extern "C" int repro_flash_attention_bwd_limits(int d, long long* smem_dq,
                                                long long* smem_dkv,
                                                int* threads) {
  const int D = tc_head_dim(d);
  if (!bwd_built(D)) return (int)cudaErrorInvalidValue;
  *smem_dq = (long long)dq_smem(D);
  *smem_dkv = (long long)dkv_smem(D);
  *threads = WG + 32;
  return (int)cudaSuccess;
}

// bf16 q and dout (bh, sq, d), k and v (bh, skv, d); dq, dk, dv of their
// operands' shapes; lse and dsum fp32 scratch of bh * sq; all contiguous.
// The wrapper has checked shapes, types and alignment; the checks here
// only keep a bad call from launching.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         void* dq, void* dk, void* dv,
                                         void* lse, void* dsum, long long bh,
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
          | (uintptr_t)dsum) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  float* ds = static_cast<float*>(dsum);
#define REPRO_CASE(D_)                                                      \
  if (D == D_)                                                              \
    return launch<D_>(q, k, v, dout, dq, dk, dv, l, ds, bh, sq, skv, d,     \
                      causal, q_offset, scale, st);
  REPRO_CASE(32)
  REPRO_CASE(64)
  REPRO_CASE(96)
  REPRO_CASE(128)
#undef REPRO_CASE
  return (int)cudaErrorInvalidValue;
}
