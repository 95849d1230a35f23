// Blocked online-softmax (flash) attention on the CUDA cores of Hopper,
// sm_90a: the "simt" route, exact fp32 products.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel /
// flash_attention() (pl.pallas_call at line 150), and computes what it
// computes: for each (batch*head, query row),
//   s = (q . k^T) * scale, scale = 1/sqrt(d), in fp32;
//   causal: s = -2^30 where q_pos + q_offset < k_pos;
//   online softmax over kv blocks: m = max(m, rowmax s),
//   alpha = exp(m_prev - m), p = exp(s - m), l = l*alpha + sum p,
//   acc = acc*alpha + p . v;
//   out = acc / max(l, 1e-30), rounded to the input type.
// Inputs are float32 or bfloat16 (converted exactly to fp32 on the way
// into shared memory); every product and sum is fp32 on the CUDA cores.
// Causal kv blocks wholly above the diagonal are not visited: the kv loop
// of q block qi stops at
//   min(nk, (qi*block_q + q_offset + block_q - 1) / block_kv + 1),
// the visit rule of the Pallas kernel's pl.when and of the tuner's
// FlashAttentionSpace._steps.
//
// What bounds it on the H100: operations, on the FP32 pipes (67 TFLOP/s,
// 128 FMA lanes an SM a clock): attention does 4*d flops per visible
// (query, key) pair against 4 tensors that each move once, hundreds of
// flops per byte at d = 128.  The pipes are fed from shared memory.  On
// the card a warp's 16-byte shared load costs one clock of the SM's
// shared pipe per 8 distinct addresses (broadcast is free), and, more
// than that, issue slots beside the FFMAs it feeds: about six FFMAs'
// worth each, so a product runs at TM*TN*4 / (TM*TN*4 + 6*(TM + TN)) of
// the FFMA rate for a TM x TN register tile.  The first kernel (kept
// below as the general kernel) kept its output accumulator in
// shared memory (read and written whole every kv step), read two float4
// per 16 FMAs, staged k and v synchronously through registers with k
// transposed by scalar stores, ran the softmax one warp a row while the
// CTA waited, and crossed four CTA barriers a kv step: 26% of the FP32
// floor at granite-8b's shape.
//
// The design ("tiled" kernel, compile-time tiles, Tile below):
//  - 256 threads, 8 warps, one CTA an SM.  A warp owns WM query rows (16
//    at D = 128, 8 at 256) and one slice of each kv block: the whole block
//    when the warps cover block_q with their rows, else 1/WCG of it.  S =
//    q.k^T and the output have layouts of their own over the warp's
//    lanes: S as LRS rows x 32/LRS kv columns (4 x 8 at D = 128, a thread
//    holding 4 x 4 scores at (128, 32)), the output as LRO rows x 32/LRO
//    float4 chunks (2 x 16, a thread holding 8 x 8 at D = 128).
//  - The output accumulator, m and l stay in registers for the whole kv
//    loop (l as each lane's partial sum, reduced once at the end).  Each
//    warp keeps its own softmax state for its kv slice; at the end the
//    slices are merged once through shared memory (m = max, rescale by
//    exp2(m_w - m)) and the output is stored once.
//  - Both products are register micro-tiles over 16-byte shared loads
//    that lanes share by broadcast, with at most 8 distinct addresses in
//    distinct banks (rows are D + 4 floats apart): S takes TM + TN float4
//    loads of q and k rows per 4*TM*TN FMAs, P.V TM float4 of P and TD/4
//    of v per kv row.  No transposed store: both products contract along
//    rows as they lie in memory.
//  - The online softmax runs on the registers of S's layout in the log2
//    domain (log2(e) folded into the scale, exp2f): the row max by xor
//    shuffles among the lanes sharing a row.  P and each row's alpha go
//    once a kv step to the warp's own shared rows (P's stride is c mod 2c
//    floats for S's c lanes along a row: conflict-free scalar stores and
//    float4 loads) and are read back in the output's layout after a
//    __syncwarp; no CTA barrier guards them.
//  - K and V tiles arrive through a two-stage ring of fp32 tiles fed by
//    cp.async: tile ki+1 is issued right after the step's one CTA barrier
//    and lands while tile ki is worked on.  float32 rows are copied
//    16 bytes at a time straight into the ring; bfloat16 rows 8 bytes at
//    a time into a staging tile that each thread converts (its own units,
//    so no barrier) into the ring's next slot, k after S and v after P.V.
//  - One CTA barrier a kv step: it publishes tile ki and frees the slot
//    of tile ki-1.
//  - Only kv blocks that cross the diagonal are masked (a uniform branch
//    per step); heavier (later) q blocks of a causal problem run first.
//  - A head dim d below the instantiated D (d a multiple of 4, 64 < d <=
//    128 runs at 128, 128 < d <= 256 at 256) runs with zero columns past
//    d in every tile, which add exact zeros to q.k^T; only d output
//    columns are stored.
// A CTA that covers more scores a thread would feed S better (8 x 8
// scores cost half the loads per FMA of 4 x 4), but at (128, 64) or
// (256, 32) the fp32 q tile and the two-stage ring no longer fit 227 KiB.
//
// Instantiated (block_q, block_kv, D): (64, 32, 128), (64, 64, 128),
// (128, 32, 128), (64, 32, 256) (with_tile below).  Every other triple of
// multiples of 4 whose CTA fits runs the general kernel, the first
// design, unchanged.  repro_flash_attention_limits below states which
// CTA a triple takes; launch_limits in repro_torch.kernels.flash_attention
// mirrors it, so the choice is made before any launch, never on a failed
// one.
//
// Launch limits: 256 threads both.  Tiled, dynamic shared memory
//   4 * ((block_q + 4*block_kv) * (D + 4) + 8 * WM * (PS + 1))
//   + 2 * block_kv * D
// bytes (q, the ring's two k and two v tiles, each warp's P rows of PS
// floats and its alpha, the bfloat16 staging tile), between 119 and
// 224 KiB: one CTA an SM by shared memory, and at 256 threads any
// register count up to 255 fits beside it.  General, 4 * (2*d*block_q +
// 2*d*block_kv + block_q*block_kv + 3*block_q) bytes, within 227 KiB.
//
// C interface (bound with ctypes): repro_flash_attention(...) launches on
// the given stream, does not synchronise, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int G = 4;                  // microtile edge; block granule
constexpr float NEG_INF = -1073741824.0f;  // -2^30, finite as in the reference
constexpr float LOG2E = 1.4426950408889634f;
constexpr long long SMEM_PER_CTA = 232448;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 a = p2[0], b = p2[1];
  return make_float4(__bfloat162float(a.x), __bfloat162float(a.y),
                     __bfloat162float(b.x), __bfloat162float(b.y));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x, x.y);
  p2[1] = __floats2bfloat162_rn(x.z, x.w);
}

// ---------------------------------------------------------------------
// the tiled kernel
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tile shapes of one instantiation (see the header): block_q, block_kv
// and D; WM q rows a warp; S = q.k^T laid over the warp's lanes as LRS
// rows x 32/LRS columns, the output as LRO rows x 32/LRO float4 chunks.
template <int BQ_, int BKV_, int D_, int WM_, int LRS_, int LRO_>
struct Tile {
  static constexpr int BQ = BQ_, BKV = BKV_, D = D_, WM = WM_;
  static constexpr int LRS = LRS_, LCS = 32 / LRS, TMS = WM / LRS;
  static constexpr int LRO = LRO_, LCO = 32 / LRO, TMO = WM / LRO;
  static constexpr int WRG = BQ / WM;            // warps along q rows
  static constexpr int WCG = WARPS / WRG;        // warps along the kv block
  static constexpr int BKVW = BKV / WCG;         // kv columns a warp
  static constexpr int TN = BKVW / LCS;          // kv columns a thread (S)
  static constexpr int TD = D / LCO;             // output columns a thread
  static constexpr int STRIDE = D + 4;           // floats a q, k or v row
  // P rows: a stride of LCS mod 2*LCS floats keeps S's scalar stores free
  // of bank conflicts; p_loads_ok() checks the output's float4 loads
  static constexpr int PS =
      BKVW + ((LCS - BKVW % (2 * LCS)) + 2 * LCS) % (2 * LCS);
  static constexpr int DU = D / G;               // float4 units a row
  static constexpr int Q_FLOATS = BQ * STRIDE;
  static constexpr int SLOT_FLOATS = BKV * STRIDE;   // one k or v tile
  static constexpr int P_FLOATS = WARPS * WM * PS;
  static constexpr int A_FLOATS = WARPS * WM;        // each row's alpha
  static constexpr long long STAGE_BYTES = 2ll * BKV * D;  // bf16 staging
  static constexpr long long SMEM =
      4ll * (Q_FLOATS + 4 * SLOT_FLOATS + P_FLOATS + A_FLOATS) + STAGE_BYTES;
  static constexpr bool p_loads_ok() {
    for (int a = 0; a < LRO; ++a)
      for (int b = 0; b < a; ++b)
        if ((PS * a) % 32 / 4 == (PS * b) % 32 / 4) return false;
    return true;
  }
  static_assert(WRG * WM == BQ && WRG * WCG == WARPS, "rows over warps");
  static_assert(TMS * LRS == WM && TMO * LRO == WM, "rows over lanes");
  static_assert(WCG * BKVW == BKV && TN * LCS == BKVW && TN >= 1, "kv slices");
  static_assert(TD * LCO == D && TD % G == 0, "output chunks");
  static_assert(p_loads_ok(), "P's float4 loads");
  // the end merges every slice's output and (m, l) through the ring and
  // the P rows
  static_assert(WCG * BQ <= 4 * BKV && 2 * WCG * BQ <= P_FLOATS, "merge");
  static_assert(SMEM <= SMEM_PER_CTA, "one CTA's shared memory");
  static_assert(BKV * DU % THREADS == 0 && BQ * DU % THREADS == 0,
                "whole units a thread");
};

// This thread's units of a BKV x D tile, 4 elements each: the same
// units for every copy and conversion, so a thread converts only what it
// copied itself.
template <class C>
constexpr int UNITS_PER_THREAD = C::BKV * C::DU / THREADS;

// Issue this thread's 16-byte copies of rows [0, BKV) of a float32 tile
// (row pitch d) into a ring slot; units past d stay as they are (zero).
template <class C>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int d) {
#pragma unroll
  for (int it = 0; it < UNITS_PER_THREAD<C>; ++it) {
    const int u = threadIdx.x + it * THREADS;
    const int r = u / C::DU, c = (u % C::DU) * G;
    if (c < d) cp_async16(dst + r * C::STRIDE + c, src + (int64_t)r * d + c);
  }
}

// The same for a bfloat16 tile, 8 bytes a unit, into the staging tile.
template <class C>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* stage,
                                          const __nv_bfloat16* src, int d) {
#pragma unroll
  for (int it = 0; it < UNITS_PER_THREAD<C>; ++it) {
    const int u = threadIdx.x + it * THREADS;
    const int r = u / C::DU, c = (u % C::DU) * G;
    if (c < d) cp_async8(stage + r * C::D + c, src + (int64_t)r * d + c);
  }
}

// Convert this thread's own staged units (after its own wait) into a ring
// slot.
template <class C>
__device__ __forceinline__ void convert_tile(float* dst,
                                             const __nv_bfloat16* stage,
                                             int d) {
#pragma unroll
  for (int it = 0; it < UNITS_PER_THREAD<C>; ++it) {
    const int u = threadIdx.x + it * THREADS;
    const int r = u / C::DU, c = (u % C::DU) * G;
    if (c < d) store4(dst + r * C::STRIDE + c, load4(stage + r * C::D + c));
  }
}

template <typename T, class C>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            int sq, int skv, int d, int causal, int q_offset,
                            float scale) {
  constexpr int BQ = C::BQ, BKV = C::BKV, D = C::D;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int TMS = C::TMS, TN = C::TN, LRS = C::LRS, LCS = C::LCS;
  constexpr int TMO = C::TMO, TD = C::TD, LRO = C::LRO, LCO = C::LCO;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);  // BQ x STRIDE
  float* const ring = qs + C::Q_FLOATS;   // [stage][k, v] BKV x STRIDE
  float* const ps = ring + 4 * C::SLOT_FLOATS;        // [warp] WM x PS
  float* const al = ps + C::P_FLOATS;                 // [warp] WM
  __nv_bfloat16* const stage =
      reinterpret_cast<__nv_bfloat16*>(al + C::A_FLOATS);  // BKV x D

  const int64_t g = blockIdx.x;                        // batch * head
  const int qi = gridDim.y - 1 - blockIdx.y;           // heavy blocks first
  const int first_q = qi * BQ;
  const T* const qg = q + (g * sq + first_q) * d;
  const T* const kg = k + g * skv * d;
  const T* const vg = v + g * skv * d;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wr = warp % C::WRG, wc = warp / C::WRG;
  const int wrow = wr * C::WM, wcol = wc * C::BKVW;   // the warp's rows, kv
  const int lrs = lane / LCS, lcs = lane % LCS;  // S: rows lrs + LRS*i,
                                                 // kv columns lcs + LCS*n
  const int lro = lane / LCO, lco = lane % LCO;  // output: rows lro + LRO*i,
                                                 // chunks lco + LCO*mm
  float* const pw = ps + warp * C::WM * C::PS;
  float* const aw = al + warp * C::WM;

  // q once, zero past d; the ring's columns past d zeroed once (the
  // copies never write them)
  for (int u = tid; u < BQ * C::DU; u += THREADS) {
    const int r = u / C::DU, c = (u % C::DU) * G;
    store4(qs + r * C::STRIDE + c,
           c < d ? load4(qg + (int64_t)r * d + c) : make_float4(0, 0, 0, 0));
  }
  if (d < D) {
    for (int u = tid; u < 4 * BKV * C::DU; u += THREADS) {
      const int r = u / C::DU, c = (u % C::DU) * G;
      if (c >= d) store4(ring + r * C::STRIDE + c, make_float4(0, 0, 0, 0));
    }
  }

  const int nk = skv / BKV;
  const int visit = causal ? min(nk, (first_q + q_offset + BQ - 1) / BKV + 1)
                           : nk;
  // tile 0 (none when there is no key)
  if (visit > 0) {
    if constexpr (F32) {
      copy_tile<C>(ring, kg, d);
      copy_tile<C>(ring + C::SLOT_FLOATS, vg, d);
      cp_commit();
    } else {
      copy_tile<C>(stage, kg, d);
      cp_commit();
      cp_wait_all();
      convert_tile<C>(ring, stage, d);
      copy_tile<C>(stage, vg, d);
      cp_commit();
      cp_wait_all();
      convert_tile<C>(ring + C::SLOT_FLOATS, stage, d);
    }
  }

  float o[TMO][TD];
  float m[TMS], l[TMS];
#pragma unroll
  for (int i = 0; i < TMS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < TMO; ++i)
#pragma unroll
    for (int t = 0; t < TD; ++t) o[i][t] = 0.f;
  const float sl2 = scale * LOG2E;
  const int diag = first_q + q_offset;   // row 0's last visible key

  for (int ki = 0; ki < visit; ++ki) {
    const int first_k = ki * BKV;
    const float* const ks = ring + (ki & 1) * 2 * C::SLOT_FLOATS;
    const float* const vs = ks + C::SLOT_FLOATS;
    float* const kn = ring + ((ki + 1) & 1) * 2 * C::SLOT_FLOATS;
    float* const vn = kn + C::SLOT_FLOATS;
    const bool more = ki + 1 < visit;
    const int64_t next = (int64_t)(first_k + BKV) * d;
    if constexpr (F32) cp_wait_all();   // this thread's part of tile ki
    __syncthreads();   // tile ki whole; every warp done with tile ki-1
    if (more) {
      if constexpr (F32) {
        copy_tile<C>(kn, kg + next, d);
        copy_tile<C>(vn, vg + next, d);
      } else {
        copy_tile<C>(stage, kg + next, d);
      }
      cp_commit();
    }

    // S = q . k^T on TMS x TN registers
    float s[TMS][TN];
#pragma unroll
    for (int i = 0; i < TMS; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) s[i][n] = 0.f;
    const float* const qrow = qs + (wrow + lrs) * C::STRIDE;
    const float* const krow = ks + (wcol + lcs) * C::STRIDE;
#pragma unroll
    for (int c = 0; c < D; c += G) {
      float4 a[TMS], b[TN];
#pragma unroll
      for (int i = 0; i < TMS; ++i)
        a[i] = load4(qrow + i * LRS * C::STRIDE + c);
#pragma unroll
      for (int n = 0; n < TN; ++n)
        b[n] = load4(krow + n * LCS * C::STRIDE + c);
#pragma unroll
      for (int i = 0; i < TMS; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          float x = s[i][n];
          x = fmaf(a[i].x, b[n].x, x);
          x = fmaf(a[i].y, b[n].y, x);
          x = fmaf(a[i].z, b[n].z, x);
          x = fmaf(a[i].w, b[n].w, x);
          s[i][n] = x;
        }
    }

    // online softmax on the registers, log2 domain; a masked score's p is
    // 0 outright, since a warp's slice may hold no visible key of a row.
    // P and each row's alpha go to the warp's shared rows.
    const bool masked = causal && first_k + BKV - 1 > diag;
#pragma unroll
    for (int i = 0; i < TMS; ++i) {
      const int reach = diag + wrow + lrs + LRS * i - first_k - wcol - lcs;
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        float t = s[i][n] * sl2;
        if (masked && reach < LCS * n) t = NEG_INF;
        s[i][n] = t;
        mx = fmaxf(mx, t);
      }
#pragma unroll
      for (int x = 1; x < LCS; x *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float mn = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        float p = exp2f(s[i][n] - mn);
        if (masked && reach < LCS * n) p = 0.f;
        pw[(lrs + LRS * i) * C::PS + lcs + LCS * n] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum;
      if (lcs == 0) aw[lrs + LRS * i] = alpha;
    }
    __syncwarp();
    if constexpr (!F32) {
      if (more) {   // k of tile ki+1 into the free slot; then v's copy
        cp_wait_all();
        convert_tile<C>(kn, stage, d);
        copy_tile<C>(stage, vg + next, d);
        cp_commit();
      }
    }

    // O = O * alpha + P . V on TMO x TD registers
#pragma unroll
    for (int i = 0; i < TMO; ++i) {
      const float a = aw[lro + LRO * i];
#pragma unroll
      for (int t = 0; t < TD; ++t) o[i][t] *= a;
    }
    const float* const vrow = vs + wcol * C::STRIDE + G * lco;
    const float* const prow = pw + lro * C::PS;
#pragma unroll 2
    for (int j = 0; j < C::BKVW; j += G) {
      float4 p4[TMO];
#pragma unroll
      for (int i = 0; i < TMO; ++i) p4[i] = load4(prow + i * LRO * C::PS + j);
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const float* const vr = vrow + (j + jj) * C::STRIDE;
#pragma unroll
        for (int mm = 0; mm < TD / G; ++mm) {
          const float4 x = load4(vr + G * LCO * mm);
#pragma unroll
          for (int i = 0; i < TMO; ++i) {
            const float pj = jj == 0 ? p4[i].x : jj == 1 ? p4[i].y
                             : jj == 2 ? p4[i].z : p4[i].w;
            o[i][G * mm + 0] = fmaf(pj, x.x, o[i][G * mm + 0]);
            o[i][G * mm + 1] = fmaf(pj, x.y, o[i][G * mm + 1]);
            o[i][G * mm + 2] = fmaf(pj, x.z, o[i][G * mm + 2]);
            o[i][G * mm + 3] = fmaf(pj, x.w, o[i][G * mm + 3]);
          }
        }
      }
    }
    if constexpr (!F32) {
      if (more) {
        cp_wait_all();
        convert_tile<C>(vn, stage, d);
      }
    }
  }

  // merge the warps' kv slices through shared memory, then store once
  __syncthreads();   // every warp done with the ring and its P rows
  float* const mo = ring;                 // [WCG][BQ] x STRIDE
  float* const mstat = ps;                // m: [WCG][BQ], then l
#pragma unroll
  for (int i = 0; i < TMS; ++i) {
#pragma unroll
    for (int x = 1; x < LCS; x *= 2)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
    if (lcs == 0) {
      const int r = wrow + lrs + LRS * i;
      mstat[wc * BQ + r] = m[i];
      mstat[(C::WCG + wc) * BQ + r] = l[i];
    }
  }
#pragma unroll
  for (int i = 0; i < TMO; ++i) {
    float* const dst =
        mo + (wc * BQ + wrow + lro + LRO * i) * C::STRIDE + G * lco;
#pragma unroll
    for (int mm = 0; mm < TD / G; ++mm)
      store4(dst + G * LCO * mm,
             make_float4(o[i][G * mm], o[i][G * mm + 1], o[i][G * mm + 2],
                         o[i][G * mm + 3]));
  }
  __syncthreads();
  T* const og = out + (g * sq + first_q) * d;
  for (int u = tid; u < BQ * C::DU; u += THREADS) {
    const int r = u / C::DU, c = (u % C::DU) * G;
    if (c >= d) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < C::WCG; ++w) mx = fmaxf(mx, mstat[w * BQ + r]);
    float den = 0.f;
    float4 acc = make_float4(0, 0, 0, 0);
#pragma unroll
    for (int w = 0; w < C::WCG; ++w) {
      const float f = exp2f(mstat[w * BQ + r] - mx);
      den = fmaf(mstat[(C::WCG + w) * BQ + r], f, den);
      const float4 x = load4(mo + (w * BQ + r) * C::STRIDE + c);
      acc = make_float4(fmaf(x.x, f, acc.x), fmaf(x.y, f, acc.y),
                        fmaf(x.z, f, acc.z), fmaf(x.w, f, acc.w));
    }
    den = fmaxf(den, 1e-30f);
    store4(og + (int64_t)r * d + c, make_float4(acc.x / den, acc.y / den,
                                                acc.z / den, acc.w / den));
  }
}

// ---------------------------------------------------------------------
// the general kernel (the first design), for every other triple
// ---------------------------------------------------------------------

// Stage rows [0, rows) of a (rows x d) slab, transposed, into dst (d x
// rows): lanes walk rows so that the shared stores hit consecutive words.
template <typename T>
__device__ __forceinline__ void stage_transposed(const T* __restrict__ src,
                                                 float* dst, int rows, int d) {
  const int n = rows * (d / G);
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const int r = idx % rows, c = (idx / rows) * G;
    const float4 x = load4(src + (int64_t)r * d + c);
    dst[(c + 0) * rows + r] = x.x;
    dst[(c + 1) * rows + r] = x.y;
    dst[(c + 2) * rows + r] = x.z;
    dst[(c + 3) * rows + r] = x.w;
  }
}

// One CTA per (batch*head, q block): m, l and acc in shared memory; q and
// k staged transposed, v as is, all fp32; both products as 4x4 register
// microtiles over 16-byte shared loads; one warp per query row does the
// softmax update with shuffles; four barriers per kv step.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int sq, int skv, int d, int bq, int bkv, int causal,
                       int q_offset, float scale) {
  extern __shared__ float4 smem4[];
  float* const qT = reinterpret_cast<float*>(smem4);  // d x bq
  float* const kT = qT + d * bq;                       // d x bkv
  float* const vs = kT + d * bkv;                      // bkv x d
  float* const s = vs + bkv * d;                       // bq x bkv
  float* const acc = s + bq * bkv;                     // bq x d
  float* const m = acc + bq * d;                       // bq
  float* const l = m + bq;                             // bq
  float* const alpha = l + bq;                         // bq

  const int64_t g = blockIdx.x;                        // batch * head
  const int qi = gridDim.y - 1 - blockIdx.y;           // heavy blocks first
  const int first_q = qi * bq;
  const T* const qg = q + (g * sq + first_q) * d;
  const T* const kg = k + g * skv * d;
  const T* const vg = v + g * skv * d;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  stage_transposed(qg, qT, bq, d);
  for (int i = tid; i < bq * d; i += THREADS) acc[i] = 0.f;
  for (int i = tid; i < bq; i += THREADS) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }

  const int nk = skv / bkv;
  const int visit = causal ? min(nk, (first_q + q_offset + bq - 1) / bkv + 1)
                           : nk;
  for (int ki = 0; ki < visit; ++ki) {
    const int first_k = ki * bkv;
    __syncthreads();  // the previous step is done with kT, vs and s
    stage_transposed(kg + (int64_t)first_k * d, kT, bkv, d);
    for (int idx = tid; idx < bkv * (d / G); idx += THREADS) {
      const int c = (idx % (d / G)) * G;
      const int r = idx / (d / G);
      *reinterpret_cast<float4*>(vs + r * d + c) =
          load4(vg + (int64_t)(first_k + r) * d + c);
    }
    __syncthreads();

    // s = (q . k^T) * scale, masked, in 4x4 microtiles
    for (int idx = tid; idx < (bq / G) * (bkv / G); idx += THREADS) {
      const int i0 = (idx / (bkv / G)) * G, j0 = (idx % (bkv / G)) * G;
      float a[G][G] = {};
      for (int c = 0; c < d; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(qT + c * bq + i0);
        const float4 y = *reinterpret_cast<const float4*>(kT + c * bkv + j0);
        const float xs[G] = {x.x, x.y, x.z, x.w};
        const float ys[G] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int r = 0; r < G; ++r)
#pragma unroll
          for (int t = 0; t < G; ++t) a[r][t] = fmaf(xs[r], ys[t], a[r][t]);
      }
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float o[G];
#pragma unroll
        for (int t = 0; t < G; ++t) {
          o[t] = a[r][t] * scale;
          if (causal && first_q + i0 + r + q_offset < first_k + j0 + t)
            o[t] = NEG_INF;
        }
        *reinterpret_cast<float4*>(s + (i0 + r) * bkv + j0) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int i = warp; i < bq; i += WARPS) {
      float* const row = s + i * bkv;
      float mx = NEG_INF;
      for (int j = lane; j < bkv; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m[i];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < bkv; j += 32) {
        const float p = expf(row[j] - m_cur);
        row[j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float al = expf(m_prev - m_cur);
        alpha[i] = al;
        l[i] = l[i] * al + sum;
        m[i] = m_cur;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v, in 4x4 microtiles
    for (int idx = tid; idx < (bq / G) * (d / G); idx += THREADS) {
      const int i0 = (idx / (d / G)) * G, c0 = (idx % (d / G)) * G;
      float a[G][G] = {};
      for (int j = 0; j < bkv; ++j) {
        const float4 y = *reinterpret_cast<const float4*>(vs + j * d + c0);
        const float ys[G] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const float p = s[(i0 + r) * bkv + j];
#pragma unroll
          for (int t = 0; t < G; ++t) a[r][t] = fmaf(p, ys[t], a[r][t]);
        }
      }
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float4* const dst = reinterpret_cast<float4*>(acc + (i0 + r) * d + c0);
        const float al = alpha[i0 + r];
        const float4 o = *dst;
        *dst = make_float4(o.x * al + a[r][0], o.y * al + a[r][1],
                           o.z * al + a[r][2], o.w * al + a[r][3]);
      }
    }
  }
  __syncthreads();

  T* const og = out + (g * sq + first_q) * d;
  for (int idx = tid; idx < bq * d; idx += THREADS) {
    const int i = idx / d;
    store1(og + idx, acc[idx] / fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------------
// which CTA a triple takes, and the launches
// ---------------------------------------------------------------------

// The instantiated head dim of a d the tiled kernel takes, else 0.
int tiled_head_dim(int d) {
  if (d <= 64 || d % G) return 0;
  return d <= 128 ? 128 : d <= 256 ? 256 : 0;
}

// The one table of instantiated triples: calls f with the Tile of
// (block_q, block_kv, D) and returns true, or returns false off the set.
template <class F>
bool with_tile(int bq, int bkv, int D, F&& f) {
  if (D == 128 && bq == 64 && bkv == 32) f(Tile<64, 32, 128, 16, 4, 2>{});
  else if (D == 128 && bq == 64 && bkv == 64) f(Tile<64, 64, 128, 16, 4, 2>{});
  else if (D == 128 && bq == 128 && bkv == 32)
    f(Tile<128, 32, 128, 16, 4, 2>{});
  else if (D == 256 && bq == 64 && bkv == 32) f(Tile<64, 32, 256, 8, 2, 2>{});
  else return false;
  return true;
}

long long general_smem(int bq, int bkv, int d) {
  return 4ll * (2ll * d * bq + 2ll * d * bkv + (long long)bq * bkv + 3ll * bq);
}

template <typename T, class C>
int launch_tiled(const void* q, const void* k, const void* v, void* out,
                 long long bh, int sq, int skv, int d, int causal,
                 int q_offset, float scale, cudaStream_t stream) {
  auto* kernel = flash_attention_simt_kernel<T, C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)bh, (unsigned)(sq / C::BQ));
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, d, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           long long bh, int sq, int skv, int d, int bq, int bkv, int causal,
           int q_offset, float scale, cudaStream_t stream) {
  int err = 0;
  if (with_tile(bq, bkv, tiled_head_dim(d), [&](auto tile) {
        err = launch_tiled<T, decltype(tile)>(q, k, v, out, bh, sq, skv, d,
                                              causal, q_offset, scale,
                                              stream);
      }))
    return err;
  const size_t smem = (size_t)general_smem(bq, bkv, d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)bh, (unsigned)(sq / bq));
  flash_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, d, bq, bkv,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory and threads of the CTA that (block_q, block_kv,
// head_dim) launches: the tiled kernel's at an instantiated triple, else
// the general kernel's; cudaErrorInvalidValue for a triple that cannot
// launch (not positive multiples of 4, or over 227 KiB).
extern "C" int repro_flash_attention_limits(int d, int bkv, int bq,
                                            long long* smem, int* threads) {
  if (bq <= 0 || bkv <= 0 || d <= 0 || bq % G || bkv % G || d % G)
    return (int)cudaErrorInvalidValue;
  long long bytes = general_smem(bq, bkv, d);
  with_tile(bq, bkv, tiled_head_dim(d),
            [&](auto tile) { bytes = decltype(tile)::SMEM; });
  if (bytes > SMEM_PER_CTA) return (int)cudaErrorInvalidValue;
  *smem = bytes;
  *threads = THREADS;
  return (int)cudaSuccess;
}

// dtype: 0 = float32, 1 = bfloat16.  The wrapper has checked shapes,
// divisibility, granules, alignment and the shared-memory limit; the
// checks here only keep a bad call from launching.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, long long bh,
                                     int sq, int skv, int d, int bq, int bkv,
                                     int causal, int q_offset, float scale,
                                     int dtype, void* stream) {
  if (bh <= 0 || sq <= 0) return (int)cudaSuccess;
  long long smem;
  int threads;
  if (repro_flash_attention_limits(d, bkv, bq, &smem, &threads)
      || sq % bq || skv % bkv || (causal && q_offset < 0)
      || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, bh, sq, skv, d, bq, bkv, causal,
                         q_offset, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, bh, sq, skv, d, bq, bkv,
                                 causal, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
