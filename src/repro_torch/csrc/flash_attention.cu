// Blocked online-softmax (flash) attention for Hopper, sm_90a.
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
// Inputs are float32 or bfloat16 (read with __bfloat162float); everything
// inside is fp32.  Causal kv blocks wholly above the diagonal are not
// visited: the kv loop of q block qi stops at
//   min(nk, (qi*block_q + q_offset + block_q - 1) / block_kv + 1),
// the visit rule of the Pallas kernel's pl.when and of the tuner's
// FlashAttentionSpace._steps.
//
// What bounds it on the H100: operations.  Attention does 4*d flops per
// visible (query, key) pair against 4 tensors that each move once; at
// granite-8b's d = 128 that is hundreds of flops per byte, far above the
// card's balance point.  This first kernel runs its products on the CUDA
// cores in fp32 (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s
// bf16): right and simple first; wgmma and TMA come in a redesign.
//
// What the design does about it: the TPU's sequential kv grid axis becomes
// a loop inside one CTA per (batch*head, q block), so m, l and acc stay in
// shared memory for the whole loop and nothing crosses CTAs.  The q tile
// is staged once, transposed (d x block_q); each kv step stages k
// transposed (d x block_kv) and v as is (block_kv x d), all in fp32.  Both
// products run as 4x4 register microtiles over 16-byte shared loads, so a
// thread does 16 FMAs per two float4 loads (q.k^T) or per one float4 and
// four broadcast scalars (p.v).  One warp per query row does the softmax
// update with shuffles.  Four barriers per kv step.  Heavier (later) q
// blocks of a causal problem are scheduled first, to shorten the tail.
//
// Launch limits (mirrored by repro_torch.kernels.flash_attention
// .launch_limits, which every caller reads): 256 threads; block_q,
// block_kv and d multiples of 4; dynamic shared memory
//   4 * (2*d*block_q + 2*d*block_kv + block_q*block_kv + 3*block_q) bytes
// at most 227 KiB (opted in above 48 KB with cudaFuncSetAttribute).
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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           long long bh, int sq, int skv, int d, int bq, int bkv, int causal,
           int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * d * bq + (size_t)2 * d * bkv
                                       + (size_t)bq * bkv + 3 * (size_t)bq);
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

// dtype: 0 = float32, 1 = bfloat16.  The wrapper has checked shapes,
// divisibility, granules, alignment and the shared-memory limit; the
// checks here only keep a bad call from launching.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, long long bh,
                                     int sq, int skv, int d, int bq, int bkv,
                                     int causal, int q_offset, float scale,
                                     int dtype, void* stream) {
  if (bh <= 0 || sq <= 0) return (int)cudaSuccess;
  if (bq <= 0 || bkv <= 0 || d <= 0 || bq % G || bkv % G || d % G
      || sq % bq || skv % bkv || (causal && q_offset < 0))
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
