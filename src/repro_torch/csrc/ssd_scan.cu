// The SSD scan of Mamba-2 (state-space duality, arXiv:2405.21060) on the
// CUDA cores of Hopper, sm_90a: its forward and its backward, exact fp32.
//
// Replaces no TPU kernel: the JAX package computes the scan inside
// src/repro/models/mamba2.py (mamba2_apply's chunked SSD, a Python loop
// over chunks in plain jnp that XLA fuses), and the port ran the same
// loop in PyTorch (repro_torch.kernels.ssd_scan.plain).  On the card that
// loop is ~15 launches a chunk, 16 chunks a layer, each materialising
// float32 (b, Q, Q, h) tensors in device memory (168 MB each at
// mamba2-2.7b's training shape), and under autograd it saves several of
// them a chunk: two thirds of a mamba2 training step.  These kernels
// compute the same function with no (b, Q, Q, h) tensor in device memory.
//
// What it computes, per row b, chunk c of Q positions and head h (x the
// (Q, P) inputs, B and C the (Q, N) projections of the head's group, one
// of G that split the heads into G equal runs (Mamba-2's ngroups), dt
// the step sizes, Lc the within-chunk cumulative sum of the log-decays,
// all as repro_torch.kernels.ssd_scan.plain computes them):
//   S[l,m]  = C[l].B[m], rounded to the operands' type (bf16 inputs: the
//             plain version's bf16 einsum rounds it so);
//   Mt[l,m] = (S[l,m] * exp(clamp(Lc[l] - Lc[m], -60, 0))) * dt[m], l >= m;
//   y[l]    = sum_m Mt[l,m] x[m] + exp(Lc[l]) * (C[l] . H_c^T) + D * x[l];
//   H_{c+1} = H_c * exp(Lc[Q-1])
//             + sum_l (dt[l] exp(Lc[Q-1] - Lc[l]) x[l])^T B[l],
// with H_0 the given state, and the gradients of all of it (ssd_backward
// in the wrapper's module writes the same formulas out in PyTorch).
//
// What bounds it on the H100: operations.  At the training shape (b 8,
// L 4096, h 80, P 64, N 128, Q 256) the forward's products are ~131
// GFLOP a layer counted whole (C.B^T 2.1, Mt.x 42.9, the chunk states
// 42.9, C.H^T 42.9), the backward's about twice that, against ~1.7 GB
// that must move: ~2.0 ms forward and ~3.9 ms backward at the FP32 floor
// (67 TFLOP/s) against ~0.5 ms of bytes.  No product is taken in TF32 or
// on bf16 tensor cores: every product the plain version takes in fp32
// stays fp32.
//
// The design:
//  - Every product is one 64 x 64 output tile of a CTA of 256 threads, a
//    4 x 4 register micro-tile a thread, contracted 64 at a time over
//    shared tiles stored k-major (rows 68 floats apart, so that a float4
//    read is aligned): two float4 shared loads per 16 FFMAs.  A tile is
//    filled from global memory through the operands' own strides (x, B
//    and C are slices of the conv output, read in place), 8 values a
//    thread at a time in one 16-byte load where the row is aligned, and
//    converted to fp32 on the way in; what the product needs of the
//    decays (Mt, the chunk weights, exp(Lc)) is applied in the same pass.
//    A transposed tile gives consecutive rows to consecutive threads, so
//    its stores fall in consecutive banks.  Rows past Q, P or N read as
//    zero, so any Q up to 256, P up to 64 and any N run.  (A warp of 4 x 8
//    threads, two shared wavefronts a k step where this 2 x 16 layout
//    takes three, measured no faster.)
//  - Forward, four launches: S once per (row, chunk, group), not per head;
//    the chunk states per (row, chunk, head); the state passing over chunks,
//    elementwise over P x N, which leaves the chunk-start states in place
//    (kept for the backward); the chunk output per (row, chunk, head,
//    64-row l tile), flash-style: Mt's tiles at or below the diagonal are
//    built in shared memory from S and the decays, never stored.
//  - The state passing carries four elements a thread in registers and
//    starts the next chunk's loads before this chunk's store.
//  - Backward, five launches: the chunk states of dy (exp(Lc) dy)^T C; the
//    state passing reversed, which leaves the gradient of each chunk's
//    end state in place and each warp's share of the chunk's decay term;
//    per (row, chunk, head) dx, ddt and the log-decay gradient (row sums
//    less column sums of dMt.Mt, the state and output terms, then the
//    reverse cumulative sum within the chunk), all in one CTA that walks
//    the chunk's tiles;
//    dS = sum_h dMt.G.dt per (row, chunk, group, tile pair), the group's
//    heads walked in order inside the CTA; dB and dC per (row, chunk,
//    group, 64 x 64 tile), the intra-chunk part from dS and the state
//    parts summed over the group's heads in order.  G = 1 launches the
//    grids it always had, from instantiations that fold the group
//    arithmetic away (measured: a runtime group stride and signed block
//    arithmetic cost the one-group kernels 1-2%, the dS kernel 12%).  No
//    float atomics: two runs give the same bits.  dS and the state parts
//    stay fp32 where the plain version's autograd rounds them to bf16 on
//    the way to dB and dC.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int LD = TILE + 4;
constexpr int THREADS = 256;
constexpr int MAX_Q = 256;
// P x N elements a state-passing CTA walks (4 a thread)
constexpr int PASS_SPAN = THREADS * 4;

typedef float Tile[TILE][LD];

struct Dims {
  int b, L, h, P, N, Q, G, hg, nc, nt, ny;  // hg = h / G heads a group
  long long xb, xl, xh;  // strides of x (b, L, h, P); the last is 1
  long long Bb, Bl, Bg;  // of B (b, L, G, N)
  long long Cb, Cl, Cg;  // of C (b, L, G, N)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float decay(float d) {
  return expf(fminf(fmaxf(d, -60.f), 0.f));
}

// acc[i][j] += sum_k A[k][ty*4 + i] * B[k][tx*4 + j]
__device__ __forceinline__ void mma(float acc[4][4], const Tile& A,
                                    const Tile& B) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 16
  for (int k = 0; k < TILE; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&A[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&B[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// 8 consecutive values from p on, converted to fp32: n of them are there
// (zero past n); one 16-byte load (bf16) or two (fp32) where p is aligned
// and all 8 are there
__device__ __forceinline__ void unpack(unsigned w, float& a, float& b) {
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void row8(const __nv_bfloat16* p, int n,
                                     float (&v)[8]) {
  if (n >= 8 && ((size_t)p & 15) == 0) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    unpack(u.x, v[0], v[1]);
    unpack(u.y, v[2], v[3]);
    unpack(u.z, v[4], v[5]);
    unpack(u.w, v[6], v[7]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < n ? to_f(p[j]) : 0.f;
}
__device__ __forceinline__ void row8(const float* p, int n, float (&v)[8]) {
  if (n >= 8 && ((size_t)p & 15) == 0) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < n ? p[j] : 0.f;
}

// row8 at (row, col) of a matrix with row stride ld, `rows` rows and
// `cols` columns: zero outside it
template <class T>
__device__ __forceinline__ void at8(const T* base, long long ld, int row,
                                    int rows, int col, int cols,
                                    float (&v)[8]) {
  row8(base + row * ld + col, row < rows ? cols - col : 0, v);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// a tile from memory: f(r, c0, v) gives the 8 values at row r, columns
// c0..c0+7 of the tile as it lies in memory, stored S[r][c] or, with
// TRANS, S[c][r].  Natural: threads take consecutive column groups
// (coalesced reads, float4 stores); TRANS: consecutive rows (stores to
// consecutive banks)
template <bool TRANS, class F>
__device__ __forceinline__ void fill(Tile& S, F f) {
  for (int i = threadIdx.x; i < TILE * TILE / 8; i += THREADS) {
    const int r = TRANS ? i & (TILE - 1) : i >> 3;
    const int c0 = TRANS ? (i >> 6) * 8 : (i & 7) * 8;
    float v[8];
    f(r, c0, v);
    if (TRANS) {
#pragma unroll
      for (int j = 0; j < 8; ++j) S[c0 + j][r] = v[j];
    } else {
      store8(&S[r][c0], v);
    }
  }
}

// the sum of v over the 16 lanes that share a thread's ty (xor shuffles:
// the same order on every run)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the CTA's sum of v, in a fixed order; every thread gets it
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// tile pair p of the lower triangle (lt >= mt), row by row
__device__ __forceinline__ void pair_of(int p, int& lt, int& mt) {
  lt = 0;
  while (p > lt) p -= ++lt;
  mt = p;
}

// the groups a kernel sees: with GR false (one group) the constants 1
// and 0, and the (row, chunk) and head ranges computed as before groups
// (unsigned from blockIdx), so that the one-group kernels compile to what
// they were, and run in the time they did
template <bool GR>
__device__ __forceinline__ int groups(const Dims& d) {
  return GR ? d.G : 1;
}
template <bool GR>
__device__ __forceinline__ int group_of(int hh, const Dims& d) {
  return GR ? hh / d.hg : 0;
}

// ------------------------------------------------------------------
// forward
// ------------------------------------------------------------------

// S = C.B^T of one (row, chunk, group), lower tile pairs; grid
// (b*nc*G, pairs)
template <class T, bool GR>
__global__ void __launch_bounds__(THREADS)
    cb_kernel(const T* __restrict__ B, const T* __restrict__ C,
              float* __restrict__ S, Dims d) {
  extern __shared__ float4 smem4[];
  Tile* t = reinterpret_cast<Tile*>(smem4);
  const unsigned g = GR ? blockIdx.x % d.G : 0;
  const unsigned bc = GR ? blockIdx.x / d.G : blockIdx.x;
  const int bi = bc / d.nc, c = bc % d.nc;
  int lt, mt;
  pair_of(blockIdx.y, lt, mt);
  const T* Cb = C + bi * d.Cb + (long long)c * d.Q * d.Cl + g * d.Cg;
  const T* Bb = B + bi * d.Bb + (long long)c * d.Q * d.Bl + g * d.Bg;
  float acc[4][4];
  zero(acc);
  for (int n0 = 0; n0 < d.N; n0 += TILE) {
    fill<true>(t[0], [&](int r, int c0, float (&v)[8]) {
      at8(Cb, d.Cl, lt * TILE + r, d.Q, n0 + c0, d.N, v);
    });
    fill<true>(t[1], [&](int r, int c0, float (&v)[8]) {
      at8(Bb, d.Bl, mt * TILE + r, d.Q, n0 + c0, d.N, v);
    });
    __syncthreads();
    mma(acc, t[0], t[1]);
    __syncthreads();
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float* Sc = S + (long long)blockIdx.x * d.Q * d.Q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = lt * TILE + ty * 4 + i, m = mt * TILE + tx * 4 + j;
      if (l < d.Q && m < d.Q)
        Sc[l * d.Q + m] = to_f(from_f<T>(acc[i][j]));
    }
}

// out[b,c,h][p,n] = sum_l s[l] U[l,p] V[l,n] over one chunk: the chunk
// states (forward: s = dt exp(Lc[Q-1] - Lc), U = x, V = B) or the chunk
// states of dy (backward: s = exp(Lc), U = dy, V = C); grid
// (b*nc*h, N tiles); V is the head's group's
template <class TU, class TV, bool BWD, bool GR>
__global__ void __launch_bounds__(THREADS)
    states_kernel(const TU* __restrict__ U, long long ub, long long ul,
                  long long uh, const TV* __restrict__ V, long long vb,
                  long long vl, long long vg, const float* __restrict__ dt,
                  const float* __restrict__ Lc, float* __restrict__ out,
                  Dims d) {
  extern __shared__ float4 smem4[];
  Tile* t = reinterpret_cast<Tile*>(smem4);
  float* s = reinterpret_cast<float*>(t + 2);
  const int hh = blockIdx.x % d.h, bc = blockIdx.x / d.h;
  const int bi = bc / d.nc, c = bc % d.nc, n0 = blockIdx.y * TILE;
  const long long pos0 = (long long)bi * d.L + (long long)c * d.Q;
  const float last = Lc[(pos0 + d.Q - 1) * d.h + hh];
  for (int q = threadIdx.x; q < d.Q; q += THREADS) {
    const float Lq = Lc[(pos0 + q) * d.h + hh];
    s[q] = BWD ? expf(Lq) : dt[(pos0 + q) * d.h + hh] * expf(last - Lq);
  }
  __syncthreads();
  const TU* Ub = U + bi * ub + (long long)c * d.Q * ul + hh * uh;
  const TV* Vb =
      V + bi * vb + (long long)c * d.Q * vl + group_of<GR>(hh, d) * vg;
  float acc[4][4];
  zero(acc);
  for (int l0 = 0; l0 < d.Q; l0 += TILE) {
    fill<false>(t[0], [&](int r, int c0, float (&v)[8]) {
      const int l = l0 + r;
      at8(Ub, ul, l, d.Q, c0, d.P, v);
      const float sl = l < d.Q ? s[l] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = sl * v[j];
    });
    fill<false>(t[1], [&](int r, int c0, float (&v)[8]) {
      at8(Vb, vl, l0 + r, d.Q, n0 + c0, d.N, v);
    });
    __syncthreads();
    mma(acc, t[0], t[1]);
    __syncthreads();
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float* o = out + (long long)blockIdx.x * d.P * d.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = ty * 4 + i, n = n0 + tx * 4 + j;
      if (p < d.P && n < d.N) o[p * d.N + n] = acc[i][j];
    }
}

// four consecutive floats of a state, as one float4 where the state's
// rows keep them aligned (P*N a multiple of 4), else one by one
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, long long e,
                                        long long n) {
  if (VEC) return *reinterpret_cast<const float4*>(p + e);
  float4 v;
  v.x = e < n ? p[e] : 0.f;
  v.y = e + 1 < n ? p[e + 1] : 0.f;
  v.z = e + 2 < n ? p[e + 2] : 0.f;
  v.w = e + 3 < n ? p[e + 3] : 0.f;
  return v;
}
template <bool VEC>
__device__ __forceinline__ void store4(float* p, long long e, long long n,
                                       float4 v) {
  if (VEC) {
    *reinterpret_cast<float4*>(p + e) = v;
    return;
  }
  if (e < n) p[e] = v.x;
  if (e + 1 < n) p[e + 1] = v.y;
  if (e + 2 < n) p[e + 2] = v.z;
  if (e + 3 < n) p[e + 3] = v.w;
}
__device__ __forceinline__ float4 axpy4(float4 h, float a, float4 t) {
  return make_float4(h.x * a + t.x, h.y * a + t.y, h.z * a + t.z,
                     h.w * a + t.w);
}

// the log-decay at the end of chunk c
__device__ __forceinline__ float chunk_decay(const float* Lc, int bi, int c,
                                             int hh, const Dims& d) {
  return expf(
      Lc[((long long)bi * d.L + (long long)c * d.Q + d.Q - 1) * d.h + hh]);
}

// the recurrence over chunks, elementwise over P x N, four elements a
// thread carried in registers, the next chunk's loads started before this
// chunk's store: buf holds each chunk's state on entry and the state at
// its start on return; grid (b*h, ny)
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    pass_kernel(float* __restrict__ buf, const float* __restrict__ state0,
                float* __restrict__ final_state,
                const float* __restrict__ Lc, Dims d) {
  const int hh = blockIdx.x % d.h, bi = blockIdx.x / d.h;
  const long long PN = (long long)d.P * d.N;
  const long long e = (long long)blockIdx.y * PASS_SPAN + threadIdx.x * 4;
  if (e >= PN) return;
  const long long at = (long long)blockIdx.x * PN;
  const long long step = (long long)d.h * PN;  // one chunk to the next
  float* bc = buf + ((long long)bi * d.nc * d.h + hh) * PN + e;
  float4 H = load4<VEC>(state0 + at, e, PN);
  float4 next = load4<VEC>(bc, 0, PN - e);
  float a_next = chunk_decay(Lc, bi, 0, hh, d);
  for (int c = 0; c < d.nc; ++c, bc += step) {
    const float4 cur = next;
    const float a = a_next;
    if (c + 1 < d.nc) {
      next = load4<VEC>(bc + step, 0, PN - e);
      a_next = chunk_decay(Lc, bi, c + 1, hh, d);
    }
    store4<VEC>(bc, 0, PN - e, H);
    H = axpy4(H, a, cur);
  }
  store4<VEC>(final_state + at, e, PN, H);
}

// y of one (row, chunk, head, l tile); grid (b*nc*h, l tiles)
template <class T, bool GR>
__global__ void __launch_bounds__(THREADS)
    out_kernel(const T* __restrict__ x, const T* __restrict__ C,
               const float* __restrict__ S, const float* __restrict__ Hs,
               const float* __restrict__ dt, const float* __restrict__ Lc,
               const float* __restrict__ Dp, float* __restrict__ y, Dims d) {
  extern __shared__ float4 smem4[];
  Tile* t = reinterpret_cast<Tile*>(smem4);
  float* Ll = reinterpret_cast<float*>(t + 2);
  float* Lm = Ll + TILE;
  float* dm = Lm + TILE;
  const int hh = blockIdx.x % d.h, bc = blockIdx.x / d.h;
  const int bi = bc / d.nc, c = bc % d.nc, lt = blockIdx.y;
  const long long pos0 = (long long)bi * d.L + (long long)c * d.Q;
  const int r = threadIdx.x;
  if (r < TILE)
    Ll[r] = lt * TILE + r < d.Q ? Lc[(pos0 + lt * TILE + r) * d.h + hh] : 0.f;
  const int g = group_of<GR>(hh, d);
  const float* Sc = S + ((long long)bc * groups<GR>(d) + g) * d.Q * d.Q;
  const T* xb = x + bi * d.xb + (long long)c * d.Q * d.xl + hh * d.xh;
  float acc[4][4];
  zero(acc);
  for (int mt = 0; mt <= lt; ++mt) {
    if (r < TILE) {
      const int m = mt * TILE + r;
      Lm[r] = m < d.Q ? Lc[(pos0 + m) * d.h + hh] : 0.f;
      dm[r] = m < d.Q ? dt[(pos0 + m) * d.h + hh] : 0.f;
    }
    __syncthreads();
    fill<true>(t[0], [&](int i, int c0, float (&v)[8]) {  // Mt, as [m][l]
      const int l = lt * TILE + i, m0 = mt * TILE + c0;
      // S up to the diagonal; past it (and past Q) zero
      at8(Sc, d.Q, l, d.Q, m0, min(l + 1, d.Q), v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = (v[j] * decay(Ll[i] - Lm[c0 + j])) * dm[c0 + j];
    });
    fill<false>(t[1], [&](int i, int c0, float (&v)[8]) {
      at8(xb, d.xl, mt * TILE + i, d.Q, c0, d.P, v);
    });
    __syncthreads();
    mma(acc, t[0], t[1]);
    __syncthreads();
  }
  float inter[4][4];
  zero(inter);
  const T* Cb = C + bi * d.Cb + (long long)c * d.Q * d.Cl + g * d.Cg;
  const float* H = Hs + (long long)blockIdx.x * d.P * d.N;
  for (int n0 = 0; n0 < d.N; n0 += TILE) {
    fill<true>(t[0], [&](int i, int c0, float (&v)[8]) {
      at8(Cb, d.Cl, lt * TILE + i, d.Q, n0 + c0, d.N, v);
    });
    fill<true>(t[1], [&](int p, int c0, float (&v)[8]) {
      at8(H, d.N, p, d.P, n0 + c0, d.N, v);
    });
    __syncthreads();
    mma(inter, t[0], t[1]);
    __syncthreads();
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float D = Dp[hh];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = lt * TILE + ty * 4 + i;
    if (l >= d.Q) continue;
    const float el = expf(Ll[ty * 4 + i]);
    float* yl = y + ((pos0 + l) * d.h + hh) * d.P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx * 4 + j;
      if (p < d.P)
        yl[p] = (acc[i][j] + el * inter[i][j]) + D * to_f(xb[l * d.xl + p]);
    }
  }
}

// ------------------------------------------------------------------
// backward
// ------------------------------------------------------------------

// the recurrence reversed, as pass_kernel runs it: buf holds each
// chunk's dy state on entry and the gradient of its end state on return;
// the carry (dstate0) starts as dfinal (or zero); part[b,c,h][y*8 + w]
// is warp w's share of sum(dH_end * H_start), the chunk's decay term;
// grid (b*h, ny)
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    pass_bwd_kernel(float* __restrict__ buf, const float* __restrict__ Hs,
                    const float* __restrict__ dfinal,
                    float* __restrict__ dstate0, float* __restrict__ part,
                    const float* __restrict__ Lc, Dims d) {
  const int hh = blockIdx.x % d.h, bi = blockIdx.x / d.h;
  const long long PN = (long long)d.P * d.N;
  const long long e = (long long)blockIdx.y * PASS_SPAN + threadIdx.x * 4;
  const bool in = e < PN;  // every lane takes part in the warp sums
  const long long at = (long long)blockIdx.x * PN;
  const long long step = (long long)d.h * PN;
  const long long first = ((long long)bi * d.nc * d.h + hh) * PN + e;
  float* bc = buf + first + (d.nc - 1) * step;
  const float* hc = Hs + first + (d.nc - 1) * step;
  const long long left = PN - e;
  const int slots = d.ny * (THREADS / 32);
  float* pc = part + ((long long)bi * d.nc * d.h + hh) * slots +
              blockIdx.y * (THREADS / 32) + (threadIdx.x >> 5);
  const long long pstep = (long long)d.h * slots;
  float4 G = in && dfinal ? load4<VEC>(dfinal + at, e, PN)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 t_next = in ? load4<VEC>(bc, 0, left) : G;
  float4 h_next = in ? load4<VEC>(hc, 0, left) : G;
  float a_next = chunk_decay(Lc, bi, d.nc - 1, hh, d);
  for (int c = d.nc - 1; c >= 0; --c, bc -= step, hc -= step) {
    const float4 t = t_next, H = h_next;
    const float a = a_next;
    if (c > 0) {
      if (in) {
        t_next = load4<VEC>(bc - step, 0, left);
        h_next = load4<VEC>(hc - step, 0, left);
      }
      a_next = chunk_decay(Lc, bi, c - 1, hh, d);
    }
    if (in) store4<VEC>(bc, 0, left, G);
    float v = G.x * H.x + G.y * H.y + G.z * H.z + G.w * H.w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) pc[c * pstep] = v;
    G = axpy4(G, a, t);
  }
  if (in) store4<VEC>(dstate0 + at, e, PN, G);
}

// dx, ddt and dl_t of one (row, chunk, head), and its share of dD; grid
// (b*nc*h)
template <class T, bool GR>
__global__ void __launch_bounds__(THREADS, 2)
    dx_kernel(const T* __restrict__ x, const T* __restrict__ B,
              const T* __restrict__ C, const float* __restrict__ S,
              const float* __restrict__ Hs, const float* __restrict__ dHe,
              const float* __restrict__ dy, const float* __restrict__ dt,
              const float* __restrict__ Lc, const float* __restrict__ part,
              const float* __restrict__ Dp, T* __restrict__ dx,
              float* __restrict__ ddt, float* __restrict__ dlt,
              float* __restrict__ dD, Dims d) {
  extern __shared__ float4 smem4[];
  Tile* t = reinterpret_cast<Tile*>(smem4);
  Tile &A = t[0], &X = t[1], &Mn = t[2], &Dn = t[3], &SG = t[4];
  float* Lq = reinterpret_cast<float*>(t + 5);
  float* dq = Lq + MAX_Q;
  float* dLrow = dq + MAX_Q;
  float* dLcol = dLrow + MAX_Q;
  float* dDt = dLcol + MAX_Q;
  float* red = dDt + MAX_Q;  // [2][16][TILE]
  float* red8 = red + 2 * 16 * TILE;
  const int hh = blockIdx.x % d.h, bc = blockIdx.x / d.h;
  const int bi = bc / d.nc, c = bc % d.nc;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long pos0 = (long long)bi * d.L + (long long)c * d.Q;
  for (int q = threadIdx.x; q < d.Q; q += THREADS) {
    Lq[q] = Lc[(pos0 + q) * d.h + hh];
    dq[q] = dt[(pos0 + q) * d.h + hh];
    dLrow[q] = dLcol[q] = dDt[q] = 0.f;
  }
  __syncthreads();
  const float Lend = Lq[d.Q - 1], D = Dp[hh];
  const long long hP = (long long)d.h * d.P;
  const T* xb = x + bi * d.xb + (long long)c * d.Q * d.xl + hh * d.xh;
  const int g = group_of<GR>(hh, d);
  const T* Bb = B + bi * d.Bb + (long long)c * d.Q * d.Bl + g * d.Bg;
  const T* Cb = C + bi * d.Cb + (long long)c * d.Q * d.Cl + g * d.Cg;
  const float* dyb = dy + pos0 * hP + (long long)hh * d.P;
  const float* Sc = S + ((long long)bc * groups<GR>(d) + g) * d.Q * d.Q;
  const float* Hb = Hs + (long long)blockIdx.x * d.P * d.N;
  const float* dHb = dHe + (long long)blockIdx.x * d.P * d.N;
  float dlast = 0.f, dDsum = 0.f;
  for (int mt = 0; mt < d.nt; ++mt) {
    fill<true>(X, [&](int i, int c0, float (&v)[8]) {  // x, as [p][m]
      at8(xb, d.xl, mt * TILE + i, d.Q, c0, d.P, v);
    });
    float accX[4][4];
    zero(accX);
    // the m columns' sums over every l tile: dMt.Mt and dMt.S.G
    float cs[4] = {0.f, 0.f, 0.f, 0.f}, cd[4] = {0.f, 0.f, 0.f, 0.f};
    for (int lt = mt; lt < d.nt; ++lt) {
      for (int i = threadIdx.x; i < TILE * TILE / 8; i += THREADS) {
        // dy, as [p][l] and as [l][p]: rows to consecutive threads
        const int r = i & (TILE - 1), c0 = (i >> 6) * 8;
        float v[8];
        at8(dyb, hP, lt * TILE + r, d.Q, c0, d.P, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) A[c0 + j][r] = v[j];
        store8(&Dn[r][c0], v);
      }
      for (int i = threadIdx.x; i < TILE * TILE / 8; i += THREADS) {
        // S.G and Mt as the forward builds it, [l][m]
        const int r = i >> 3, c0 = (i & 7) * 8;
        const int l = lt * TILE + r, m0 = mt * TILE + c0;
        float sg[8], mv[8];
        at8(Sc, d.Q, l, d.Q, m0, min(l + 1, d.Q), sg);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool in = l < d.Q && m0 + j <= l;
          sg[j] = in ? sg[j] * decay(Lq[l] - Lq[m0 + j]) : 0.f;
          mv[j] = in ? sg[j] * dq[m0 + j] : 0.f;
        }
        store8(&SG[r][c0], sg);
        store8(&Mn[r][c0], mv);
      }
      __syncthreads();
      float dM[4][4];
      zero(dM);
      mma(dM, A, X);  // dMt[l][m] = dy[l] . x[m]
      float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 sg4 =
            *reinterpret_cast<const float4*>(&SG[ty * 4 + i][tx * 4]);
        const float4 mt4 =
            *reinterpret_cast<const float4*>(&Mn[ty * 4 + i][tx * 4]);
        const float sg[4] = {sg4.x, sg4.y, sg4.z, sg4.w};
        const float mv[4] = {mt4.x, mt4.y, mt4.z, mt4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int l = lt * TILE + ty * 4 + i, m = mt * TILE + tx * 4 + j;
          if (l >= d.Q || m > l) continue;
          cd[j] += dM[i][j] * sg[j];
          const float diff = Lq[l] - Lq[m];
          if (diff >= -60.f && diff <= 0.f) {  // where the clamp passes
            const float dd = dM[i][j] * mv[j];
            rs[i] += dd;
            cs[j] += dd;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rs[i] = sum16(rs[i]);
        const int l = lt * TILE + ty * 4 + i;
        if (tx == 0 && l < d.Q) dLrow[l] += rs[i];
      }
      mma(accX, Mn, Dn);  // dx[m][p] += sum_l Mt[l][m] dy[l][p]
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[ty * TILE + tx * 4 + j] = cs[j];
      red[16 * TILE + ty * TILE + tx * 4 + j] = cd[j];
    }
    __syncthreads();
    if (threadIdx.x < TILE) {
      const int m = mt * TILE + threadIdx.x;
      float a = 0.f, b = 0.f;
      for (int k = 0; k < 16; ++k) {
        a += red[k * TILE + threadIdx.x];
        b += red[16 * TILE + k * TILE + threadIdx.x];
      }
      if (m < d.Q) {
        dLcol[m] += a;
        dDt[m] += b;
      }
    }
    // the state term: R[m][p] = B[m] . dH_end[p]
    float R[4][4];
    zero(R);
    for (int n0 = 0; n0 < d.N; n0 += TILE) {
      fill<true>(A, [&](int i, int c0, float (&v)[8]) {
        at8(Bb, d.Bl, mt * TILE + i, d.Q, n0 + c0, d.N, v);
      });
      fill<true>(X, [&](int p, int c0, float (&v)[8]) {
        at8(dHb, d.N, p, d.P, n0 + c0, d.N, v);
      });
      __syncthreads();
      mma(R, A, X);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = mt * TILE + ty * 4 + i;
      const bool in = m < d.Q;
      const float e = in ? expf(Lend - Lq[m]) : 0.f;
      const float w = in ? dq[m] * e : 0.f;
      float dw = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx * 4 + j;
        if (!in || p >= d.P) continue;
        const float xv = to_f(xb[m * d.xl + p]);
        const float g = dyb[m * hP + p];
        dw += xv * R[i][j];
        dDsum += xv * g;
        dx[((pos0 + m) * d.h + hh) * d.P + p] =
            from_f<T>((accX[i][j] + w * R[i][j]) + D * g);
      }
      dw = sum16(dw);
      if (tx == 0 && in) {
        dDt[m] += dw * e;
        dLcol[m] += dw * w;
        dlast += dw * w;
      }
    }
    // the output's state term: rows l of this tile, Y[l][p] = C[l] . H[p]
    float Y[4][4];
    zero(Y);
    for (int n0 = 0; n0 < d.N; n0 += TILE) {
      fill<true>(A, [&](int i, int c0, float (&v)[8]) {
        at8(Cb, d.Cl, mt * TILE + i, d.Q, n0 + c0, d.N, v);
      });
      fill<true>(X, [&](int p, int c0, float (&v)[8]) {
        at8(Hb, d.N, p, d.P, n0 + c0, d.N, v);
      });
      __syncthreads();
      mma(Y, A, X);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = mt * TILE + ty * 4 + i;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx * 4 + j;
        if (l < d.Q && p < d.P) v += dyb[l * hP + p] * Y[i][j];
      }
      v = sum16(v);
      if (tx == 0 && l < d.Q) dLrow[l] += expf(Lq[l]) * v;
    }
  }
  dlast = block_sum(dlast, red8);
  dDsum = block_sum(dDsum, red8);
  const long long cell = (long long)blockIdx.x;
  for (int q = threadIdx.x; q < d.Q; q += THREADS)
    ddt[(pos0 + q) * d.h + hh] = dDt[q];
  if (threadIdx.x == 0) {
    float decay_term = 0.f;
    const int slots = d.ny * (THREADS / 32);
    for (int k = 0; k < slots; ++k) decay_term += part[cell * slots + k];
    float run = 0.f;
    for (int q = d.Q - 1; q >= 0; --q) {
      float v = dLrow[q] - dLcol[q];
      if (q == d.Q - 1) v += dlast + expf(Lend) * decay_term;
      run += v;
      dlt[(pos0 + q) * d.h + hh] = run;
    }
    dD[cell] = dDsum;
  }
}

// dS[l][m] = sum_h dMt_h[l][m] dt_h[m] G_h[l][m] of one (row, chunk,
// group) on one lower tile pair, the group's heads in order; grid
// (b*nc*G, pairs)
template <class T, bool GR>
__global__ void __launch_bounds__(THREADS)
    ds_kernel(const float* __restrict__ dy, const T* __restrict__ x,
              const float* __restrict__ dt, const float* __restrict__ Lc,
              float* __restrict__ dS, Dims d) {
  extern __shared__ float4 smem4[];
  Tile* t = reinterpret_cast<Tile*>(smem4);
  float* Ll = reinterpret_cast<float*>(t + 2);
  float* Lm = Ll + TILE;
  float* dm = Lm + TILE;
  const unsigned g = GR ? blockIdx.x % d.G : 0;
  const unsigned bc = GR ? blockIdx.x / d.G : blockIdx.x;
  const int bi = bc / d.nc, c = bc % d.nc;
  int lt, mt;
  pair_of(blockIdx.y, lt, mt);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long pos0 = (long long)bi * d.L + (long long)c * d.Q;
  const long long hP = (long long)d.h * d.P;
  const int h0 = GR ? (int)g * d.hg : 0, h1 = GR ? h0 + d.hg : d.h;
  float acc[4][4];
  zero(acc);
  for (int hh = h0; hh < h1; ++hh) {
    const int r = threadIdx.x;
    if (r < TILE) {
      const int l = lt * TILE + r, m = mt * TILE + r;
      Ll[r] = l < d.Q ? Lc[(pos0 + l) * d.h + hh] : 0.f;
      Lm[r] = m < d.Q ? Lc[(pos0 + m) * d.h + hh] : 0.f;
      dm[r] = m < d.Q ? dt[(pos0 + m) * d.h + hh] : 0.f;
    }
    const float* dyb = dy + pos0 * hP + (long long)hh * d.P;
    const T* xb = x + bi * d.xb + (long long)c * d.Q * d.xl + hh * d.xh;
    fill<true>(t[0], [&](int i, int c0, float (&v)[8]) {
      at8(dyb, hP, lt * TILE + i, d.Q, c0, d.P, v);
    });
    fill<true>(t[1], [&](int i, int c0, float (&v)[8]) {
      at8(xb, d.xl, mt * TILE + i, d.Q, c0, d.P, v);
    });
    __syncthreads();
    float dM[4][4];
    zero(dM);
    mma(dM, t[0], t[1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = lt * TILE + ty * 4 + i, m = mt * TILE + tx * 4 + j;
        if (l < d.Q && m <= l)
          acc[i][j] += (dM[i][j] * dm[tx * 4 + j]) *
                       decay(Ll[ty * 4 + i] - Lm[tx * 4 + j]);
      }
    __syncthreads();
  }
  float* o = dS + (long long)blockIdx.x * d.Q * d.Q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = lt * TILE + ty * 4 + i, m = mt * TILE + tx * 4 + j;
      if (l < d.Q && m < d.Q) o[l * d.Q + m] = acc[i][j];
    }
}

// dC (z even) or dB (z odd) of one (row, chunk, group) on one 64 x 64
// tile: the chunk's part from dS, then the state parts summed over the
// group's heads in order; grid (b*nc*G, row tiles, 2 * N tiles)
template <class T, bool GR>
__global__ void __launch_bounds__(THREADS)
    dbc_kernel(const float* __restrict__ dS, const T* __restrict__ x,
               const T* __restrict__ B, const T* __restrict__ C,
               const float* __restrict__ dy, const float* __restrict__ Hs,
               const float* __restrict__ dHe, const float* __restrict__ dt,
               const float* __restrict__ Lc, T* __restrict__ dB,
               T* __restrict__ dC, Dims d) {
  extern __shared__ float4 smem4[];
  Tile* t = reinterpret_cast<Tile*>(smem4);
  float* sv = reinterpret_cast<float*>(t + 2);
  const unsigned g = GR ? blockIdx.x % d.G : 0;
  const unsigned bc = GR ? blockIdx.x / d.G : blockIdx.x;
  const int bi = bc / d.nc, c = bc % d.nc;
  const int rt = blockIdx.y, n0 = (blockIdx.z >> 1) * TILE;
  const bool wantB = blockIdx.z & 1;
  const long long pos0 = (long long)bi * d.L + (long long)c * d.Q;
  const long long hP = (long long)d.h * d.P;
  const float* dSc = dS + (long long)blockIdx.x * d.Q * d.Q;
  const T* Bb = B + bi * d.Bb + (long long)c * d.Q * d.Bl + g * d.Bg;
  const T* Cb = C + bi * d.Cb + (long long)c * d.Q * d.Cl + g * d.Cg;
  float acc[4][4];
  zero(acc);
  if (!wantB) {  // dC[l] = sum_m dS[l][m] B[m]
    for (int mt = 0; mt <= rt; ++mt) {
      fill<true>(t[0], [&](int i, int c0, float (&v)[8]) {
        at8(dSc, d.Q, rt * TILE + i, d.Q, mt * TILE + c0, d.Q, v);
      });
      fill<false>(t[1], [&](int i, int c0, float (&v)[8]) {
        at8(Bb, d.Bl, mt * TILE + i, d.Q, n0 + c0, d.N, v);
      });
      __syncthreads();
      mma(acc, t[0], t[1]);
      __syncthreads();
    }
  } else {  // dB[m] = sum_l dS[l][m] C[l]
    for (int lt = rt; lt < d.nt; ++lt) {
      fill<false>(t[0], [&](int i, int c0, float (&v)[8]) {
        at8(dSc, d.Q, lt * TILE + i, d.Q, rt * TILE + c0, d.Q, v);
      });
      fill<false>(t[1], [&](int i, int c0, float (&v)[8]) {
        at8(Cb, d.Cl, lt * TILE + i, d.Q, n0 + c0, d.N, v);
      });
      __syncthreads();
      mma(acc, t[0], t[1]);
      __syncthreads();
    }
  }
  // dC[l] += sum_h exp(Lc_h[l]) dy_h[l] . H_h;
  // dB[m] += sum_h w_h[m] x_h[m] . dH_h, over the group's heads
  const int h0 = GR ? (int)g * d.hg : 0, h1 = GR ? h0 + d.hg : d.h;
  for (int hh = h0; hh < h1; ++hh) {
    const int r = threadIdx.x;
    const long long cell = (long long)bc * d.h + hh;
    if (r < TILE) {
      const int q = rt * TILE + r;
      float v = 0.f;
      if (q < d.Q) {
        const float Lv = Lc[(pos0 + q) * d.h + hh];
        v = wantB ? dt[(pos0 + q) * d.h + hh] *
                        expf(Lc[(pos0 + d.Q - 1) * d.h + hh] - Lv)
                  : expf(Lv);
      }
      sv[r] = v;
    }
    __syncthreads();
    const float* dyb = dy + pos0 * hP + (long long)hh * d.P;
    const T* xb = x + bi * d.xb + (long long)c * d.Q * d.xl + hh * d.xh;
    const float* St = (wantB ? dHe : Hs) + cell * d.P * d.N;
    fill<true>(t[0], [&](int i, int c0, float (&v)[8]) {
      const int q = rt * TILE + i;
      if (wantB)
        at8(xb, d.xl, q, d.Q, c0, d.P, v);
      else
        at8(dyb, hP, q, d.Q, c0, d.P, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = sv[i] * v[j];
    });
    fill<false>(t[1], [&](int p, int c0, float (&v)[8]) {
      at8(St, d.N, p, d.P, n0 + c0, d.N, v);
    });
    __syncthreads();
    mma(acc, t[0], t[1]);
    __syncthreads();
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  T* o = wantB ? dB : dC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = rt * TILE + ty * 4 + i, n = n0 + tx * 4 + j;
      if (q < d.Q && n < d.N)
        o[((pos0 + q) * groups<GR>(d) + g) * d.N + n] =
            from_f<T>(acc[i][j]);
    }
}

constexpr size_t TILE_BYTES = sizeof(Tile);
constexpr size_t SMEM_TWO = 2 * TILE_BYTES + 4 * TILE * sizeof(float);
constexpr size_t SMEM_STATES = 2 * TILE_BYTES + MAX_Q * sizeof(float);
constexpr size_t SMEM_DX = 5 * TILE_BYTES + 5 * MAX_Q * sizeof(float) +
                           (2 * 16 * TILE + 8) * sizeof(float);

// one launch: the kernel's shared memory opted in, the launch checked
template <class... KArgs, class... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, size_t smem,
                   cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

#define LAUNCH(...)                                     \
  do {                                                  \
    const cudaError_t e_ = launch(__VA_ARGS__);         \
    if (e_ != cudaSuccess) return (int)e_;              \
  } while (0)

// whether the state passing may move states four floats at a time: rows
// of P*N a multiple of 4 and every state array on 16 bytes
template <class... Ptrs>
bool four_aligned(const Dims& d, Ptrs... ps) {
  const void* all[] = {ps...};
  bool ok = (long long)d.P * d.N % 4 == 0;
  for (const void* p : all) ok = ok && ((size_t)p & 15) == 0;
  return ok;
}

bool valid(const Dims& d) {
  return d.b > 0 && d.h > 0 && d.P > 0 && d.P <= TILE && d.N > 0 &&
         d.Q > 0 && d.Q <= MAX_Q && d.L % d.Q == 0 && d.G > 0 &&
         d.h % d.G == 0 && (long long)d.b * d.nc * d.G <= (1ll << 30) &&
         (long long)d.b * d.nc * d.h <= (1ll << 30);
}

Dims make_dims(int b, int L, int h, int P, int N, int Q, int G,
               long long xb, long long xl, long long xh, long long Bb,
               long long Bl, long long Bg, long long Cb, long long Cl,
               long long Cg) {
  Dims d;
  d.b = b; d.L = L; d.h = h; d.P = P; d.N = N; d.Q = Q;
  d.G = G; d.hg = G > 0 ? h / G : 0;
  d.nc = Q > 0 ? L / Q : 0;
  d.nt = (Q + TILE - 1) / TILE;
  d.ny = (int)(((long long)P * N + PASS_SPAN - 1) / PASS_SPAN);
  d.xb = xb; d.xl = xl; d.xh = xh;
  d.Bb = Bb; d.Bl = Bl; d.Bg = Bg; d.Cb = Cb; d.Cl = Cl; d.Cg = Cg;
  return d;
}

template <class T, bool GR>
int forward(const T* x, const T* B, const T* C, const float* dt,
            const float* Lc, const float* Dp, const float* state0, float* y,
            float* final_state, float* S, float* Hs, const Dims& d,
            cudaStream_t st) {
  const int pairs = d.nt * (d.nt + 1) / 2;
  const int ntn = (d.N + TILE - 1) / TILE;
  const unsigned cells = (unsigned)(d.b * d.nc * d.h);
  LAUNCH((cb_kernel<T, GR>), dim3(d.b * d.nc * d.G, pairs), SMEM_TWO, st, B,
         C, S, d);
  LAUNCH((states_kernel<T, T, false, GR>), dim3(cells, ntn), SMEM_STATES, st,
         x, d.xb, d.xl, d.xh, B, d.Bb, d.Bl, d.Bg, dt, Lc, Hs, d);
  const bool vec = four_aligned(d, Hs, state0, final_state);
  LAUNCH(vec ? pass_kernel<true> : pass_kernel<false>, dim3(d.b * d.h, d.ny),
         0, st, Hs, state0, final_state, Lc, d);
  LAUNCH((out_kernel<T, GR>), dim3(cells, d.nt), SMEM_TWO, st, x, C, S, Hs,
         dt, Lc, Dp, y, d);
  return (int)cudaSuccess;
}

// one group or several: separate instantiations (groups<GR>)
template <class T>
int forward(const T* x, const T* B, const T* C, const float* dt,
            const float* Lc, const float* Dp, const float* state0, float* y,
            float* final_state, float* S, float* Hs, const Dims& d,
            cudaStream_t st) {
  return d.G == 1 ? forward<T, false>(x, B, C, dt, Lc, Dp, state0, y,
                                      final_state, S, Hs, d, st)
                  : forward<T, true>(x, B, C, dt, Lc, Dp, state0, y,
                                     final_state, S, Hs, d, st);
}

template <class T, bool GR>
int backward(const T* x, const T* B, const T* C, const float* dt,
             const float* Lc, const float* Dp, const float* S,
             const float* Hs, const float* dy, const float* dfinal,
             float* dHe, float* part, float* dS, T* dx, T* dB, T* dC,
             float* ddt, float* dlt, float* dD, float* dstate0,
             const Dims& d, cudaStream_t st) {
  const int pairs = d.nt * (d.nt + 1) / 2;
  const int ntn = (d.N + TILE - 1) / TILE;
  const unsigned cells = (unsigned)(d.b * d.nc * d.h);
  const long long hP = (long long)d.h * d.P;
  LAUNCH((states_kernel<float, T, true, GR>), dim3(cells, ntn), SMEM_STATES,
         st,
         dy, (long long)d.L * hP, hP, (long long)d.P, C, d.Cb, d.Cl, d.Cg, dt,
         Lc, dHe, d);
  const bool vec = four_aligned(d, dHe, Hs, dfinal, dstate0);
  LAUNCH(vec ? pass_bwd_kernel<true> : pass_bwd_kernel<false>,
         dim3(d.b * d.h, d.ny), 0, st, dHe, Hs, dfinal, dstate0, part, Lc, d);
  LAUNCH((dx_kernel<T, GR>), dim3(cells), SMEM_DX, st, x, B, C, S, Hs, dHe,
         dy, dt,
         Lc, part, Dp, dx, ddt, dlt, dD, d);
  LAUNCH((ds_kernel<T, GR>), dim3(d.b * d.nc * d.G, pairs), SMEM_TWO, st, dy,
         x, dt, Lc, dS, d);
  LAUNCH((dbc_kernel<T, GR>), dim3(d.b * d.nc * d.G, d.nt, 2 * ntn), SMEM_TWO,
         st, dS, x, B, C, dy, Hs, dHe, dt, Lc, dB, dC, d);
  return (int)cudaSuccess;
}

template <class T>
int backward(const T* x, const T* B, const T* C, const float* dt,
             const float* Lc, const float* Dp, const float* S,
             const float* Hs, const float* dy, const float* dfinal,
             float* dHe, float* part, float* dS, T* dx, T* dB, T* dC,
             float* ddt, float* dlt, float* dD, float* dstate0,
             const Dims& d, cudaStream_t st) {
  return d.G == 1
             ? backward<T, false>(x, B, C, dt, Lc, Dp, S, Hs, dy, dfinal, dHe,
                                  part, dS, dx, dB, dC, ddt, dlt, dD, dstate0,
                                  d, st)
             : backward<T, true>(x, B, C, dt, Lc, Dp, S, Hs, dy, dfinal, dHe,
                                 part, dS, dx, dB, dC, ddt, dlt, dD, dstate0,
                                 d, st);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B and C; everything else float32).
// x (b, L, h, P) and B, C (b, L, G, N) by their strides in elements, the
// last dim contiguous; head hh reads group hh / (h / G), and G divides h.
// dt, Lc (b, L, h), y (b, L, h, P), states (b, h, P, N), S
// (b, L/Q, G, Q, Q) and Hs (b, L/Q, h, P, N) contiguous.
extern "C" int repro_ssd_scan(const void* x, const void* B, const void* C,
                              const void* dt, const void* Lc, const void* Dp,
                              const void* state0, void* y, void* final_state,
                              void* S, void* Hs, int b, int L, int h, int P,
                              int N, int Q, int G, long long xb, long long xl,
                              long long xh, long long Bb, long long Bl,
                              long long Bg, long long Cb, long long Cl,
                              long long Cg, int dtype, void* stream) {
  const Dims d =
      make_dims(b, L, h, P, N, Q, G, xb, xl, xh, Bb, Bl, Bg, Cb, Cl, Cg);
  if (!valid(d) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *f_dt = (const float*)dt, *f_Lc = (const float*)Lc,
              *f_Dp = (const float*)Dp, *f_s0 = (const float*)state0;
  if (dtype == 0)
    return forward((const float*)x, (const float*)B, (const float*)C, f_dt,
                   f_Lc, f_Dp, f_s0, (float*)y, (float*)final_state,
                   (float*)S, (float*)Hs, d, st);
  return forward((const __nv_bfloat16*)x, (const __nv_bfloat16*)B,
                 (const __nv_bfloat16*)C, f_dt, f_Lc, f_Dp, f_s0, (float*)y,
                 (float*)final_state, (float*)S, (float*)Hs, d, st);
}

// dy (b, L, h, P) and dfinal (b, h, P, N, or null) float32 contiguous;
// scratch dHe like Hs, part (b, L/Q, h, 8 ny), dS like S; dx (b, L, h, P),
// dB and dC (b, L, G, N) contiguous in the operands' type; ddt, dlt
// (b, L, h), dD (b, L/Q, h: each chunk's share) and dstate0 (b, h, P, N)
// float32.
extern "C" int repro_ssd_scan_backward(
    const void* x, const void* B, const void* C, const void* dt,
    const void* Lc, const void* Dp, const void* S, const void* Hs,
    const void* dy, const void* dfinal, void* dHe, void* part, void* dS,
    void* dx, void* dB, void* dC, void* ddt, void* dlt, void* dD,
    void* dstate0, int b, int L, int h, int P, int N, int Q, int G,
    long long xb, long long xl, long long xh, long long Bb, long long Bl,
    long long Bg, long long Cb, long long Cl, long long Cg, int dtype,
    void* stream) {
  const Dims d =
      make_dims(b, L, h, P, N, Q, G, xb, xl, xh, Bb, Bl, Bg, Cb, Cl, Cg);
  if (!valid(d) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *f_dt = (const float*)dt, *f_Lc = (const float*)Lc,
              *f_Dp = (const float*)Dp, *f_S = (const float*)S,
              *f_Hs = (const float*)Hs, *f_dy = (const float*)dy,
              *f_df = (const float*)dfinal;
  float *f_dHe = (float*)dHe, *f_part = (float*)part, *f_dS = (float*)dS,
        *f_ddt = (float*)ddt, *f_dlt = (float*)dlt, *f_dD = (float*)dD,
        *f_ds0 = (float*)dstate0;
  if (dtype == 0)
    return backward((const float*)x, (const float*)B, (const float*)C, f_dt,
                    f_Lc, f_Dp, f_S, f_Hs, f_dy, f_df, f_dHe, f_part, f_dS,
                    (float*)dx, (float*)dB, (float*)dC, f_ddt, f_dlt, f_dD,
                    f_ds0, d, st);
  return backward((const __nv_bfloat16*)x, (const __nv_bfloat16*)B,
                  (const __nv_bfloat16*)C, f_dt, f_Lc, f_Dp, f_S, f_Hs, f_dy,
                  f_df, f_dHe, f_part, f_dS, (__nv_bfloat16*)dx,
                  (__nv_bfloat16*)dB, (__nv_bfloat16*)dC, f_ddt, f_dlt,
                  f_dD, f_ds0, d, st);
}

// The backward's scratch `part`, in floats a (row, chunk, head): each
// warp of the reverse state passing leaves its share of the chunk's decay
// term there.  The wrapper sizes `part` from this, never from a copy of
// the kernels' constants.
extern "C" int repro_ssd_scan_backward_scratch(int P, int N,
                                               long long* slots) {
  if (P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(1, 1, 1, P, N, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0);
  *slots = (long long)d.ny * (THREADS / 32);
  return (int)cudaSuccess;
}
