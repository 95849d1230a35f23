// 3D long-range star stencil (paper Listing 3, radius 4, 25 points) for
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/longrange3d.py:_kernel /
// longrange3d() (pl.pallas_call at line 91), and computes exactly what it
// computes: for the interior,
//   lap = c0*V + sum_{d=1..4} c_d * (V[i+d] + V[i-d] + V[j+d] + V[j-d]
//                                    + V[k+d] + V[k-d])
//   U'  = 2*V - U + ROC*lap
// with the sums taken in that order; a boundary of width 4 in every
// dimension copies u (not v), so a grid with an extent of at most 8
// returns u.  The output is a new buffer; fp32 throughout.
//
// What bounds it on the H100: HBM bytes.  It does 33 flops per point
// against 16 bytes that must move (u, v, roc read once, the result written
// once), below the card's ~20 flop/byte balance point for fp32.  At the
// bound the paper's (130, 1015, 1015) grid retires about 0.8 points per
// cycle per SM.
//
// What the design does about it.  The planes come in by asynchronous
// copies into a ring of S stages in shared memory (stencil_ring.cuh), so
// D = S - 6 planes are in flight, costing no registers, while a step
// waits: about 18 KB per SM is what Little's law asks for at the HBM rate
// (the register-queue kernel this replaces waited about one memory
// latency per k step).  A stage holds the CTA's (bj, bi) tile of one v
// plane with a halo of 4; u and roc of the output plane go to a second,
// bare ring of S - 4 stages, copied with the v plane that completes the
// output's k neighbourhood.  Each thread owns C consecutive rows of one
// column (a strip) and keeps V[o-4] .. V[o+4] of its C cells in registers
// (9C), read from the ring once per plane; the j neighbours inside the
// strip come from those registers too.  A point reads from shared memory
// its 8 i neighbours, the j neighbours past its strip's ends, its
// next-plane v cell, u and roc: 16 words at C = 4 (64 bytes), where
// reading all 25 v values would take 80 of the SM's 128 bytes per cycle
// before the ring's own writes.  The output plane o's tile stays in the
// ring until plane o + 4 lands, which is why S counts 4 + 2 stages
// beyond those in flight.  All in-plane arithmetic is 32-bit and hoisted
// out of the march.  Boundary points store their u cell, a bit-exact copy.
// k may be split into chunks of output planes (grid z); on the paper's
// grid the advisor marches all of it, since its (32, 64) tiles at C = 4
// already make 512 CTAs of 16 warps, one per SM at S = 8 (165 KiB).  The
// advisor (core/blocking.py, from the plan sweeps) picks the plan;
// repro_longrange3d_limits states the launch rule it is held to.
//
// C interface (bound with ctypes): repro_longrange3d(...) launches on the
// given stream, does not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil_ring.cuh"

namespace {

constexpr int R = 4;    // stencil radius
constexpr int OWN = 2;  // bare tiles per stage: u and roc

template <int C>
__global__ void __launch_bounds__(ring::MAX_THREADS)
longrange3d_kernel(const float* __restrict__ u, const float* __restrict__ v,
                   const float* __restrict__ roc, float* __restrict__ out,
                   int M, int N, int S, int chunk, float c0, float c1,
                   float c2, float c3, float c4) {
  extern __shared__ float smem[];
  const int bi = blockDim.x, tys = blockDim.y, bj = tys * C;
  const int W = bi + 2 * R, HW = W * (bj + 2 * R);
  const int D = S - R - 2;      // planes in flight while a step waits
  const int SU = S - R;         // stages of the bare u and roc tiles
  const int tile = bj * bi;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int f = ty * bi + tx, T = bi * tys;
  const int i0 = blockIdx.x * bi, j0 = blockIdx.y * bj;
  const int i = i0 + tx, jb = j0 + ty * C;
  const int64_t plane = (int64_t)N * N;
  float* const bare = smem + S * HW;  // SU stages of u then roc
  int* const table = reinterpret_cast<int*>(bare + SU * OWN * tile);
  ring::build_table(table, bj + 2 * R, W, R, j0, i0, N, f, T);
  __syncthreads();

  // output planes [o0, o1) of this chunk; planes [p0, p1) are loaded
  const int o0 = blockIdx.z * chunk, o1 = min(M, o0 + chunk);
  const int p0 = max(0, o0 - R), p1 = min(M, o1 + R);
  const int own = (ty * C + R) * W + tx + R;  // first cell, in a stage
  const int own_u = ty * C * bi + tx;         // first cell, in a bare tile
  const int at = jb * N + i;                  // first cell, in a plane
  const bool edge_i = i < R || i >= N - R;
  unsigned valid = 0, inner = 0;  // bit m: row jb + m inside, interior
#pragma unroll
  for (int m = 0; m < C; ++m) {
    const int j = jb + m;
    valid |= (unsigned)(i < N && j < N) << m;
    inner |= (unsigned)(!edge_i && j >= R && j < N - R) << m;
  }
  const float c[R + 1] = {c0, c1, c2, c3, c4};

  // the copies of march plane p + D: v (haloed) while inside the loaded
  // planes, u and roc of plane p + D - R while it is an output plane
  const auto copy = [&](int p, int s, int su) {
    if (p < p1)
      ring::copy_haloed(smem + s * HW, v + p * plane, table, HW, f, T);
    const int o = p - R;
    if (o >= o0 && o < o1) {
      float* const b = bare + su * OWN * tile + own_u;
      ring::copy_own<C>(b, u + o * plane, at, N, bi, valid);
      ring::copy_own<C>(b + tile, roc + o * plane, at, N, bi, valid);
    }
  };
  for (int n = 0; n < D; ++n) {
    copy(p0 + n, n, n);
    ring::commit();
  }
  float q[2 * R + 1][C];  // V[o-4] .. V[o+4] of the strip, o the output
#pragma unroll
  for (int d = 0; d <= 2 * R; ++d)
#pragma unroll
    for (int m = 0; m < C; ++m) q[d][m] = 0.f;

  // stages of march plane n + D (written), n (landed) and n - R (output's);
  // bare stages of plane n + D (written) and n (landed)
  int s_in = D, s_cur = 0, s_out = S - R, b_in = D, b_cur = 0;
  for (int p = p0; p < o1 + R; ++p) {
    copy(p + D, s_in, b_in);
    ring::commit();
    ring::wait_pending(D);
    __syncthreads();
    const float* const cur = smem + s_cur * HW + own;
#pragma unroll
    for (int m = 0; m < C; ++m) {
#pragma unroll
      for (int d = 0; d < 2 * R; ++d) q[d][m] = q[d + 1][m];
      q[2 * R][m] = p < M ? cur[m * W] : 0.f;
    }
    const float* const x0 = smem + s_out * HW + own;
    const float* const ub = bare + b_cur * OWN * tile + own_u;
    s_in = s_in + 1 == S ? 0 : s_in + 1;
    s_cur = s_cur + 1 == S ? 0 : s_cur + 1;
    s_out = s_out + 1 == S ? 0 : s_out + 1;
    b_in = b_in + 1 == SU ? 0 : b_in + 1;
    b_cur = b_cur + 1 == SU ? 0 : b_cur + 1;
    const int o = p - R;
    if (o < o0) continue;
    const bool inner_k = o >= R && o < M - R;
    float* const op = out + o * plane + at;
#pragma unroll
    for (int m = 0; m < C; ++m) {
      if (!((valid >> m) & 1u)) continue;
      const float uk = ub[m * bi];  // u and roc of plane o
      float r = uk;
      if (inner_k && ((inner >> m) & 1u)) {
        const float rk = ub[tile + m * bi];
        const float* const x = x0 + m * W;
        float lap = c[0] * q[R][m];
#pragma unroll
        for (int d = 1; d <= R; ++d) {
          const float jp = m + d < C ? q[R][m + d] : x[d * W];
          const float jm = m - d >= 0 ? q[R][m - d] : x[-d * W];
          lap = lap + c[d] * (x[d] + x[-d] + jp + jm + q[R + d][m]
                              + q[R - d][m]);
        }
        r = 2.0f * q[R][m] - uk + rk * lap;
      }
      op[m * N] = r;
    }
  }
}

template <int C>
cudaError_t launch(const float* u, const float* v, const float* roc,
                   float* out, long long M, long long N, int bj, int bi,
                   int S, int chunk, const float* c, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        longrange3d_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(bi, bj / C);
  const dim3 grid((unsigned)((N + bi - 1) / bi), (unsigned)((N + bj - 1) / bj),
                  (unsigned)((M + chunk - 1) / chunk));
  longrange3d_kernel<C><<<grid, block, smem, stream>>>(
      u, v, roc, out, (int)M, (int)N, S, chunk, c[0], c[1], c[2], c[3], c[4]);
  return cudaGetLastError();
}

bool built(int c) { return c == 1 || c == 2 || c == 4 || c == 8; }

}  // namespace

// The CTA's shared-memory bytes and threads for a plan, or
// cudaErrorInvalidValue for a plan the kernel cannot take.
extern "C" int repro_longrange3d_limits(int bj, int bi, int c, int stages,
                                        long long* smem, int* threads) {
  return (int)ring::limits(R, OWN, built(c), bj, bi, c, stages, smem,
                           threads);
}

extern "C" int repro_longrange3d(const float* u, const float* v,
                                 const float* roc, float* out, long long M,
                                 long long N, int bj, int bi, int c,
                                 int stages, int chunk, float c0, float c1,
                                 float c2, float c3, float c4, void* stream) {
  long long smem;
  int threads;
  const cudaError_t e = ring::limits(R, OWN, built(c), bj, bi, c, stages,
                                     &smem, &threads);
  if (e != cudaSuccess) return (int)e;
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (!ring::grid_ok(M, N, bj, bi, chunk)) return (int)cudaErrorInvalidValue;
  const float co[5] = {c0, c1, c2, c3, c4};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 1:
      return (int)launch<1>(u, v, roc, out, M, N, bj, bi, stages, chunk, co,
                            smem, s);
    case 2:
      return (int)launch<2>(u, v, roc, out, M, N, bj, bi, stages, chunk, co,
                            smem, s);
    case 4:
      return (int)launch<4>(u, v, roc, out, M, N, bj, bi, stages, chunk, co,
                            smem, s);
    default:
      return (int)launch<8>(u, v, roc, out, M, N, bj, bi, stages, chunk, co,
                            smem, s);
  }
}
