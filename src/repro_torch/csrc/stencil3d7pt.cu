// 3D 7-point star stencil (paper Listing 1) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/stencil3d7pt.py:_kernel /
// stencil3d7pt() (pl.pallas_call at line 77), and computes exactly what it
// computes: for the interior, with coefficients (W, E, N, S, F, B, s),
//   b = cW*a[k][j][i-1] + cE*a[k][j][i+1] + cN*a[k][j-1][i] + cS*a[k][j+1][i]
//     + cF*a[k-1][j][i] + cB*a[k+1][j][i] + s*a[k][j][i]
// summed in that order; planes k = 0 and k = M-1 and the in-plane edges
// copy a.  The output is a new buffer; fp32 throughout.
//
// What bounds it on the H100: HBM bytes.  It does 13 flops per point
// against 8 bytes that must move (a read once, b written once), far below
// the card's ~20 flop/byte balance point for fp32.  At the bound a 512^3
// grid retires about 1.6 points per cycle per SM.
//
// What the design does about it.  Streaming at 3.35 TB/s with ~0.7 us of
// loaded latency needs ~2.3 MB of reads in flight, ~18 KB per SM
// (Little's law); the register-queue kernel this replaces held one or two
// 4-byte loads per thread and met a barrier, and each k step took about
// one memory latency.  Here the planes come in by asynchronous copies
// into a ring of S stages in shared memory (stencil_ring.cuh): while plane
// p is used, planes p+1 .. p+D (D = S - 3) are in flight and cost no
// registers.  A stage is the CTA's (bj, bi) tile of one plane with a halo
// of 1.  Each thread owns C consecutive rows of one column (a strip) and
// keeps a[k-1], a[k], a[k+1] of its C cells in registers, read from the
// ring once per plane; the j neighbours inside the strip come from those
// registers, so a point reads its two i neighbours, 2/C j neighbours and
// its own next-plane cell from shared memory: 3 + 2/C words (3.5 at
// C = 4, 14 bytes per point against the SM's 128 bytes per cycle).  All
// in-plane arithmetic is 32-bit and hoisted out of the march (64-bit
// index arithmetic per copied row costs more issue slots than the
// stencil itself).  Boundary points store their own cell, a bit-exact
// copy of a.  k is split into chunks of output planes (grid z), each
// loading the plane on either side again, where the tiles alone leave an
// SM short of warps: at 512^3 the advisor's (32, 64) tiles at C = 4 are
// 128 CTAs of 16 warps, and chunks of 103 planes make 640.  The advisor
// (core/blocking.py, from the plan sweeps) picks (bj, bi) = (32, 64),
// C = 4, S = 5 and the chunk; repro_stencil3d7pt_limits states the launch
// rule it is held to.
//
// C interface (bound with ctypes): repro_stencil3d7pt(...) launches on the
// given stream, does not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil_ring.cuh"

namespace {

constexpr int R = 1;  // stencil radius

template <int C>
__global__ void __launch_bounds__(ring::MAX_THREADS)
stencil3d7pt_kernel(const float* __restrict__ a, float* __restrict__ out,
                    int M, int N, int S, int chunk, float cW, float cE,
                    float cN, float cS, float cF, float cB, float cs) {
  extern __shared__ float smem[];
  const int bi = blockDim.x, tys = blockDim.y, bj = tys * C;
  const int W = bi + 2 * R, HW = W * (bj + 2 * R);
  const int D = S - R - 2;  // planes in flight while a step waits
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int f = ty * bi + tx, T = bi * tys;
  const int i0 = blockIdx.x * bi, j0 = blockIdx.y * bj;
  const int i = i0 + tx, jb = j0 + ty * C;
  const int64_t plane = (int64_t)N * N;
  int* const table = reinterpret_cast<int*>(smem + S * HW);
  ring::build_table(table, bj + 2 * R, W, R, j0, i0, N, f, T);
  __syncthreads();

  // output planes [o0, o1) of this chunk; planes [p0, p1) are loaded
  const int o0 = blockIdx.z * chunk, o1 = min(M, o0 + chunk);
  const int p0 = max(0, o0 - R), p1 = min(M, o1 + R);
  const int own = (ty * C + R) * W + tx + R;  // first cell, in a stage
  const bool edge_i = i < R || i >= N - R;
  unsigned valid = 0, inner = 0;  // bit m: row jb + m inside, interior
#pragma unroll
  for (int m = 0; m < C; ++m) {
    const int j = jb + m;
    valid |= (unsigned)(i < N && j < N) << m;
    inner |= (unsigned)(!edge_i && j >= R && j < N - R) << m;
  }
  float* const outp = out + (jb * N + i);

  for (int n = 0; n < D; ++n) {
    if (p0 + n < p1)
      ring::copy_haloed(smem + n * HW, a + (p0 + n) * plane, table, HW, f, T);
    ring::commit();
  }
  float q[3][C];  // a[o-1], a[o], a[o+1] of the strip, o the output plane
#pragma unroll
  for (int m = 0; m < C; ++m) q[1][m] = q[2][m] = 0.f;

  // stages of march plane n + D (written), n (landed) and n - R (output's)
  int s_in = D, s_cur = 0, s_out = S - R;
  for (int p = p0; p < o1 + R; ++p) {
    if (p + D < p1)
      ring::copy_haloed(smem + s_in * HW, a + (p + D) * plane, table, HW, f,
                        T);
    ring::commit();
    ring::wait_pending(D);
    __syncthreads();
    const float* const cur = smem + s_cur * HW + own;
#pragma unroll
    for (int m = 0; m < C; ++m) {
      q[0][m] = q[1][m];
      q[1][m] = q[2][m];
      q[2][m] = p < M ? cur[m * W] : 0.f;
    }
    const float* const c = smem + s_out * HW + own;
    s_in = s_in + 1 == S ? 0 : s_in + 1;
    s_cur = s_cur + 1 == S ? 0 : s_cur + 1;
    s_out = s_out + 1 == S ? 0 : s_out + 1;
    const int o = p - R;
    if (o < o0) continue;
    const bool inner_k = o > 0 && o < M - 1;
    float* const op = outp + o * plane;
#pragma unroll
    for (int m = 0; m < C; ++m) {
      if (!((valid >> m) & 1u)) continue;
      float r = q[1][m];
      if (inner_k && ((inner >> m) & 1u)) {
        const float* const x = c + m * W;
        const float up = m > 0 ? q[1][m - 1] : x[-W];
        const float down = m < C - 1 ? q[1][m + 1] : x[W];
        r = cW * x[-1] + cE * x[1] + cN * up + cS * down + cF * q[0][m]
            + cB * q[2][m] + cs * q[1][m];
      }
      op[m * N] = r;
    }
  }
}

template <int C>
cudaError_t launch(const float* a, float* out, long long M, long long N,
                   int bj, int bi, int S, int chunk, const float* c,
                   size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stencil3d7pt_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(bi, bj / C);
  const dim3 grid((unsigned)((N + bi - 1) / bi), (unsigned)((N + bj - 1) / bj),
                  (unsigned)((M + chunk - 1) / chunk));
  stencil3d7pt_kernel<C><<<grid, block, smem, stream>>>(
      a, out, (int)M, (int)N, S, chunk, c[0], c[1], c[2], c[3], c[4], c[5],
      c[6]);
  return cudaGetLastError();
}

bool built(int c) { return c == 1 || c == 2 || c == 4 || c == 8; }

}  // namespace

// The CTA's shared-memory bytes and threads for a plan, or
// cudaErrorInvalidValue for a plan the kernel cannot take.
extern "C" int repro_stencil3d7pt_limits(int bj, int bi, int c, int stages,
                                         long long* smem, int* threads) {
  return (int)ring::limits(R, 0, built(c), bj, bi, c, stages, smem, threads);
}

extern "C" int repro_stencil3d7pt(const float* a, float* out, long long M,
                                  long long N, int bj, int bi, int c,
                                  int stages, int chunk, float cW, float cE,
                                  float cN, float cS, float cF, float cB,
                                  float cs, void* stream) {
  long long smem;
  int threads;
  const cudaError_t e = ring::limits(R, 0, built(c), bj, bi, c, stages,
                                     &smem, &threads);
  if (e != cudaSuccess) return (int)e;
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (!ring::grid_ok(M, N, bj, bi, chunk)) return (int)cudaErrorInvalidValue;
  const float co[7] = {cW, cE, cN, cS, cF, cB, cs};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 1: return (int)launch<1>(a, out, M, N, bj, bi, stages, chunk, co, smem, s);
    case 2: return (int)launch<2>(a, out, M, N, bj, bi, stages, chunk, co, smem, s);
    case 4: return (int)launch<4>(a, out, M, N, bj, bi, stages, chunk, co, smem, s);
    default: return (int)launch<8>(a, out, M, N, bj, bi, stages, chunk, co, smem, s);
  }
}
