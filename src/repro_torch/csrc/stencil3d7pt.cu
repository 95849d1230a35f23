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
// the card's ~20 flop/byte balance point for fp32.
//
// What the design does about it (2.5-D blocking): the Pallas kernel holds
// three whole (N, N) planes in VMEM; a CTA here holds one (bj, bi) tile of
// one plane in shared memory and marches k from 0 to M-1.  Each thread owns
// one (j, i) column and keeps a[k-1] .. a[k+P] of that column in a register
// queue; threads on the tile's rim also hold their halo cells of the next
// plane (halo.cuh).  Each k step stores the thread's own a[k] and its halo
// cells into the shared tile, then issues the loads of the queue front (P
// planes ahead) and of the next plane's halo before the barrier, so no
// load is waited for in the step that issues it.  (With one load per
// column in flight, the whole card holds one plane of loads in flight and
// each step waits a memory latency.)  Every element of a comes from HBM
// once as the front of the queue, plus the halo ring, which neighbouring
// CTAs fetch too and the L2 mostly serves: the 3D layer condition realised
// in shared memory instead of a cache.  Two tiles are used in turn, so one
// barrier per k step suffices.  A launch needs bj >= R and bi >= R.
//
// C interface (bound with ctypes): repro_stencil3d7pt(...) launches on the
// given stream, does not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "halo.cuh"

namespace {

constexpr int R = 1;           // stencil radius
constexpr int P = 2;           // queue planes loaded ahead of use
constexpr int L = R + P - 1;   // furthest plane ahead in the queue
constexpr int Q = R + 1 + L;   // register queue length along k

__global__ void __launch_bounds__(1024)
stencil3d7pt_kernel(const float* __restrict__ a, float* __restrict__ out,
                    int64_t M, int64_t N, float cW, float cE, float cN,
                    float cS, float cF, float cB, float cs) {
  extern __shared__ float smem[];  // 2 tiles of (bj + 2R) x (bi + 2R)
  const int bi = blockDim.x, bj = blockDim.y;
  const int tw = bi + 2 * R, tsize = tw * (bj + 2 * R);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t i0 = (int64_t)blockIdx.x * bi, j0 = (int64_t)blockIdx.y * bj;
  const int64_t i = i0 + tx, j = j0 + ty;
  const int64_t plane = N * N;
  const bool inside = i < N && j < N;  // masks the ragged edge tiles
  const bool edge = i < R || i >= N - R || j < R || j >= N - R;
  const int64_t col = j * N + i;
  const int own = (ty + R) * tw + tx + R;
  Halo halo = halo_cells(R, tx, ty, bi, bj, i0, j0, N);

  // q[R + d] holds a[k + d] of this column at step k
  float q[Q];
#pragma unroll
  for (int d = 0; d < Q; ++d)
    q[d] = (inside && d >= R && d < Q - 1 && d - R < M)
               ? a[(d - R) * plane + col] : 0.f;
  halo.load(a);

  for (int64_t k = 0; k < M; ++k) {
    float* const tile = smem + (k & 1) * tsize;
    tile[own] = q[R];
    halo.store(tile);
    // loads for later steps, issued before this step's barrier
    if (inside && k + L < M) q[Q - 1] = a[(k + L) * plane + col];
    if (k + 1 < M) halo.load(a + (k + 1) * plane);
    __syncthreads();  // the next step fills the other tile
    if (inside) {
      float r = q[R];
      if (k > 0 && k < M - 1 && !edge) {
        const float* const c = tile + own;
        r = cW * c[-1] + cE * c[1] + cN * c[-tw] + cS * c[tw]
            + cF * q[R - 1] + cB * q[R + 1] + cs * q[R];
      }
      out[k * plane + col] = r;
    }
#pragma unroll
    for (int d = 0; d < Q - 1; ++d) q[d] = q[d + 1];
    q[Q - 1] = 0.f;
  }
}

}  // namespace

extern "C" int repro_stencil3d7pt(const float* a, float* out, long long M,
                                  long long N, int bj, int bi, float cW,
                                  float cE, float cN, float cS, float cF,
                                  float cB, float cs, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (bj < R || bi < R) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * (size_t)(bj + 2 * R) * (bi + 2 * R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stencil3d7pt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(bi, bj);
  const dim3 grid((unsigned)((N + bi - 1) / bi), (unsigned)((N + bj - 1) / bj));
  stencil3d7pt_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      a, out, (int64_t)M, (int64_t)N, cW, cE, cN, cS, cF, cB, cs);
  return (int)cudaGetLastError();
}
