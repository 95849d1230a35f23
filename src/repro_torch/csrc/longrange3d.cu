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
// dimension copies u (not v).  The output is a new buffer; fp32 throughout.
//
// What bounds it on the H100: HBM bytes.  It does 33 flops per point
// against 16 bytes that must move (u, v, roc read once, the result written
// once), below the card's ~20 flop/byte balance point for fp32.
//
// What the design does about it (2.5-D blocking): the Pallas kernel holds
// nine whole V planes plus U and ROC in VMEM; a CTA here holds one
// (bj + 8, bi + 8) haloed tile of one V plane in shared memory and marches
// k from 0 to M-1.  Each thread owns one (j, i) column and keeps
// V[k-4] .. V[k+4+P-1] of that column in a register queue; threads on the
// tile's rim also hold their halo cells of the next V plane (halo.cuh); u
// and roc are read once, at the point.  Each k step stores the thread's own
// V[k] and its halo cells into the shared tile, then issues the loads of
// the queue front, of the next plane's halo and of the next u and roc
// before the barrier, so no load is waited for in the step that issues it.
// V comes from HBM once as the queue front plus the halo ring, which
// neighbouring CTAs fetch too and the L2 mostly serves.  Two tiles are used
// in turn, so one barrier per k step suffices.  A launch needs bj >= R and
// bi >= R.
//
// C interface (bound with ctypes): repro_longrange3d(...) launches on the
// given stream, does not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "halo.cuh"

namespace {

constexpr int R = 4;           // stencil radius
constexpr int P = 2;           // queue planes loaded ahead of use
constexpr int L = R + P - 1;   // furthest V plane ahead in the queue
constexpr int Q = R + 1 + L;   // register queue length along k

__global__ void __launch_bounds__(1024)
longrange3d_kernel(const float* __restrict__ u, const float* __restrict__ v,
                   const float* __restrict__ roc, float* __restrict__ out,
                   int64_t M, int64_t N, float c0, float c1, float c2,
                   float c3, float c4) {
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
  const float c[R + 1] = {c0, c1, c2, c3, c4};
  Halo halo = halo_cells(R, tx, ty, bi, bj, i0, j0, N);
  const auto interior = [&](int64_t k) {
    return inside && !edge && k >= R && k < M - R;
  };

  // q[R + d] holds V[k + d] of this column at step k
  float q[Q];
#pragma unroll
  for (int d = 0; d < Q; ++d)
    q[d] = (inside && d >= R && d < Q - 1 && d - R < M)
               ? v[(d - R) * plane + col] : 0.f;
  halo.load(v);
  float uk = inside ? u[col] : 0.f;      // u and roc at this step's plane
  float rk = interior(0) ? roc[col] : 0.f;

  for (int64_t k = 0; k < M; ++k) {
    const int64_t at = k * plane + col;
    float* const tile = smem + (k & 1) * tsize;
    tile[own] = q[R];
    halo.store(tile);
    // loads for later steps, issued before this step's barrier
    if (inside && k + L < M) q[Q - 1] = v[at + L * plane];
    if (k + 1 < M) halo.load(v + (k + 1) * plane);
    const float un = inside && k + 1 < M ? u[at + plane] : 0.f;
    const float rn = interior(k + 1) ? roc[at + plane] : 0.f;
    __syncthreads();  // the next step fills the other tile
    if (inside) {
      float r = uk;
      if (interior(k)) {
        const float* const t = tile + own;
        float lap = c[0] * q[R];
#pragma unroll
        for (int d = 1; d <= R; ++d) {
          lap = lap + c[d] * (t[d] + t[-d] + t[d * tw] + t[-d * tw]
                              + q[R + d] + q[R - d]);
        }
        r = 2.0f * q[R] - uk + rk * lap;
      }
      out[at] = r;
    }
#pragma unroll
    for (int d = 0; d < Q - 1; ++d) q[d] = q[d + 1];
    q[Q - 1] = 0.f;
    uk = un;
    rk = rn;
  }
}

}  // namespace

extern "C" int repro_longrange3d(const float* u, const float* v,
                                 const float* roc, float* out, long long M,
                                 long long N, int bj, int bi, float c0,
                                 float c1, float c2, float c3, float c4,
                                 void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (bj < R || bi < R) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * (size_t)(bj + 2 * R) * (bi + 2 * R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        longrange3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(bi, bj);
  const dim3 grid((unsigned)((N + bi - 1) / bi), (unsigned)((N + bj - 1) / bj));
  longrange3d_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      u, v, roc, out, (int64_t)M, (int64_t)N, c0, c1, c2, c3, c4);
  return (int)cudaGetLastError();
}
