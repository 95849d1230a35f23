// The asynchronous-copy ring of k-planes shared by the 2.5-D star stencils
// (stencil3d7pt.cu, longrange3d.cu).
//
// A CTA owns an in-plane tile of bj rows by bi columns and a chunk of
// output planes, and marches k through the chunk and the R planes on each
// side of it.  Its threads form a (bi, bj / C) block: thread (tx, ty) owns
// column i0 + tx of the C consecutive rows j0 + ty*C .. j0 + ty*C + C-1
// (a strip).  Shared memory holds a ring of S stages, each one k-plane of
// the tile with a halo of width R on every side (H = bj + 2R rows of
// W = bi + 2R words, corners included), then, for the long-range kernel,
// a ring of S - R stages of `own` bare bj x bi tiles (u and roc, read only
// at their own point, so they need no halo and fewer stages), then a
// table of the haloed tile's in-plane offsets, built once per CTA.
//
// The copies are cp.async.ca.shared.global of 4 bytes.  Cells outside the
// grid take the zero-fill form (src-size 0): no masked load and no branch
// around a copy; the stencils read such cells only at points whose output
// copies the input.  Why 4 bytes and not TMA or 16-byte copies: a tensor
// map needs every global stride to be a multiple of 16 bytes and a 16-byte
// cp.async a 16-byte aligned address, and rows of N = 1015 (4060 bytes) or
// N = 9 break both; one warp-wide 4-byte copy moves 128 bytes, and
// streaming at the HBM rate needs about 0.1 of those per cycle per SM.
// Each copy costs a thread a few instructions (a table read, an address,
// the copy): the table keeps all index arithmetic out of the march.
//
// The march, over the n-th plane the CTA loads (one commit group each,
// empty past what the chunk needs):
//   prologue: copy planes 0 .. D-1 of the march, one group each;
//   step n:   copy plane n + D into stage (n + D) % S and commit;
//             cp.async.wait_group D (plane n's copies of this thread have
//             landed), then __syncthreads (everyone's have);
//             read the step's cells from the stages of planes n-R .. n.
// A thread may start step n+1's copies while another still reads step n's
// stages, so the stage written at step n+1 must be none of planes
// n-R .. n: D <= S - R - 2.  The bare tiles of a step are read at that
// step only, so their ring needs D + 2 = S - R stages.  D planes of copies
// are in flight while a step waits; the advisor (core/blocking.py) sets S
// from Little's law and the chunk from how many CTAs fill the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

// the most planes in flight that wait_pending below names
constexpr int MAX_AHEAD = 8;
// threads per CTA at most (the kernels' __launch_bounds__)
constexpr int MAX_THREADS = 512;
// shared memory one CTA may use on the H100 (227 KiB)
constexpr long long SMEM_PER_CTA = 232448;

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` of this thread's newest groups are in
// flight (pending is uniform across the CTA, 1 .. MAX_AHEAD).
__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 1: wait_group<1>(); break;
    case 2: wait_group<2>(); break;
    case 3: wait_group<3>(); break;
    case 4: wait_group<4>(); break;
    case 5: wait_group<5>(); break;
    case 6: wait_group<6>(); break;
    case 7: wait_group<7>(); break;
    case 8: wait_group<8>(); break;
    default: wait_group<0>(); break;
  }
}

// Words of shared memory of one CTA: S haloed stages, S - R stages of
// `own` bare tiles, and the offset table.
__host__ __device__ inline long long smem_words(int R, int bj, int bi,
                                                int own, int stages) {
  const long long haloed = (long long)(bj + 2 * R) * (bi + 2 * R);
  return stages * haloed + (long long)(stages - R) * own * bj * bi + haloed;
}

// The launch rule both kernels state (repro_<kernel>_limits): C one of the
// instantiated points per thread, bi a positive whole number of warps,
// bj a multiple of C and at least R, at most MAX_THREADS threads, S stages
// with 1 .. MAX_AHEAD planes in flight, within SMEM_PER_CTA.  Returns
// cudaSuccess and the CTA's shared bytes and threads, else
// cudaErrorInvalidValue.
inline cudaError_t limits(int R, int own, bool c_built, int bj, int bi,
                          int c, int stages, long long* smem, int* threads) {
  const int ahead = stages - R - 2;
  if (!c_built || bi < 32 || bi % 32 || bj < R || bj < 1 || bj % c ||
      (long long)bi * (bj / c) > MAX_THREADS || ahead < 1 ||
      ahead > MAX_AHEAD)
    return cudaErrorInvalidValue;
  const long long bytes = 4LL * smem_words(R, bj, bi, own, stages);
  if (bytes > SMEM_PER_CTA) return cudaErrorInvalidValue;
  *smem = bytes;
  *threads = bi * (bj / c);
  return cudaSuccess;
}

// Checks both launch functions make besides the plan's limits: a grid
// whose in-plane offsets fit 32 bits, a chunk of at least one plane, and
// grid dimensions the launch takes.
inline bool grid_ok(long long M, long long N, int bj, int bi, int chunk) {
  return N * N < (1LL << 31) && M < (1LL << 31) && chunk >= 1 &&
         (N + bj - 1) / bj <= 65535 && (M + chunk - 1) / chunk <= 65535 &&
         (N + bi - 1) / bi < (1LL << 31);
}

// The in-plane offset of every cell of the haloed tile at (j0 - R,
// i0 - R), -1 where the cell lies outside the N x N plane; thread f of T
// fills cells f, f + T, ...
__device__ __forceinline__ void build_table(int* table, int H, int W, int R,
                                            int j0, int i0, int N, int f,
                                            int T) {
  for (int e = f; e < H * W; e += T) {
    const int j = j0 - R + e / W, i = i0 - R + e % W;
    table[e] = j >= 0 && j < N && i >= 0 && i < N ? j * N + i : -1;
  }
}

// Thread f of T copies its cells of `plane` (a whole N x N plane) into
// the haloed stage `st`: cells f, f + T, ... of the table.
__device__ __forceinline__ void copy_haloed(float* st,
                                            const float* __restrict__ plane,
                                            const int* table, int HW, int f,
                                            int T) {
  for (int e = f; e < HW; e += T) {
    const int off = table[e];
    copy4(st + e, plane + (off < 0 ? 0 : off), off >= 0);
  }
}

// The thread's own C cells of `plane` (rows j0 + ty*C + m at column
// i0 + tx, in-plane offset `at` + m*N) into the bare tile `dst` (row
// pitch bi); `valid` has bit m set where row m lies inside the grid.
template <int C>
__device__ __forceinline__ void copy_own(float* dst,
                                         const float* __restrict__ plane,
                                         int at, int N, int bi, unsigned valid) {
#pragma unroll
  for (int m = 0; m < C; ++m) {
    const bool in = (valid >> m) & 1u;
    copy4(dst + m * bi, plane + (in ? at + m * N : 0), in);
  }
}

}  // namespace ring
