// Halo cells of one thread in the 2.5-D blocked star stencils
// (stencil3d7pt.cu, longrange3d.cu).
//
// A CTA covers a (bj, bi) tile of one plane; its shared tile is that tile
// with a ring of width r and no corners (a star needs none).  Thread
// (tx, ty) owns up to four ring cells: the rows above and below its column
// when ty < r, the columns left and right of its row when tx < r (so a
// launch needs bj >= r and bi >= r).  Cells outside the grid are left out.
// The kernels load the cells of the next plane into registers one step
// ahead and store them into the tile at the top of the step.
#pragma once

#include <stdint.h>

struct Halo {
  int64_t off[4];   // offsets within a plane
  int slot[4];      // shared-tile index, -1 where the thread has no cell
  float val[4];

  __device__ void load(const float* __restrict__ plane) {
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if (slot[h] >= 0) val[h] = plane[off[h]];
  }

  __device__ void store(float* tile) const {
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if (slot[h] >= 0) tile[slot[h]] = val[h];
  }
};

__device__ inline Halo halo_cells(int r, int tx, int ty, int bi, int bj,
                                  int64_t i0, int64_t j0, int64_t N) {
  const int tw = bi + 2 * r;
  const int64_t i = i0 + tx, j = j0 + ty;
  const int64_t up = j0 - r + ty, down = j0 + bj + ty;
  const int64_t left = i0 - r + tx, right = i0 + bi + tx;
  const bool row = ty < r, col = tx < r;
  Halo h;
  h.off[0] = up * N + i;
  h.slot[0] = row && i < N && up >= 0 ? ty * tw + tx + r : -1;
  h.off[1] = down * N + i;
  h.slot[1] = row && i < N && down < N ? (bj + r + ty) * tw + tx + r : -1;
  h.off[2] = j * N + left;
  h.slot[2] = col && j < N && left >= 0 ? (ty + r) * tw + tx : -1;
  h.off[3] = j * N + right;
  h.slot[3] = col && j < N && right < N ? (ty + r) * tw + bi + r + tx : -1;
#pragma unroll
  for (int c = 0; c < 4; ++c) h.val[c] = 0.f;
  return h;
}
