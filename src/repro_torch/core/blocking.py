"""CTA tile advisor for the 2.5-D blocked stencil kernels on Hopper — the
GPU counterpart of ``repro.core.blocking.stencil_blocks``.

On the TPU the advisor sizes a 3-D block whose haloed working set fits
VMEM.  On the H100 a CTA holds one haloed ``(bj, bi)`` tile of one plane
in shared memory and marches k (see ``csrc/*.cu``), so the choice is an
in-plane tile under these limits:

* two haloed tiles ``(bj + 2r) x (bi + 2r)`` (the kernels fill one while
  the other is read) fit the per-CTA shared-memory budget (at most
  227 KiB on the H100);
* ``bi`` is a multiple of the 32-thread warp (128 B of fp32, one line);
* ``bj * bi`` is at most 256 threads (the hardware allows 1024, but a
  whole CTA waits at each k step's barrier, and 256-thread tiles ran
  fastest in the tile sweeps of PERF.md);
* ``bj >= r``: each of the tile's first ``r`` rows of threads loads one
  halo row above and one below (``csrc/halo.cuh``).

Among legal tiles it picks the one that fetches the fewest words per
output point over the whole plane — the layer condition's cost applied to
the halo: each tile reads its ``bj x bi`` cells, ``2r`` full halo rows, and
for each of its rows one 32-byte sector on each side for the i-halo.
Ties prefer the wider tile (longer contiguous rows).
"""
from __future__ import annotations

import dataclasses
import functools
import math

WARP = 32
SECTOR_BYTES = 32                 # L2 -> SM transfer granule
ELEM_BYTES = 4                    # the kernels run float32 only
SMEM_PER_CTA = 232448             # 227 KiB, the H100's opt-in maximum
THREADS = 256                     # per CTA, at most
TILES = 2                         # shared-memory tiles per CTA, used in turn


@dataclasses.dataclass(frozen=True)
class CTATile:
    bj: int
    bi: int
    halo: int
    smem_bytes: int
    words_per_point: float        # words fetched per output point, one plane

    @property
    def threads(self) -> int:
        return self.bj * self.bi


@functools.lru_cache(maxsize=256)      # called on every launch; ints only
def stencil_cta_tile(radius: int, shape: tuple[int, int, int]) -> CTATile:
    """The in-plane CTA tile for a radius-``radius`` float32 star stencil
    over an ``(M, N, N)`` grid.  Raises ``ValueError`` when no tile
    satisfies the limits (a radius above ``THREADS // WARP``)."""
    if radius < 0:
        raise ValueError(f"radius must be non-negative, got {radius}")
    if len(shape) != 3 or min(shape) <= 0:
        raise ValueError(f"shape must be a positive (M, N, N), got {shape}")
    _, J, I = shape
    sector = SECTOR_BYTES // ELEM_BYTES
    halo_i = math.ceil(radius / sector) * sector
    best, best_key = None, None
    for bi in range(WARP, min(THREADS, math.ceil(I / WARP) * WARP) + 1, WARP):
        for bj in range(max(1, radius), min(max(J, radius), THREADS // bi) + 1):
            smem = TILES * (bj + 2 * radius) * (bi + 2 * radius) * ELEM_BYTES
            if smem > SMEM_PER_CTA:
                break                 # taller tiles only need more
            tiles = math.ceil(I / bi) * math.ceil(J / bj)
            words = tiles * ((bi + 2 * halo_i) * bj + 2 * radius * bi)
            key = (words / (I * J), -bi, -bj)
            if best_key is None or key < best_key:
                best_key = key
                best = CTATile(bj=bj, bi=bi, halo=radius, smem_bytes=smem,
                               words_per_point=key[0])
    if best is None:
        raise ValueError(
            f"no legal CTA tile for radius {radius} on {shape}: a tile needs "
            f"bj >= {radius} rows of {WARP} threads, more than {THREADS}")
    return best
