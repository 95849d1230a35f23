"""CTA tile advisors for the port's Hopper kernels: the 2.5-D blocked
stencils (the GPU counterpart of ``repro.core.blocking.stencil_blocks``)
and flash attention (:func:`attention_cta_tiles`, the counterpart of
``attention_tiles``, at the end of this module).

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

from ..kernels import flash_attention as fa

WARP = 32
SECTOR_BYTES = 32                 # L2 -> SM transfer granule
ELEM_BYTES = 4                    # the kernels run float32 only
SMEM_PER_CTA = fa.SMEM_PER_CTA    # 227 KiB, the H100's opt-in maximum
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


@dataclasses.dataclass(frozen=True)
class AttentionCTATiles:
    bq: int
    bkv: int
    smem_bytes: int


#: the advisor's first blocks: at head_dim 128 a q tile of 256 fp32 rows
#: alone takes 128 KiB of the 227 KiB, leaving no room for a useful kv
#: tile; 128 is also the tensor-core kernel's largest block_q and block_kv
ATTENTION_START = 128


def attention_cta_tiles(seq_q: int, seq_kv: int, head_dim: int,
                        dtype="bfloat16") -> AttentionCTATiles:
    """Flash-attention block sizes for one CTA of the Hopper kernels — the
    shared-memory counterpart of ``repro.core.blocking.attention_tiles``.

    The q tile is the 'layer' kept resident while the kv stream passes
    (the LC structure of attention), so blocks start as large as the
    lengths allow (at most :data:`ATTENTION_START`, in steps of
    ``GRANULE * 2**k``) and shrink in the JAX advisor's order — ``bkv``
    first, then ``bq``.  They shrink first until
    :func:`repro_torch.kernels.flash_attention.launch_limits` accepts the
    pair on a tensor-core route (wgmma in bfloat16, bf16x3 in float32, at
    a head_dim of their sets; at head_dim 128 in float32 that is
    (128, 64), the hi and lo tiles of (128, 128) being too large), and
    only where no such pair is reached until it launches on any route.
    The result need not divide the lengths;
    :func:`~repro_torch.kernels.flash_attention.fit_blocks` fits it.
    Raises ``ValueError`` when even the smallest pair does not launch."""
    def start(n: int) -> int:
        b = fa.GRANULE
        while 2 * b <= min(n, ATTENTION_START):
            b *= 2
        return b

    def lim(a: int, b: int):
        return fa.launch_limits(a, b, head_dim, dtype)

    def shrink(accept) -> tuple[int, int]:
        bq, bkv = start(seq_q), start(seq_kv)
        while not accept(lim(bq, bkv)) and bkv > fa.GRANULE:
            bkv //= 2
        while not accept(lim(bq, bkv)) and bq > fa.GRANULE:
            bq //= 2
        return bq, bkv

    bq, bkv = shrink(lambda l: l.ok and l.route != "simt")
    if lim(bq, bkv).route == "simt":
        bq, bkv = shrink(lambda l: l.ok)
    last = lim(bq, bkv)
    if not last.ok:
        raise ValueError(f"no flash-attention CTA tile: {last.reason}")
    return AttentionCTATiles(bq=bq, bkv=bkv, smem_bytes=last.smem_bytes)
