"""CTA tile advisors for the port's Hopper kernels: the 2.5-D blocked
stencils (the GPU counterpart of ``repro.core.blocking.stencil_blocks``)
and flash attention (:func:`attention_cta_tiles`, the counterpart of
``attention_tiles``, at the end of this module).

On the TPU the advisor sizes a 3-D block whose haloed working set fits
VMEM.  On the H100 a CTA owns a ``(bj, bi)`` tile of a chunk of
``chunk`` output planes and marches k through it, the planes coming in
by asynchronous copies into a ring of ``stages`` planes in shared memory
(``csrc/stencil_ring.cuh``); each thread owns ``c`` consecutive rows of
one column.  So the choice is a launch plan under the kernels' limits
(``repro_<kernel>_limits`` in ``csrc/*.cu`` states the same rule):

* ``stages`` haloed tiles ``(bj + 2r) x (bi + 2r)``, ``stages - r``
  stages of ``own`` bare ``bj x bi`` tiles (the long-range kernel's u and
  roc) and a table of the haloed tile's offsets fit the per-CTA budget
  (227 KiB); ``stages - r - 2`` planes are in flight while a step waits,
  1 to :data:`MAX_AHEAD`;
* ``bi`` is a whole number of 32-thread warps (128 B of fp32, one line);
  ``c`` is one of the instantiated :data:`POINTS` and divides ``bj``;
* ``bj >= r``;
* the CTA has ``bi * bj / c`` threads, at most :data:`THREADS`.

``stages`` comes from Little's law: the fewest stages whose planes in
flight hold :data:`IN_FLIGHT_PER_SM` bytes per SM, counting the CTAs an SM
holds (by shared memory and threads, and no more than the grid gives it).
``chunk`` splits k where the tiles alone leave resident CTA slots empty,
but never below :data:`CHUNK_PER_RADIUS` ``* r`` planes, so the ``2r``
planes each chunk loads again cost at most an eighth more.  Each thread
owns :data:`POINTS_PER_THREAD` rows.  Among tiles it picks the one that
fetches the fewest words per output point (the halo the L2 serves again
and the planes chunks load twice) divided by how evenly the CTAs load the
SMs; ties prefer the wider tile.

The constants are the plan sweeps' (``python -m repro_torch.tune.sweep``
on the H100, PERF.md §6): at both main-path shapes 4 points per
thread beat 1, 2 and 8 (8 halves the warps an SM holds, 1 and 2 repeat
the copy and address work per point), 512-thread CTAs beat 256-thread
ones by 1–2%, and the 7-point grid at 512^3 ran 1.37x faster in chunks of
64 planes (1024 CTAs) than marching all of k (128 CTAs, 16 warps per SM).
"""
from __future__ import annotations

import dataclasses
import functools
import math

from ..kernels import flash_attention as fa

WARP = 32
ELEM_BYTES = 4                    # the kernels run float32 only
SMEM_PER_CTA = fa.SMEM_PER_CTA    # 227 KiB, the H100's opt-in maximum
SMEM_PER_SM = fa.SMEM_PER_SM      # 228 KiB, SMEM_RESERVED more per CTA
SMEM_RESERVED = fa.SMEM_RESERVED
THREADS_PER_SM = fa.THREADS_PER_SM
CTAS_PER_SM = fa.CTAS_PER_SM
SM_COUNT = 132
THREADS = 512                     # per CTA, the kernels' __launch_bounds__
POINTS = (1, 2, 4, 8)             # points per thread the kernels instantiate
POINTS_PER_THREAD = 4             # the advisor's
MAX_AHEAD = 8                     # planes in flight, at most
#: bytes in flight per SM that the stages are sized for: ~0.7 us of loaded
#: latency at 3.35 TB/s over 132 SMs is ~18 KB (Little's law); a step's
#: copies land together, so twice that
IN_FLIGHT_PER_SM = 36 * 1024
CHUNK_PER_RADIUS = 16             # output planes per chunk, at least, per r


@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """One launch of a ring stencil kernel."""
    bj: int
    bi: int
    c: int                        # points (rows) per thread
    stages: int
    chunk: int                    # output planes per CTA
    halo: int
    own: int                      # bare tiles per plane
    stage_bytes: int              # one plane: haloed tile and bare tiles
    smem_bytes: int               # per CTA
    ctas: int                     # in the grid
    ctas_per_sm: int              # resident, as the grid fills the card
    words_per_point: float        # words fetched per output point

    @property
    def threads(self) -> int:
        return self.bi * self.bj // self.c

    @property
    def ahead(self) -> int:
        """Planes in flight while a step waits."""
        return self.stages - self.halo - 2

    @property
    def in_flight_per_sm(self) -> int:
        return self.ctas_per_sm * self.ahead * self.stage_bytes

    @property
    def launch(self) -> tuple[int, int, int, int, int]:
        """What the wrappers take as ``tile``: ``(bj, bi, c, stages,
        chunk)``."""
        return self.bj, self.bi, self.c, self.stages, self.chunk


def stage_bytes(radius: int, bj: int, bi: int, own: int = 0) -> int:
    return ELEM_BYTES * ((bj + 2 * radius) * (bi + 2 * radius)
                         + own * bj * bi)


def plan_limits(radius: int, own: int, bj: int, bi: int, c: int,
                stages: int) -> tuple[int, int]:
    """(shared bytes, threads) of one CTA of the plan, as
    ``repro_<kernel>_limits`` states them; raises ``ValueError`` for a
    plan the kernel cannot take."""
    threads = bi * (bj // c) if c > 0 else 0
    ahead = stages - radius - 2
    haloed = (bj + 2 * radius) * (bi + 2 * radius)
    smem = ELEM_BYTES * (stages * haloed + (stages - radius) * own * bj * bi
                         + haloed)
    if (c not in POINTS or bi < WARP or bi % WARP or bj < max(1, radius)
            or bj % c or threads > THREADS or not 1 <= ahead <= MAX_AHEAD
            or smem > SMEM_PER_CTA):
        raise ValueError(
            f"CTA tile (bj={bj}, bi={bi}, c={c}, stages={stages}) needs bi a "
            f"multiple of {WARP}, bj >= {max(1, radius)} and a multiple of c "
            f"in {POINTS}, bi*bj/c <= {THREADS} threads, "
            f"{radius + 3} <= stages <= {radius + 2 + MAX_AHEAD} and "
            f"{smem} B <= {SMEM_PER_CTA} B of shared memory")
    return smem, threads


def check_launch(tile, radius: int, own: int = 0) -> tuple[int, ...]:
    """The numbers ``(bj, bi, c, stages, chunk)`` of a launch plan given as
    numbers or as a :class:`StencilPlan`, once :func:`plan_limits` accepts
    its CTA; raises ``ValueError`` otherwise."""
    tile = tuple(int(x) for x in (tile.launch if isinstance(tile, StencilPlan)
                                  else tile))
    if len(tile) != 5:
        raise ValueError(f"CTA tile {tile}: a launch plan is (bj, bi, c, "
                         "stages, chunk)")
    plan_limits(radius, own, *tile[:4])
    return tile


def _fit(smem: int, threads: int) -> int:
    """CTAs one SM holds by shared memory and threads."""
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED),
               THREADS_PER_SM // threads, CTAS_PER_SM)


def _chunk(radius: int, M: int, tiles: int, fit: int) -> int:
    """Output planes per CTA: the whole of k, unless the tiles leave
    resident slots empty and k is long enough to split."""
    most = max(1, M // (CHUNK_PER_RADIUS * max(1, radius)))
    chunks = min(most, max(1, math.ceil(fit * SM_COUNT / tiles)))
    return math.ceil(M / chunks)


def make_plan(radius: int, shape: tuple[int, int, int], bj: int, bi: int,
              c: int, stages: int, chunk: int | None = None,
              own: int = 0) -> StencilPlan:
    """The plan ``(bj, bi, c, stages, chunk)`` on ``shape`` with its
    derived fields (``chunk`` None: the advisor's); raises ``ValueError``
    when the kernel cannot take it."""
    smem, threads = plan_limits(radius, own, bj, bi, c, stages)
    M, J, I = shape
    tiles = math.ceil(I / bi) * math.ceil(J / bj)
    fit = _fit(smem, threads)
    if chunk is None:
        chunk = _chunk(radius, M, tiles, fit)
    if chunk < 1:
        raise ValueError(f"CTA tile chunk={chunk}: a chunk holds at least "
                         "one output plane")
    chunk = min(chunk, M)
    chunks = math.ceil(M / chunk)
    loaded = sum(min(M, (z + 1) * chunk + radius) - max(0, z * chunk - radius)
                 for z in range(chunks))
    sb = stage_bytes(radius, bj, bi, own)
    ctas = tiles * chunks
    return StencilPlan(bj=bj, bi=bi, c=c, stages=stages, chunk=chunk,
                       halo=radius, own=own, stage_bytes=sb, smem_bytes=smem,
                       ctas=ctas,
                       ctas_per_sm=max(1, min(fit, math.ceil(ctas / SM_COUNT))),
                       words_per_point=sb / ELEM_BYTES / (bj * bi) * loaded / M)


def ring_plan(radius: int, shape: tuple[int, int, int], bj: int, bi: int,
              c: int, own: int = 0, chunk: int | None = None
              ) -> StencilPlan | None:
    """The plan of tile ``(bj, bi)`` at ``c`` points per thread with the
    fewest stages whose planes in flight hold :data:`IN_FLIGHT_PER_SM`
    bytes per SM (else the most in flight that fits); None when no stage
    count fits."""
    plan = None
    for stages in range(radius + 3, radius + 3 + MAX_AHEAD):
        try:
            p = make_plan(radius, shape, bj, bi, c, stages, chunk, own)
        except ValueError:
            break                     # more stages only need more memory
        if plan is None or p.in_flight_per_sm > plan.in_flight_per_sm:
            plan = p
        if p.in_flight_per_sm >= IN_FLIGHT_PER_SM:
            break
    return plan


def _fill(plan: StencilPlan) -> float:
    """How evenly the grid's CTAs load the SMs: their count over the SMs
    times the most any SM runs."""
    return plan.ctas / (SM_COUNT * math.ceil(plan.ctas / SM_COUNT))


@functools.lru_cache(maxsize=256)      # called on every launch; ints only
def stencil_cta_tile(radius: int, shape: tuple[int, int, int],
                     own: int = 0) -> StencilPlan:
    """The launch plan for a radius-``radius`` float32 star stencil over
    an ``(M, N, N)`` grid whose planes carry ``own`` bare tiles besides
    the haloed one.  Raises ``ValueError`` when no plan satisfies the
    limits (a halo whose fewest stages overflow the shared memory)."""
    if radius < 0:
        raise ValueError(f"radius must be non-negative, got {radius}")
    if len(shape) != 3 or min(shape) <= 0:
        raise ValueError(f"shape must be a positive (M, N, N), got {shape}")
    _, J, I = shape
    c = POINTS_PER_THREAD
    best, best_key = None, None
    for bi in range(WARP, min(THREADS, math.ceil(I / WARP) * WARP) + 1, WARP):
        for rows in range(1, THREADS // bi + 1):
            bj = c * rows
            if bj < max(1, radius):
                continue
            if bj > max(J, radius) + c - 1:
                break                 # taller tiles only idle more threads
            plan = ring_plan(radius, shape, bj, bi, c, own)
            if plan is None:
                continue
            key = (plan.words_per_point / _fill(plan), -bi)
            if best_key is None or key < best_key:
                best, best_key = plan, key
    if best is None:
        raise ValueError(
            f"no legal CTA tile for radius {radius} on {shape}: even "
            f"{radius + 3} stages of the smallest haloed tile exceed "
            f"{SMEM_PER_CTA} B of shared memory")
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
