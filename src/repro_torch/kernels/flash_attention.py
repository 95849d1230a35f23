"""Blocked online-softmax (flash) attention: its hand-written Hopper
kernels, their launch limits, and beside them the plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention``.  :func:`flash_attention`
has the JAX signature without ``interpret``: it launches a CUDA kernel
for tensors on the card and raises if it cannot; for tensors on the CPU
it runs :func:`plain`.  The checks (block divisibility, the launch
limits, operand types and shapes) are the same on both devices, so a call
that would be refused on the card is refused on the CPU too.

Three routes, chosen by one rule, :func:`route`, before anything
launches:

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bfloat16 on the tensor
  cores, at the head dims, kv blocks and q blocks the kernel was
  instantiated for (:data:`WGMMA_SET`).  A head dim between the
  instantiated ones (a multiple of 8 up to 256, e.g. 112) runs the next
  larger instantiation, :func:`tc_head_dim`, with zero columns that add
  nothing to q·kᵀ and are never stored.  It rounds p to bf16 for the p·v
  product, the one departure from the reference, within its 2e-2 bf16
  tolerance.
- ``"bf16x3"`` (``csrc/flash_attention_bf16x3.cu``): float32 on the
  tensor cores as three bf16 passes, at the triples of
  :data:`BF16X3_SET` (head dims padded the same way).  A split pass
  (:func:`split_bf16x3`, plain version :func:`plain_split`) writes
  ``hi = bf16(x)`` and ``lo = bf16(x - hi)`` of q, k and v; each product
  is ``hi·hi + hi·lo + lo·hi`` in fp32 (about 16 mantissa bits, within
  the 2e-3 f32 tolerance), p is split the same way in registers, and the
  output is fp32.
- ``"simt"`` (``csrc/flash_attention.cu``): everything else — head dims
  off :func:`tc_head_dim` (not a multiple of 8, or above 256) and block
  pairs off those sets — on the CUDA cores in fp32.  A caller may also
  force it (``force_simt=True``) at a pair that a tensor-core route
  takes, to time the CUDA cores there.  The source holds two CTAs: the
  tiled kernel at the triples of :data:`SIMT_TILED_SET` (a head dim
  between its instantiations run with zero columns,
  :func:`simt_head_dim`), and the general kernel for every other triple
  that fits; :func:`launch_limits` says which, before any launch.

A failed build or launch on a route raises; it never falls back to the
other route or to :func:`plain`.  ``flash_attention.launches`` counts
every launch and ``flash_attention.launches_by_route`` each route's.

The gradient (:class:`FlashAttentionFn`'s backward) has two routes, chosen
by :func:`backward_route` before anything launches: ``"kernel"``
(``csrc/flash_attention_bwd.cu``, :func:`flash_attention_backward`),
bfloat16 at a :func:`tc_head_dim` up to 128 and lengths that are
multiples of :data:`BACKWARD_ROWS`; ``"plain"`` (:func:`attention_backward`,
PyTorch in float32) for the rest — float32 operands and head dim 256.
``flash_attention.backward_calls_by_route`` counts each.

:func:`launch_limits` is the one statement of what each route can launch;
the wrapper, the shared-memory advisor
(:func:`repro_torch.core.blocking.attention_cta_tiles`),
:func:`default_config`, :func:`fit_blocks` and the tuner's
``FlashAttentionSpace`` all read it, so a candidate the tuner calls
feasible launches, on the route it names.
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
import math

import torch

from .. import obs
from . import _build

NEG_INF = -2.0 ** 30

#: CTA size of the CUDA-core ("simt") kernels
THREADS = 256
#: block_q, block_kv and head_dim must be multiples of this: the simt
#: kernels' float4 units (16-byte shared loads and fp32 copies, 8-byte
#: bf16 copies)
GRANULE = 4
#: the simt route's tiled kernel (``csrc/flash_attention.cu``'s
#: ``with_tile``): per instantiated ``(block_q, block_kv, head_dim)``, the
#: q rows a warp and the lanes along q rows of S = q·kᵀ and of the output
#: (32 lanes a warp); a head dim d, a multiple of :data:`GRANULE` with
#: 64 < d <= 256, runs at the next instantiated one with zero columns
#: (:func:`simt_head_dim`)
SIMT_TILES = {(64, 32, 128): (16, 4, 2), (64, 64, 128): (16, 4, 2),
              (128, 32, 128): (16, 4, 2), (64, 32, 256): (8, 2, 2)}
SIMT_TILED_SET = frozenset(SIMT_TILES)
SIMT_TILED_HEAD_DIMS = tuple(sorted({t[2] for t in SIMT_TILES}))
#: shared memory one CTA may use on the H100 (227 KiB, opt-in maximum)
SMEM_PER_CTA = 232448
#: shared memory of one SM (228 KiB), of which each resident CTA also
#: takes SMEM_RESERVED; threads and CTAs one SM holds
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
THREADS_PER_SM = 2048
CTAS_PER_SM = 32
#: the JAX kernel's default block_q and block_kv
JAX_DEFAULT_BLOCK = 128
#: the q-block grid axis is the launch's y dimension
MAX_Q_BLOCKS = 65535
#: the grid the tensor-core kernels are instantiated on (:func:`_built`
#: says which triples each was built for): head_dim and block_kv are
#: template parameters; block_q is 128 (two 64-row warpgroup tiles) or
#: divides the 64-row tile, whose rows past block_q are padding
WGMMA_HEAD_DIMS = (32, 64, 96, 128, 256)
WGMMA_BLOCK_KV = (32, 64, 128)
WGMMA_BLOCK_Q = (4, 8, 16, 32, 64, 128)
#: a tensor-core head dim is a multiple of this: TMA copies rows of a
#: multiple of 16 bytes
TC_HEAD_DIM_GRANULE = 8
WGMMA_TILE_M = 64
#: the K/V ring depth of both tensor-core kernels, and bytes for
#: alignment and mbarriers
WGMMA_STAGES = 2
WGMMA_SMEM_ALIGN = 1024
WGMMA_SMEM_BARRIERS = 64
#: the CUDA source of each route
SOURCES = {"wgmma": "flash_attention_wgmma", "simt": "flash_attention",
           "bf16x3": "flash_attention_bf16x3"}
#: peak-rate key (``peak flops`` in the machine file) of the unit each
#: route's products run on, and how many passes of it each product takes:
#: the tensor cores in bf16 (three passes for bf16x3), the CUDA cores in
#: fp32
MATMUL_UNIT = {"wgmma": "BF16", "simt": "FP32", "bf16x3": "BF16"}
MATMUL_PASSES = {"wgmma": 1, "simt": 1, "bf16x3": 3}
#: cycles a CTA spends per kv step outside the arithmetic.  simt: the
#: tiled kernel's one barrier, its softmax (three shuffles a row for the
#: max, exp2 of every score), the store of P and the rescale of the
#: register accumulator; the copies of the next tile are in flight
#: meanwhile (:data:`SIMT_GENERAL_STEP_CY` for the general kernel: four
#: barriers and the exposed latency of staging the k/v tiles).  wgmma: the
#: full-barrier wait and two wgmma issue → wait round trips that the
#: softmax sits between.  bf16x3: the same round trips around three times
#: the products, the split of p, and no second resident CTA at d = 128 to
#: hide them.  All are estimates; the tuner's calibration factor absorbs
#: their error.
STEP_OVERHEAD_CY = {"wgmma": 600.0, "simt": 400.0, "bf16x3": 900.0}
SIMT_GENERAL_STEP_CY = 1000.0
#: FFMA issue slots one 16-byte shared load of the simt products costs
#: (the loads and the FFMAs they feed share each scheduler's issue), and
#: the general kernel's FFMA slots per FMA: both estimates, from the
#: designs (:func:`simt_issue_factor`)
SIMT_LOAD_SLOTS = 6.0
SIMT_GENERAL_FACTOR = 4.0
#: the backward's routes (:func:`backward_route`), its kernel's source,
#: the rows its tiles take (q rows of a rows-pass CTA and of a fused-pass
#: step, kv rows of a fused-pass consumer; both lengths must be multiples
#: of it) and the instantiated head dims it takes
BACKWARD_ROUTES = ("kernel", "plain")
BACKWARD_SOURCE = "flash_attention_bwd"
BACKWARD_ROWS = 64
BACKWARD_HEAD_DIMS = (32, 64, 96, 128)
#: threads of the rows pass's CTA (a warpgroup and a producer warp) and of
#: the fused pass's (two consumer warpgroups and a producer warpgroup)
BACKWARD_THREADS = (160, 384)
#: the fused pass's ring depth, its four bf16 dS tiles (by step parity and
#: consumer) and its mbarriers
BACKWARD_FUSED_STAGES = 2
BACKWARD_DS_BYTES = 4 * BACKWARD_ROWS * BACKWARD_ROWS * 2
BACKWARD_FUSED_BARRIERS = 128
#: the kernel's dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: Starting configurations for the autotuner (:mod:`repro_torch.tune`),
#: keyed by the smallest kv sequence length the row applies to:
#: ``(block_q, block_kv)``.  The simt rows launch at head_dim 128 (its
#: tiles are staged in fp32 whatever the input type); the TPU table's
#: (256, 512) row would need about 1 MiB of shared memory.
DEFAULT_CONFIGS: tuple[tuple[int, tuple[int, int]], ...] = (
    (4096, (64, 64)),
    (1024, (64, 64)),
    (256, (32, 64)),
    (0, (16, 32)),
)
#: the same for bfloat16 at a head_dim of :func:`tc_head_dim`: wgmma
#: pairs, smaller kv blocks and then one warpgroup for shorter sequences
DEFAULT_CONFIGS_BF16: tuple[tuple[int, tuple[int, int]], ...] = (
    (1024, (128, 128)),
    (256, (128, 64)),
    (0, (64, 64)),
)
#: and for float32 at a head_dim of :func:`tc_head_dim`: bf16x3
#: pairs; (128, 64) is the one two-warpgroup pair that fits at d = 128
DEFAULT_CONFIGS_BF16X3: tuple[tuple[int, tuple[int, int]], ...] = (
    (256, (128, 64)),
    (0, (64, 64)),
)


@dataclasses.dataclass(frozen=True)
class LaunchLimits:
    """What one CTA of a route's kernel needs for a block pair, and why it
    cannot launch (``reason``, empty when it can)."""
    smem_bytes: int
    threads: int
    reason: str = ""
    route: str = "simt"

    @property
    def ok(self) -> bool:
        return not self.reason

    @property
    def ctas_per_sm(self) -> int:
        """CTAs of this size one SM holds at once, by shared memory and
        threads.  The simt route's tiled CTA takes more than half an SM's
        shared memory, so its registers (up to 255 a thread at 256
        threads; ``chip_smoke.py`` phase 2 holds ptxas's count to this)
        never hold fewer than its one; other CTAs' registers are not
        modelled."""
        return min(SMEM_PER_SM // (self.smem_bytes + SMEM_RESERVED),
                   THREADS_PER_SM // self.threads, CTAS_PER_SM)


def torch_dtype(dtype) -> torch.dtype:
    """``torch.float32``/``torch.bfloat16`` from a torch dtype or its name;
    raises ``TypeError`` for any other type."""
    t = _DTYPE_NAMES.get(dtype, dtype) if isinstance(dtype, str) else dtype
    if t not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, "
                        f"got {dtype}")
    return t


def _tc_smem_bytes(elem_bytes: int, block_q: int, block_kv: int,
                   head_dim: int) -> int:
    nwg = 2 if block_q > WGMMA_TILE_M else 1
    return (WGMMA_SMEM_ALIGN + WGMMA_SMEM_BARRIERS
            + elem_bytes * head_dim * (WGMMA_TILE_M * nwg
                                       + 2 * WGMMA_STAGES * block_kv))


def wgmma_smem_bytes(block_q: int, block_kv: int, head_dim: int) -> int:
    """Dynamic shared memory of one bf16 tensor-core CTA: 1024 bytes of
    alignment slack, the bf16 q tiles (64 rows per warpgroup), the ring of
    :data:`WGMMA_STAGES` k and v tiles, and the mbarriers."""
    return _tc_smem_bytes(2, block_q, block_kv, head_dim)


def bf16x3_smem_bytes(block_q: int, block_kv: int, head_dim: int) -> int:
    """Dynamic shared memory of one f32 tensor-core CTA: the layout of
    :func:`wgmma_smem_bytes` with a hi and a lo bf16 tile in place of
    each tile, 4 bytes per element."""
    return _tc_smem_bytes(4, block_q, block_kv, head_dim)


def _built(route_name: str, block_q: int, block_kv: int,
           head_dim: int) -> bool:
    """Whether a tensor-core kernel was built for a triple of the grid
    (its CTA must also fit :data:`SMEM_PER_CTA`): block_kv 64 and 128 at
    head dims up to 128.  At 256 one warpgroup only (two hold a thread to
    168 registers, where the output accumulator's 128 spill), with
    block_kv 64 in bf16 (128 does not fit) and 32 in f32 (64 does not
    fit)."""
    if head_dim == 256:
        return block_q <= WGMMA_TILE_M and \
            block_kv == (64 if route_name == "wgmma" else 32)
    return block_kv in (64, 128)


#: ``(block_q, block_kv, head_dim)`` triples each tensor-core kernel was
#: instantiated for, at the instantiated head dims: the triples it was
#: built for whose CTA fits :data:`SMEM_PER_CTA`.  The f32 kernel
#: ("bf16x3") has a hi and a lo tile for each tile of the bf16 one, so it
#: keeps fewer at head dims up to 128: at 128 only block_kv 64, at 96
#: block_kv 128 only with one warpgroup
_GRID = tuple(itertools.product(WGMMA_BLOCK_Q, WGMMA_BLOCK_KV,
                                WGMMA_HEAD_DIMS))
WGMMA_SET = frozenset(t for t in _GRID if _built("wgmma", *t)
                      and wgmma_smem_bytes(*t) <= SMEM_PER_CTA)
BF16X3_SET = frozenset(t for t in _GRID if _built("bf16x3", *t)
                       and bf16x3_smem_bytes(*t) <= SMEM_PER_CTA)


def tc_head_dim(head_dim: int) -> int | None:
    """The instantiated head dim that ``head_dim`` runs at on the tensor
    cores: the smallest of :data:`WGMMA_HEAD_DIMS` at least ``head_dim``,
    for a positive multiple of :data:`TC_HEAD_DIM_GRANULE` up to 256 (112
    runs at 128, 256 at 256); None for any other head_dim, which only the
    CUDA-core route takes.  TMA fills the columns past ``head_dim`` with
    zeros, which add nothing to q·kᵀ, and the kernels store only the
    first ``head_dim`` output columns."""
    d = int(head_dim)
    if d <= 0 or d % TC_HEAD_DIM_GRANULE:
        return None
    return next((D for D in WGMMA_HEAD_DIMS if D >= d), None)


def route(block_q: int, block_kv: int, head_dim: int, dtype) -> str:
    """``"wgmma"`` for bfloat16 at a triple of :data:`WGMMA_SET`,
    ``"bf16x3"`` for float32 at a triple of :data:`BF16X3_SET` (every one
    of which launches), with ``head_dim`` taken at :func:`tc_head_dim`;
    ``"simt"`` for everything else."""
    t = torch_dtype(dtype)
    key = (int(block_q), int(block_kv), tc_head_dim(head_dim))
    if t == torch.bfloat16 and key in WGMMA_SET:
        return "wgmma"
    if t == torch.float32 and key in BF16X3_SET:
        return "bf16x3"
    return "simt"


def tc_set(dtype) -> frozenset:
    """The tensor-core set of ``dtype``: :data:`WGMMA_SET` for bfloat16,
    :data:`BF16X3_SET` for float32."""
    return WGMMA_SET if torch_dtype(dtype) == torch.bfloat16 else BF16X3_SET


def launch_limits(block_q: int, block_kv: int, head_dim: int,
                  dtype=torch.float32) -> LaunchLimits:
    """Shared memory and threads of one CTA for ``(block_q, block_kv,
    head_dim)`` in ``dtype`` on the :func:`route` the pair takes, and
    whether it can launch.

    wgmma and bf16x3: :func:`wgmma_smem_bytes` or
    :func:`bf16x3_smem_bytes` at the instantiated head dim
    (:func:`tc_head_dim`; within the limit on every triple the route
    takes) and 128 threads per 64-row warpgroup tile plus a producer
    warp.  simt: :func:`_simt_limits`."""
    bq, bkv, d = int(block_q), int(block_kv), int(head_dim)
    r = route(bq, bkv, d, dtype)
    if r == "simt":
        return _simt_limits(bq, bkv, d)
    nwg = 2 if bq > WGMMA_TILE_M else 1
    smem = (wgmma_smem_bytes if r == "wgmma" else bf16x3_smem_bytes)(
        bq, bkv, tc_head_dim(d))
    return LaunchLimits(smem_bytes=smem, threads=128 * nwg + 32, route=r)


def simt_head_dim(block_q: int, block_kv: int, head_dim: int) -> int:
    """The head dim the simt route computes at for a triple: the tiled
    kernel's instantiated head dim (the smallest of
    :data:`SIMT_TILED_HEAD_DIMS` at least ``head_dim``, for a multiple of
    :data:`GRANULE` above 64) where that triple is in
    :data:`SIMT_TILED_SET`, else ``head_dim`` itself (the general
    kernel)."""
    d = int(head_dim)
    if d > 64 and d % GRANULE == 0:
        D = next((D for D in SIMT_TILED_HEAD_DIMS if D >= d), None)
        if (int(block_q), int(block_kv), D) in SIMT_TILED_SET:
            return D
    return d


def _simt_shapes(block_q: int, block_kv: int, D: int
                 ) -> tuple[int, int, int, int, int, int]:
    """(q rows a warp, lanes along S's columns, S's rows and kv columns a
    thread, the output's rows and columns a thread) of the tiled CTA at a
    triple of :data:`SIMT_TILED_SET`."""
    wm, lrs, lro = SIMT_TILES[(block_q, block_kv, D)]
    lcs, lco = 32 // lrs, 32 // lro
    slice_kv = block_kv // ((THREADS // 32) // (block_q // wm))
    return wm, lcs, wm // lrs, slice_kv // lcs, wm // lro, D // lco


def simt_issue_factor(block_q: int, block_kv: int, head_dim: int) -> float:
    """FFMA issue slots per FMA of the simt route's two products at a
    triple, an estimate from the design.  The tiled kernel's products are
    register micro-tiles fed by 16-byte shared loads: S takes TM + TN
    loads per 4·TM·TN FMAs, P·V TM + TD per 4·TM·TD (:func:`_simt_shapes`),
    each load costing :data:`SIMT_LOAD_SLOTS` slots; the two products do
    equal FMAs.  The general kernel: :data:`SIMT_GENERAL_FACTOR` (two
    float4 loads per 16 FMAs in S, a float4 and four scalars in P·V, the
    accumulator's round trip through shared memory)."""
    bq, bkv, d = int(block_q), int(block_kv), int(head_dim)
    D = simt_head_dim(bq, bkv, d)
    if (bq, bkv, D) not in SIMT_TILED_SET:
        return SIMT_GENERAL_FACTOR
    _, _, tms, tn, tmo, td = _simt_shapes(bq, bkv, D)
    loads = ((tms + tn) / (4 * tms * tn) + (tmo + td) / (4 * tmo * td)) / 2
    return 1.0 + SIMT_LOAD_SLOTS * loads


def simt_tiled_smem_bytes(block_q: int, block_kv: int, head_dim: int) -> int:
    """Dynamic shared memory of one tiled simt CTA at a triple of
    :data:`SIMT_TILED_SET` (D the instantiated head dim): the fp32 q tile
    and the ring's two k and two v tiles, rows of D + 4 floats; each of
    the 8 warps' P rows (its q rows by its slice of the kv block, a stride
    of c mod 2c floats for the c lanes along S's columns) and its rows'
    alpha; and the bfloat16 staging tile of block_kv x D."""
    bq, bkv, D = int(block_q), int(block_kv), int(head_dim)
    wm, lcs, _, tn, _, _ = _simt_shapes(bq, bkv, D)
    slice_kv = tn * lcs
    ps = slice_kv + (lcs - slice_kv) % (2 * lcs)
    return (4 * ((bq + 4 * bkv) * (D + 4) + (THREADS // 32) * wm * (ps + 1))
            + 2 * bkv * D)


def _simt_limits(bq: int, bkv: int, d: int) -> LaunchLimits:
    """The CUDA-core CTA of 256 threads: the three sizes positive
    multiples of :data:`GRANULE`; at a triple of :data:`SIMT_TILED_SET`
    (head dim at :func:`simt_head_dim`) the tiled CTA
    (:func:`simt_tiled_smem_bytes`, one an SM by shared memory), else the
    general CTA — q and k staged transposed, v, the score tile and the
    accumulator, all fp32, plus m, l and alpha — within
    :data:`SMEM_PER_CTA`."""
    D = simt_head_dim(bq, bkv, d)
    smem = (simt_tiled_smem_bytes(bq, bkv, D) if (bq, bkv, D) in SIMT_TILED_SET
            else 4 * (2 * d * bq + 2 * d * bkv + bq * bkv + 3 * bq))
    reason = ""
    if min(bq, bkv, d) <= 0 or bq % GRANULE or bkv % GRANULE or d % GRANULE:
        reason = (f"block_q={bq}, block_kv={bkv} and head_dim={d} must be "
                  f"positive multiples of {GRANULE}")
    elif smem > SMEM_PER_CTA:
        reason = (f"block_q={bq}, block_kv={bkv} at head_dim={d} need "
                  f"{smem} B of shared memory, over the {SMEM_PER_CTA} B "
                  "a CTA can use")
    return LaunchLimits(smem_bytes=smem, threads=THREADS, reason=reason)


def validate_blocks(seq_q: int, seq_kv: int, block_q: int,
                    block_kv: int) -> None:
    """Reject block sizes that don't tile the sequence lengths (the same
    checks and messages as the JAX package's)."""
    if block_q <= 0 or block_kv <= 0:
        raise ValueError(
            f"flash_attention block sizes must be positive, got "
            f"block_q={block_q}, block_kv={block_kv}")
    if seq_q % block_q:
        raise ValueError(
            f"flash_attention: block_q={block_q} does not divide "
            f"seq_q={seq_q}; the q grid would drop {seq_q % block_q} "
            f"trailing rows (pick block_q from divisors of {seq_q}, "
            f"e.g. default_config({seq_q}, {seq_kv}))")
    if seq_kv % block_kv:
        raise ValueError(
            f"flash_attention: block_kv={block_kv} does not divide "
            f"seq_kv={seq_kv}; the kv grid would drop "
            f"{seq_kv % block_kv} trailing keys (pick block_kv from "
            f"divisors of {seq_kv}, e.g. default_config({seq_q}, "
            f"{seq_kv}))")


def _tc_pair(seq_q: int, seq_kv: int, block_q: int, block_kv: int,
             head_dim: int, dtype) -> tuple[int, int] | None:
    """The tensor-core pair of ``dtype`` (:func:`tc_set`) at ``head_dim``
    (taken at :func:`tc_head_dim`) nearest ``(block_q, block_kv)`` among
    those that divide the lengths: the largest block_q at most
    ``block_q`` (else the smallest), then for it the largest block_kv at
    most ``block_kv`` (else the smallest); None when none divides."""
    dd = tc_head_dim(head_dim)
    pairs = [(bq, bkv) for bq, bkv, d in tc_set(dtype)
             if d == dd and seq_q % bq == 0 and seq_kv % bkv == 0]
    if not pairs:
        return None

    def near(b: int, want: int) -> tuple[bool, int]:
        return (b <= want, b if b <= want else -b)
    return max(pairs, key=lambda p: (*near(p[0], block_q),
                                     *near(p[1], block_kv)))


def fit_blocks(seq_q: int, seq_kv: int, block_q: int, block_kv: int,
               head_dim: int, dtype=torch.float32) -> tuple[int, int]:
    """Launchable blocks near ``(block_q, block_kv)`` for the lengths.

    A tensor-core pair of the dtype's route (wgmma for bfloat16, bf16x3
    for float32) is taken wherever one divides the lengths at
    ``head_dim`` (:func:`_tc_pair`).  Otherwise:
    clamp the blocks to the lengths, halve each until it divides its
    length, then step ``block_kv`` down, then ``block_q``, while the pair
    does not fit :func:`launch_limits`.  A step halves a block while it
    stays a multiple of :data:`GRANULE`, else takes the next smaller
    multiple of :data:`GRANULE` that divides the length (a length with
    an odd factor, such as ``116 = 4 * 29``, leaves a block that cannot
    halve).  With lengths that are multiples of :data:`GRANULE` the
    result launches; raises ``ValueError`` when no pair does."""
    pair = _tc_pair(seq_q, seq_kv, block_q, block_kv, head_dim, dtype)
    if pair is not None:
        return pair
    bq = max(1, min(block_q, seq_q))
    bkv = max(1, min(block_kv, seq_kv))
    while seq_q % bq:
        bq //= 2
    while seq_kv % bkv:
        bkv //= 2

    def fits(a: int, b: int) -> bool:
        return launch_limits(a, b, head_dim, dtype).ok

    def down(b: int, n: int) -> int | None:
        if b % (2 * GRANULE) == 0:
            return b // 2
        return max((c for c in range(GRANULE, b, GRANULE) if n % c == 0),
                   default=None)

    while not fits(bq, bkv) and (nxt := down(bkv, seq_kv)) is not None:
        bkv = nxt
    while not fits(bq, bkv) and (nxt := down(bq, seq_q)) is not None:
        bq = nxt
    lim = launch_limits(bq, bkv, head_dim, dtype)
    if not lim.ok:
        raise ValueError(f"no launchable blocks for seq_q={seq_q}, "
                         f"seq_kv={seq_kv}: {lim.reason}")
    return bq, bkv


def default_config(seq_q: int, seq_kv: int, head_dim: int = 128,
                   dtype=torch.float32) -> tuple[int, int]:
    """The default ``(block_q, block_kv)`` for a problem shape: the row
    for ``seq_kv`` of :data:`DEFAULT_CONFIGS_BF16` (bfloat16) or
    :data:`DEFAULT_CONFIGS_BF16X3` (float32) at a head_dim the tensor
    cores take (:func:`tc_head_dim`), or of :data:`DEFAULT_CONFIGS` (the
    rest), fitted to the lengths and the launch limits
    (:func:`fit_blocks`)."""
    table = DEFAULT_CONFIGS
    if tc_head_dim(head_dim) is not None:
        table = (DEFAULT_CONFIGS_BF16 if torch_dtype(dtype) == torch.bfloat16
                 else DEFAULT_CONFIGS_BF16X3)
    for floor, (bq, bkv) in table:
        if seq_kv >= floor:
            break
    return fit_blocks(seq_q, seq_kv, bq, bkv, head_dim, dtype)


def _check_offset(causal: bool, q_offset: int) -> None:
    if causal and q_offset < 0:
        raise ValueError(
            f"causal flash_attention with q_offset={q_offset} < 0 has rows "
            "that see no key, where the JAX kernel and its oracle disagree "
            "(ROADMAP Queue 3, 'Causal rows that see no key'); the port "
            "refuses the call")


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> tuple[int, int, int, int, int]:
    """(b, h, sq, skv, d) of valid operands; raises otherwise."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (b, h, s, d) tensors")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (b, h, skv, d) = (b, h, *, "
                         f"{d}) with q's b and h, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    torch_dtype(q.dtype)
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share dtype and device")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")
    return b, h, sq, skv, d


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, q_offset: int | None = None,
          scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: fp32 scores ``q.kᵀ *
    scale`` (:func:`_scale`: 1/sqrt(d) unless given), the causal mask
    ``q_pos + q_offset >= k_pos`` with the finite -2^30, softmax, ``p.v``,
    output in the input dtype.  ``q_offset`` defaults to ``skv - sq``."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    if q_offset is None:
        q_offset = skv - sq
    _check_offset(causal, q_offset)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * \
        _scale(d, scale)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + q_offset
        s = torch.where(rows >= torch.arange(skv, device=q.device)[None],
                        s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _scale(d: int, scale: float | None = None) -> float:
    """The softmax scale as the kernels take it, a float32: 1/sqrt(d), or
    ``scale`` where one is given (Zamba2 scales by (d/2)^-1/2)."""
    want = 1.0 / math.sqrt(d) if scale is None else float(scale)
    return float(torch.tensor(want, dtype=torch.float32))


def split_bytes(n_q: int, n_kv: int) -> int:
    """Bytes the split pass moves for q of ``n_q`` elements and k and v of
    ``n_kv`` each: 4 read and 2 + 2 written per element."""
    return 8 * (int(n_q) + 2 * int(n_kv))


def plain_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the split pass: ``hi = bf16(x)`` and
    ``lo = bf16(x - hi)``, both rounded to nearest even; ``hi + lo``
    holds x to about 2^-16 relative."""
    hi = x.bfloat16()
    return hi, (x - hi.float()).bfloat16()


def split_bf16x3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
    """The split pass of the ``"bf16x3"`` route: ``(hi, lo)`` bfloat16
    halves of each of the float32, contiguous q, k and v, in their shape.
    On the card one launch of ``csrc/flash_attention_bf16x3.cu``'s split
    kernel writes all six into tensors this wrapper allocates; on the CPU
    :func:`plain_split` runs.  ``split_bf16x3.launches`` counts the
    launches."""
    for t in (q, k, v):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("split_bf16x3 takes contiguous float32 tensors")
        if t.device != q.device or t.numel() % 4:
            raise ValueError("split_bf16x3 operands share a device and "
                             "hold a multiple of 4 elements")
    if k.numel() != v.numel():
        raise ValueError("split_bf16x3: k and v must have one size")
    if q.device.type == "cpu":
        return tuple(plain_split(t) for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("split_bf16x3 operands must start on a 16-byte "
                         "boundary")
    halves = [torch.empty(t.shape, dtype=torch.bfloat16, device=t.device)
              for t in (q, q, k, k, v, v)]
    fn = _build.entry(SOURCES["bf16x3"], [ctypes.c_void_p] * 9
                      + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
                      symbol="flash_attention_bf16x3_split")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check_status("flash_attention_bf16x3_split", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *[h.data_ptr() for h in halves], q.numel(), k.numel(), stream))
    split_bf16x3.launches += 1
    return tuple(zip(halves[::2], halves[1::2]))


split_bf16x3.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int | None = None,
                    block_kv: int | None = None, q_offset: int | None = None,
                    force_simt: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """q: (b, h, sq, d); k, v: (b, h, skv, d), float32 or bfloat16,
    contiguous.  Grouped-head (GQA) callers broadcast kv heads before the
    call.  ``q_offset`` is the absolute position of q[0] in the kv
    sequence (default ``skv - sq``).  A block left as None takes the JAX
    kernel's default, 128, which must divide its length as there; the
    pair is then fitted to what launches (:func:`fit_blocks`).  On the
    card the kernel of the pair's :func:`route` runs on the current
    stream without synchronising; ``force_simt`` runs the CUDA-core
    kernel instead, within its own limits (to time it where a tensor-core
    route is the rule).  ``scale`` multiplies the fp32 scores inside the
    kernel (:func:`_scale`; 1/sqrt(d) when None)."""
    b, h, sq, skv, d = _check_operands(q, k, v)
    if q_offset is None:
        q_offset = skv - sq
    _check_offset(causal, q_offset)
    fit = block_q is None or block_kv is None
    block_q = JAX_DEFAULT_BLOCK if block_q is None else block_q
    block_kv = JAX_DEFAULT_BLOCK if block_kv is None else block_kv
    validate_blocks(sq, skv, block_q, block_kv)
    if fit:
        block_q, block_kv = fit_blocks(sq, skv, block_q, block_kv, d,
                                       q.dtype)
    lim = (_simt_limits(int(block_q), int(block_kv), d) if force_simt
           else launch_limits(block_q, block_kv, d, q.dtype))
    if not lim.ok:
        raise ValueError(f"flash_attention: {lim.reason}")
    if sq // block_q > MAX_Q_BLOCKS:
        raise ValueError(f"flash_attention: {sq // block_q} q blocks exceed "
                         f"the launch's {MAX_Q_BLOCKS}")
    if lim.route != "simt" and b * h * max(sq, skv) >= 2 ** 31:
        raise ValueError("flash_attention: b*h*s rows exceed the 32-bit "
                         f"TMA coordinates of the {lim.route} route")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_attention operands must be contiguous")
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, q_offset=q_offset, scale=scale)
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention operands must start on a "
                             "16-byte boundary")
    out = torch.empty_like(q)
    operands = (q, k, v)
    if lim.route == "bf16x3":   # hi, lo of q, k and v; freed after the launch
        operands = sum(split_bf16x3(q, k, v), ())
    args = [t.data_ptr() for t in operands] + [
        out.data_ptr(), b * h, sq, skv, d, int(block_q), int(block_kv),
        int(causal), int(q_offset), _scale(d, scale)]
    argtypes = ([ctypes.c_void_p] * (len(operands) + 1) + [ctypes.c_longlong]
                + [ctypes.c_int] * 7 + [ctypes.c_float])
    if lim.route == "simt":
        args.append(DTYPES[q.dtype])
        argtypes.append(ctypes.c_int)
    name = SOURCES[lim.route]
    fn = _build.entry(name, argtypes + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check_status(name, fn(*args, stream))
    flash_attention.launches += 1
    flash_attention.launches_by_route[lim.route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {r: 0 for r in SOURCES}
#: calls of :func:`flash_attention_backward` on each of its routes (a
#: ``"kernel"`` call launches the backward kernel), and their sum
flash_attention.backward_calls_by_route = {r: 0 for r in BACKWARD_ROUTES}
flash_attention.backward_calls = 0


# The operator ``repro_torch::flash_attention``, defined through
# ``torch.library.Library``: its kernel serves every device (the wrapper
# picks the route, or the plain version on the CPU), and it has no
# autograd kernel (``FlashAttentionFn`` calls it under no_grad).  The
# ``custom_op`` decorator would add an autograd layer in Python to the
# host time of every call.
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int block_q, int block_kv, int q_offset, float? scale=None) "
            "-> Tensor")
_LIB.impl("flash_attention",
          lambda q, k, v, causal, block_q, block_kv, q_offset, scale=None:
          flash_attention(q, k, v, causal=causal, block_q=block_q,
                          block_kv=block_kv, q_offset=q_offset, scale=scale),
          "CompositeExplicitAutograd")


@torch.library.register_fake("repro_torch::flash_attention", lib=_LIB)
def _flash_fake(q, k, v, causal, block_q, block_kv, q_offset, scale=None):
    return torch.empty_like(q)


def _scaled(args: tuple, scale: float | None) -> tuple:
    """An operator's arguments, the scale appended only where one is
    given: the default call stays the call it has always been."""
    return args if scale is None else args + (float(scale),)


def flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, block_q: int, block_kv: int,
             q_offset: int, scale: float | None = None) -> torch.Tensor:
    """:func:`flash_attention` at a fitted block pair and a resolved
    ``q_offset``, as one operator (``repro_torch::flash_attention``) that
    the dispatcher sees whole: a dispatch mode records it as one op (the
    graph analysis prices it by the flash formula), and on meta or fake
    tensors it runs its fake, which launches nothing.  On real tensors it
    is the wrapper: the kernel of the pair's route on the card, or a
    raise; the plain version on the CPU."""
    return torch.ops.repro_torch.flash_attention.default(
        *_scaled((q, k, v, causal, block_q, block_kv, q_offset), scale))


#: the float32 transient :func:`attention_backward` may hold at once:
#: about four score-sized tensors per head
BACKWARD_TRANSIENT_BYTES = 2 << 30


def attention_backward(q, k, v, grad_out, causal: bool = True,
                       q_offset: int | None = None,
                       scale: float | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of softmax attention with respect to q, k and v, written
    out in PyTorch: the counterpart of what ``jax.grad`` takes through
    ``repro.models.attention``'s softmax attention (the JAX kernel has no
    backward).  Operands (b, h, s, d) as :func:`flash_attention` takes
    them; ``grad_out`` is the gradient of its output.  It is the plain
    version of :func:`flash_attention_backward`'s kernel, and that
    function's route for float32 and head dim 256.

    The forward writes no row log-sum-exp, so the float32 scores and the
    softmax P are recomputed from q and k; then dV = Pᵀ·dO, dP = dO·Vᵀ,
    dS = P ⊙ (dP − rowsum(P ⊙ dP)) (softmax's own vector-Jacobian product,
    as JAX takes it), dQ = scale·dS·K and dK = scale·dSᵀ·Q, each cast to
    its operand's type.  FlashAttention's rowsum(dO ⊙ O) equals
    rowsum(P ⊙ dP) only for O = P·V exactly; the kernel's O rounds p to
    bf16 for its P·V product and is stored in bf16, and where this init's
    softmax is sharp (scores in the hundreds) dS is a small difference of
    large terms, which that rounding moves by several per cent of dQ.
    Masked pairs have P = 0, so they get no gradient.  The (batch, head)
    pairs are walked in chunks that keep four score-sized float32
    tensors within ``BACKWARD_TRANSIENT_BYTES``.  ``scale`` is the
    forward's (:func:`_scale`)."""
    b, h, sq, skv, d = _check_operands(q, k, v)
    if q_offset is None:
        q_offset = skv - sq
    _check_offset(causal, q_offset)
    scale = _scale(d, scale)
    bh = b * h
    chunk = max(1, BACKWARD_TRANSIENT_BYTES // (4 * 4 * sq * skv))
    flat = [t.reshape(bh, t.shape[2], d) for t in (q, k, v, grad_out)]
    grads = [torch.empty(bh, t.shape[2], d, dtype=t.dtype, device=t.device)
             for t in (q, k, v)]
    keep = None
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + q_offset
        keep = rows >= torch.arange(skv, device=q.device)[None]
    for i in range(0, bh, chunk):
        qi, ki, vi, doi = (t[i:i + chunk].float() for t in flat)
        s = torch.matmul(qi, ki.transpose(-1, -2)) * scale
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        grads[2][i:i + chunk] = torch.matmul(p.transpose(-1, -2), doi)
        ds = torch.matmul(doi, vi.transpose(-1, -2))
        ds.sub_((p * ds).sum(-1, keepdim=True)).mul_(p)
        del p
        grads[0][i:i + chunk] = torch.matmul(ds, ki) * scale
        grads[1][i:i + chunk] = torch.matmul(ds.transpose(-1, -2), qi) * scale
    return tuple(g.reshape(t.shape) for g, t in zip(grads, (q, k, v)))


def backward_smem_bytes(head_dim: int) -> tuple[int, int]:
    """Dynamic shared memory of the backward's two CTAs at the
    instantiated head dim D of ``head_dim``: the rows pass's (alignment,
    its q and dO tiles of :data:`BACKWARD_ROWS` rows, a ring of
    :data:`WGMMA_STAGES` k and v tiles, the mbarriers) and the fused
    pass's (alignment, two k and two v tiles held, a ring of
    :data:`BACKWARD_FUSED_STAGES` q and dO tiles with their rows' fp32 LSE
    and D, the bf16 dS tiles, each consumer's fp32 staging of its part of
    dQ's share — 64 columns at D = 128, else D — by step parity, and the
    mbarriers)."""
    D, r = tc_head_dim(head_dim), BACKWARD_ROWS
    rows = (WGMMA_SMEM_ALIGN + WGMMA_SMEM_BARRIERS
            + 2 * D * (2 * r + 2 * WGMMA_STAGES * r))
    stages = BACKWARD_FUSED_STAGES
    fused = (WGMMA_SMEM_ALIGN + 2 * D * (4 * r + 2 * stages * r)
             + BACKWARD_DS_BYTES + 4 * r * (D // 2 if D == 128 else D) * 4
             + 8 * stages * r + BACKWARD_FUSED_BARRIERS)
    return rows, fused


def backward_scratch(bh: int, seq_q: int, head_dim: int, device
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scratch one kernel backward holds while it runs, allocated by
    its caller: the rows' fp32 LSE and D (2, bh·sq), dQ's fp32 sums
    (bh·sq·D at the instantiated head dim D) and the int32 counters, one
    per (batch·head, q block).  At granite-8b's (32 heads, 4096, 128) that
    is 65 MiB, freed when the call returns."""
    D = tc_head_dim(head_dim)
    n = bh * seq_q
    return (torch.empty(2, n, dtype=torch.float32, device=device),
            torch.empty(n * D, dtype=torch.float32, device=device),
            torch.empty(n // BACKWARD_ROWS, dtype=torch.int32,
                        device=device))


def backward_launch_limits(seq_q: int, seq_kv: int, head_dim: int,
                           dtype=torch.bfloat16, q_offset: int = 0
                           ) -> LaunchLimits:
    """The backward's one rule: its kernel (route ``"kernel"``) takes
    bfloat16 at a :func:`tc_head_dim` in :data:`BACKWARD_HEAD_DIMS` (head
    dims between them padded with zero columns), both lengths multiples
    of :data:`BACKWARD_ROWS`, ``q_offset >= 0`` and rows within the TMA's
    32-bit coordinates (checked by the wrapper, per call); the larger of
    its two CTAs' shared memory (:func:`backward_smem_bytes`) and of their
    threads (:data:`BACKWARD_THREADS`).  Anything else takes
    :func:`attention_backward` (route ``"plain"``), and ``reason`` says
    why."""
    sq, skv, d = int(seq_q), int(seq_kv), int(head_dim)
    D = tc_head_dim(d)
    r = BACKWARD_ROWS
    reason = ""
    if torch_dtype(dtype) != torch.bfloat16:
        reason = f"the backward kernel takes bfloat16, not {dtype}"
    elif D not in BACKWARD_HEAD_DIMS:
        reason = (f"head_dim={d} runs at {D}, off the backward kernel's "
                  f"{BACKWARD_HEAD_DIMS}")
    elif sq <= 0 or skv <= 0 or sq % r or skv % r:
        reason = (f"seq_q={sq} and seq_kv={skv} must be positive multiples "
                  f"of {r}")
    elif sq // r > MAX_Q_BLOCKS or skv // r > MAX_Q_BLOCKS:
        reason = f"more than {MAX_Q_BLOCKS} blocks of {r} rows"
    elif int(q_offset) < 0:
        reason = f"q_offset={q_offset} < 0"
    smem = 0 if D not in BACKWARD_HEAD_DIMS else max(backward_smem_bytes(d))
    return LaunchLimits(smem_bytes=smem, threads=max(BACKWARD_THREADS),
                        reason=reason, route="plain" if reason else "kernel")


def backward_route(q: torch.Tensor, k: torch.Tensor,
                   q_offset: int | None = None) -> str:
    """``"kernel"`` where :func:`backward_launch_limits` takes q's and k's
    shapes and type (``q_offset`` defaults to ``skv - sq``), else
    ``"plain"``: decided from shapes alone, on every device."""
    sq, skv = int(q.shape[2]), int(k.shape[2])
    off = skv - sq if q_offset is None else int(q_offset)
    return backward_launch_limits(sq, skv, int(q.shape[3]), q.dtype,
                                  off).route


def _count_backward(route_name: str) -> None:
    flash_attention.backward_calls_by_route[route_name] += 1
    flash_attention.backward_calls += 1


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, grad_out: torch.Tensor,
                             causal: bool = True, q_offset: int | None = None,
                             scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of softmax attention, operands (b, h, s, d) as
    :func:`attention_backward` takes them, in the operands' type.

    On the card at :func:`backward_route` ``"kernel"`` the three launches
    of ``csrc/flash_attention_bwd.cu`` run on the current stream without
    synchronising (the rows pass: fp32 LSE and D = rowsum(P ⊙ dP); the
    fused pass: dK, dV and dQ's fp32 sums, added in a fixed order, so a
    repeat gives the same bits; the dQ cast), with
    :func:`backward_scratch` allocated here; q, k, v and ``grad_out``
    must be contiguous and start on 16 bytes, and a failed build or
    launch raises.  Everywhere else — the ``"plain"`` route (float32,
    head dim 256), and every call on the CPU —
    :func:`attention_backward` runs.
    ``flash_attention.backward_calls_by_route`` counts the route that
    ran.  ``scale`` is the forward's (:func:`_scale`)."""
    b, h, sq, skv, d = _check_operands(q, k, v)
    if grad_out.shape != q.shape or grad_out.dtype != q.dtype \
            or grad_out.device != q.device:
        raise ValueError(f"grad_out must have q's shape, dtype and device, "
                         f"got {tuple(grad_out.shape)} {grad_out.dtype}")
    if q_offset is None:
        q_offset = skv - sq
    _check_offset(causal, q_offset)
    lim = backward_launch_limits(sq, skv, d, q.dtype, q_offset)
    if lim.route == "plain" or q.device.type == "cpu":
        _count_backward("plain")
        extra = {} if scale is None else {"scale": scale}
        return attention_backward(q, k, v, grad_out, causal=causal,
                                  q_offset=q_offset, **extra)
    if b * h * max(sq, skv) >= 2 ** 31:
        raise ValueError("flash_attention_backward: b*h*s rows exceed the "
                         "32-bit TMA coordinates")
    for t in (q, k, v, grad_out):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention_backward operands must be "
                             "contiguous and start on a 16-byte boundary")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    rows, sums, counters = backward_scratch(b * h, sq, d, q.device)
    fn = _build.entry(BACKWARD_SOURCE, [ctypes.c_void_p] * 11
                      + [ctypes.c_longlong] + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check_status(BACKWARD_SOURCE, fn(
            *[t.data_ptr() for t in (q, k, v, grad_out, dq, dk, dv)],
            rows[0].data_ptr(), rows[1].data_ptr(), sums.data_ptr(),
            counters.data_ptr(), b * h, sq, skv, d, int(causal),
            int(q_offset), _scale(d, scale), stream))
    _count_backward("kernel")
    return dq, dk, dv


# ``repro_torch::flash_attention_backward``: the backward as one operator,
# so that a dispatch mode sees it whole and fake tensors (the dry run's
# train step) run its fake, which launches nothing.  Its kernel serves
# every device (the wrapper picks the route); it has no autograd kernel.
_LIB.define("flash_attention_backward(Tensor q, Tensor k, Tensor v, "
            "Tensor grad_out, bool causal, int q_offset, float? scale=None) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.impl("flash_attention_backward",
          lambda q, k, v, grad_out, causal, q_offset, scale=None:
          flash_attention_backward(q, k, v, grad_out, causal=causal,
                                   q_offset=q_offset, scale=scale),
          "CompositeExplicitAutograd")


@torch.library.register_fake("repro_torch::flash_attention_backward",
                             lib=_LIB)
def _backward_fake(q, k, v, grad_out, causal, q_offset, scale=None):
    if backward_route(q, k, q_offset) == "kernel":
        b, h, sq, d = q.shape
        backward_scratch(b * h, sq, d, q.device)   # the card's transient
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                grad_out: torch.Tensor, causal: bool, q_offset: int,
                scale: float | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_backward` at a resolved ``q_offset`` as the
    operator ``repro_torch::flash_attention_backward``: the graph
    analysis prices it by its formula, and on meta or fake tensors it
    runs its fake."""
    return torch.ops.repro_torch.flash_attention_backward.default(
        *_scaled((q, k, v, grad_out, causal, q_offset), scale))


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` under autograd.  The forward is
    :func:`flash_op` (fitted blocks, a resolved ``q_offset``): the kernel's
    launch on the card and :func:`plain` on the CPU, as the wrapper
    chooses, run without a graph; it saves q, k and v.  The backward is
    :func:`backward_op` where :func:`backward_route` picks the kernel
    (the backward kernel on the card, :func:`attention_backward` on the
    CPU), else :func:`flash_attention_backward` on its plain route, whose
    own ops a dispatch mode records.  ``scale`` (None: 1/sqrt(d)) reaches
    both."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv, q_offset,
                scale=None):
        with torch.no_grad(), obs.span("kernel.flash_fwd"):
            out = flash_op(q, k, v, causal, block_q, block_kv, q_offset,
                           scale)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_offset, ctx.scale = causal, q_offset, scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        with obs.span("kernel.flash_bwd", "bwd"):
            if backward_route(q, k, ctx.q_offset) == "kernel":
                dq, dk, dv = backward_op(q, k, v, grad_out, ctx.causal,
                                         ctx.q_offset, ctx.scale)
            else:
                dq, dk, dv = flash_attention_backward(
                    q, k, v, grad_out, causal=ctx.causal,
                    q_offset=ctx.q_offset, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None, None


def _compiled_limits(route_name: str, block_q: int, block_kv: int,
                     head_dim: int) -> tuple[int, int]:
    name = SOURCES[route_name]
    fn = _build.entry(name, [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
                      symbol=f"{name}_limits")
    smem, threads = ctypes.c_longlong(), ctypes.c_int()
    _build.check_status(f"{name}_limits", fn(
        int(head_dim), int(block_kv), int(block_q), ctypes.byref(smem),
        ctypes.byref(threads)))
    return smem.value, threads.value


def compiled_wgmma_limits(block_q: int, block_kv: int, head_dim: int
                          ) -> tuple[int, int]:
    """(shared memory bytes, threads) of one bf16 tensor-core CTA as the
    built library states them (``repro_flash_attention_wgmma_limits``, at
    the padded head dim for a head_dim between instantiations), to hold
    :func:`launch_limits` to the source; raises outside
    :data:`WGMMA_SET`, as the library refuses such a triple; builds the
    library if needed."""
    return _compiled_limits("wgmma", block_q, block_kv, head_dim)


def compiled_bf16x3_limits(block_q: int, block_kv: int, head_dim: int
                           ) -> tuple[int, int]:
    """The same for the f32 tensor-core CTA
    (``repro_flash_attention_bf16x3_limits``); raises outside
    :data:`BF16X3_SET`, as the library refuses such a triple."""
    return _compiled_limits("bf16x3", block_q, block_kv, head_dim)


def compiled_simt_limits(block_q: int, block_kv: int, head_dim: int
                         ) -> tuple[int, int]:
    """(shared memory bytes, threads) of the CUDA-core CTA a triple
    launches, tiled or general, as the built library states them
    (``repro_flash_attention_limits``), to hold :func:`_simt_limits` to
    the source; raises where the library refuses the triple (sizes off
    the granule, or over :data:`SMEM_PER_CTA`)."""
    return _compiled_limits("simt", block_q, block_kv, head_dim)


def compiled_backward_limits(head_dim: int) -> tuple[int, int, int, int]:
    """(rows-pass CTA shared bytes, fused-pass CTA shared bytes, threads of
    each) as the built backward library states them
    (``repro_flash_attention_bwd_limits``), to hold
    :func:`backward_smem_bytes` and :data:`BACKWARD_THREADS` to the
    source; raises at a head dim it is not built for; builds the library
    if needed."""
    fn = _build.entry(BACKWARD_SOURCE, [ctypes.c_int] + [ctypes.c_void_p] * 4,
                      symbol=f"{BACKWARD_SOURCE}_limits")
    a, b = ctypes.c_longlong(), ctypes.c_longlong()
    ta, tb = ctypes.c_int(), ctypes.c_int()
    _build.check_status(f"{BACKWARD_SOURCE}_limits", fn(
        int(head_dim), ctypes.byref(a), ctypes.byref(b), ctypes.byref(ta),
        ctypes.byref(tb)))
    return a.value, b.value, ta.value, tb.value
