"""Blocked online-softmax (flash) attention: its two hand-written Hopper
kernels, their launch limits, and beside them the plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention``.  :func:`flash_attention`
has the JAX signature without ``interpret``: it launches a CUDA kernel
for tensors on the card and raises if it cannot; for tensors on the CPU
it runs :func:`plain`.  The checks (block divisibility, the launch
limits, operand types and shapes) are the same on both devices, so a call
that would be refused on the card is refused on the CPU too.

Two routes, chosen by one rule, :func:`route`, before anything launches:

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bfloat16 on the tensor
  cores, at the head dims, kv blocks and q blocks the kernel was
  instantiated for (:data:`WGMMA_HEAD_DIMS`, :data:`WGMMA_BLOCK_KV`,
  :data:`WGMMA_BLOCK_Q`).  It rounds p to bf16 for the p·v product, the
  one departure from the reference, within its 2e-2 bf16 tolerance.
- ``"simt"`` (``csrc/flash_attention.cu``): everything else — all
  float32, and bfloat16 outside that set — on the CUDA cores in fp32.

A failed build or launch on a route raises; it never falls back to the
other route or to :func:`plain`.  ``flash_attention.launches`` counts
every launch and ``flash_attention.launches_by_route`` each route's.

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
import math

import torch

from . import _build

NEG_INF = -2.0 ** 30

#: CTA size of the CUDA-core ("simt") kernel
THREADS = 256
#: block_q, block_kv and head_dim must be multiples of this: the simt
#: kernel's 4x4 register microtiles and 16-byte shared loads
GRANULE = 4
#: shared memory one CTA may use on the H100 (227 KiB, opt-in maximum)
SMEM_PER_CTA = 232448
#: shared memory of one SM (228 KiB), of which each resident CTA also
#: takes SMEM_RESERVED; threads and CTAs one SM holds
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
THREADS_PER_SM = 2048
CTAS_PER_SM = 32
#: the q-block grid axis is the launch's y dimension
MAX_Q_BLOCKS = 65535
#: the tensor-core kernel's instantiated set: head_dim and block_kv are
#: its template parameters; block_q is 128 (two 64-row warpgroup tiles) or
#: divides the 64-row tile, whose rows past block_q are padding
WGMMA_HEAD_DIMS = (32, 64, 96, 128)
WGMMA_BLOCK_KV = (64, 128)
WGMMA_BLOCK_Q = (4, 8, 16, 32, 64, 128)
WGMMA_TILE_M = 64
#: its K/V ring depth, and bytes for alignment and mbarriers
WGMMA_STAGES = 2
WGMMA_SMEM_ALIGN = 1024
WGMMA_SMEM_BARRIERS = 64
#: the CUDA source of each route
SOURCES = {"wgmma": "flash_attention_wgmma", "simt": "flash_attention"}
#: peak-rate key (``peak flops`` in the machine file) of the unit each
#: route's products run on: the tensor cores in bf16, the CUDA cores in
#: fp32
MATMUL_UNIT = {"wgmma": "BF16", "simt": "FP32"}
#: cycles a CTA spends per kv step outside the arithmetic.  simt: four
#: barriers and the exposed latency of staging the k/v tiles.  wgmma: the
#: full-barrier wait and two wgmma issue → wait round trips that the
#: softmax sits between.  Both are estimates; the tuner's calibration
#: factor absorbs their error.
STEP_OVERHEAD_CY = {"wgmma": 600.0, "simt": 1000.0}
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
#: the same for bfloat16 at a head_dim of :data:`WGMMA_HEAD_DIMS`: wgmma
#: pairs, smaller kv blocks and then one warpgroup for shorter sequences
DEFAULT_CONFIGS_BF16: tuple[tuple[int, tuple[int, int]], ...] = (
    (1024, (128, 128)),
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
        threads (registers are not modelled)."""
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


def route(block_q: int, block_kv: int, head_dim: int, dtype) -> str:
    """``"wgmma"`` for bfloat16 at a head_dim and block_kv the tensor-core
    kernel was instantiated for and a block_q of :data:`WGMMA_BLOCK_Q`;
    ``"simt"`` for everything else (all float32, whose 2e-3 tolerance
    TF32 would not meet reliably, and any other bf16 shape)."""
    if (torch_dtype(dtype) == torch.bfloat16
            and int(head_dim) in WGMMA_HEAD_DIMS
            and int(block_kv) in WGMMA_BLOCK_KV
            and int(block_q) in WGMMA_BLOCK_Q):
        return "wgmma"
    return "simt"


def wgmma_smem_bytes(block_q: int, block_kv: int, head_dim: int) -> int:
    """Dynamic shared memory of one tensor-core CTA: 1024 bytes of
    alignment slack, the bf16 q tiles (64 rows per warpgroup), the ring of
    :data:`WGMMA_STAGES` k and v tiles, and the mbarriers."""
    nwg = 2 if block_q > WGMMA_TILE_M else 1
    return (WGMMA_SMEM_ALIGN + WGMMA_SMEM_BARRIERS
            + 2 * head_dim * (WGMMA_TILE_M * nwg
                              + 2 * WGMMA_STAGES * block_kv))


def launch_limits(block_q: int, block_kv: int, head_dim: int,
                  dtype=torch.float32) -> LaunchLimits:
    """Shared memory and threads of one CTA for ``(block_q, block_kv,
    head_dim)`` in ``dtype`` on the :func:`route` the pair takes, and
    whether it can launch.

    wgmma: :func:`wgmma_smem_bytes` (always within the limit at the
    instantiated sizes) and 128 threads per 64-row warpgroup tile plus a
    producer warp.  simt: the three sizes positive multiples of
    :data:`GRANULE` and the CTA's shared memory — q and k staged
    transposed, v, the score tile and the accumulator, all fp32, plus m, l
    and alpha — within :data:`SMEM_PER_CTA`, for 256 threads."""
    bq, bkv, d = int(block_q), int(block_kv), int(head_dim)
    if route(bq, bkv, d, dtype) == "wgmma":
        nwg = 2 if bq > WGMMA_TILE_M else 1
        return LaunchLimits(smem_bytes=wgmma_smem_bytes(bq, bkv, d),
                            threads=128 * nwg + 32, route="wgmma")
    smem = 4 * (2 * d * bq + 2 * d * bkv + bq * bkv + 3 * bq)
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


def _wgmma_pair(seq_q: int, seq_kv: int, block_q: int, block_kv: int
                ) -> tuple[int, int] | None:
    """The largest wgmma blocks at most ``(block_q, block_kv)`` (else the
    smallest) that divide the lengths; None when none divides."""
    qs = [b for b in WGMMA_BLOCK_Q if seq_q % b == 0]
    ks = [b for b in WGMMA_BLOCK_KV if seq_kv % b == 0]
    if not qs or not ks:
        return None
    return (max((b for b in qs if b <= block_q), default=qs[0]),
            max((b for b in ks if b <= block_kv), default=ks[0]))


def fit_blocks(seq_q: int, seq_kv: int, block_q: int, block_kv: int,
               head_dim: int, dtype=torch.float32) -> tuple[int, int]:
    """Launchable blocks near ``(block_q, block_kv)`` for the lengths.

    bfloat16 at a head_dim of :data:`WGMMA_HEAD_DIMS` takes a wgmma pair
    wherever one divides the lengths (:func:`_wgmma_pair`).  Otherwise:
    clamp the blocks to the lengths, halve each until it divides its
    length, then halve ``block_kv``, then ``block_q``, while the pair does
    not fit :func:`launch_limits`.  With blocks of the form
    ``GRANULE * 2**k`` and lengths that are multiples of :data:`GRANULE`
    the result launches; raises ``ValueError`` when no pair does."""
    if torch_dtype(dtype) == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        pair = _wgmma_pair(seq_q, seq_kv, block_q, block_kv)
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

    while not fits(bq, bkv) and bkv % (2 * GRANULE) == 0:
        bkv //= 2
    while not fits(bq, bkv) and bq % (2 * GRANULE) == 0:
        bq //= 2
    lim = launch_limits(bq, bkv, head_dim, dtype)
    if not lim.ok:
        raise ValueError(f"no launchable blocks for seq_q={seq_q}, "
                         f"seq_kv={seq_kv}: {lim.reason}")
    return bq, bkv


def default_config(seq_q: int, seq_kv: int, head_dim: int = 128,
                   dtype=torch.float32) -> tuple[int, int]:
    """The default ``(block_q, block_kv)`` for a problem shape: the row
    for ``seq_kv`` of :data:`DEFAULT_CONFIGS_BF16` (bfloat16 at a head_dim
    of :data:`WGMMA_HEAD_DIMS`) or :data:`DEFAULT_CONFIGS` (the rest),
    fitted to the lengths and the launch limits (:func:`fit_blocks`)."""
    table = DEFAULT_CONFIGS
    if torch_dtype(dtype) == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        table = DEFAULT_CONFIGS_BF16
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
          causal: bool = True, q_offset: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: fp32 scores ``q.kᵀ *
    scale``, the causal mask ``q_pos + q_offset >= k_pos`` with the finite
    -2^30, softmax, ``p.v``, output in the input dtype.  ``q_offset``
    defaults to ``skv - sq``."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    if q_offset is None:
        q_offset = skv - sq
    _check_offset(causal, q_offset)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * \
        _scale(d)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + q_offset
        s = torch.where(rows >= torch.arange(skv, device=q.device)[None],
                        s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _scale(d: int) -> float:
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_kv: int = 128,
                    q_offset: int | None = None) -> torch.Tensor:
    """q: (b, h, sq, d); k, v: (b, h, skv, d), float32 or bfloat16,
    contiguous.  Grouped-head (GQA) callers broadcast kv heads before the
    call.  ``q_offset`` is the absolute position of q[0] in the kv
    sequence (default ``skv - sq``).  On the card the kernel of the pair's
    :func:`route` runs on the current stream without synchronising."""
    b, h, sq, skv, d = _check_operands(q, k, v)
    if q_offset is None:
        q_offset = skv - sq
    _check_offset(causal, q_offset)
    validate_blocks(sq, skv, block_q, block_kv)
    lim = launch_limits(block_q, block_kv, d, q.dtype)
    if not lim.ok:
        raise ValueError(f"flash_attention: {lim.reason}")
    if sq // block_q > MAX_Q_BLOCKS:
        raise ValueError(f"flash_attention: {sq // block_q} q blocks exceed "
                         f"the launch's {MAX_Q_BLOCKS}")
    if lim.route == "wgmma" and b * h * max(sq, skv) >= 2 ** 31:
        raise ValueError("flash_attention: b*h*s rows exceed the 32-bit "
                         "TMA coordinates of the wgmma route")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_attention operands must be contiguous")
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, q_offset=q_offset)
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention operands must start on a "
                             "16-byte boundary")
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, sq, skv, d, int(block_q), int(block_kv), int(causal),
            int(q_offset), _scale(d)]
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
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


def compiled_wgmma_limits(block_q: int, block_kv: int, head_dim: int
                          ) -> tuple[int, int]:
    """(shared memory bytes, threads) of one tensor-core CTA as the built
    library states them (``repro_flash_attention_wgmma_limits``), to hold
    :func:`launch_limits` to the source; builds the library if needed."""
    fn = getattr(_build.library(SOURCES["wgmma"]),
                 "repro_flash_attention_wgmma_limits")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    smem, threads = ctypes.c_longlong(), ctypes.c_int()
    _build.check_status("flash_attention_wgmma_limits", fn(
        int(head_dim), int(block_kv), int(block_q), ctypes.byref(smem),
        ctypes.byref(threads)))
    return smem.value, threads.value
