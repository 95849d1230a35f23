"""Blocked online-softmax (flash) attention: its hand-written Hopper kernel
(``csrc/flash_attention.cu``), the kernel's launch limits, and beside them
its plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention``.  :func:`flash_attention`
has the JAX signature without ``interpret``: it launches the CUDA kernel
for tensors on the card and raises if it cannot; for tensors on the CPU
it runs :func:`plain`.  The checks (block divisibility, the launch
limits, operand types and shapes) are the same on both devices, so a call
that would be refused on the card is refused on the CPU too.
``flash_attention.launches`` counts the launches.

:func:`launch_limits` is the one statement of what the kernel can launch;
the wrapper, the shared-memory advisor
(:func:`repro_torch.core.blocking.attention_cta_tiles`),
:func:`default_config` and the tuner's ``FlashAttentionSpace`` all read
it, so a candidate the tuner calls feasible launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from . import _build

NEG_INF = -2.0 ** 30

#: CTA size of the kernel
THREADS = 256
#: block_q, block_kv and head_dim must be multiples of this: the kernel's
#: 4x4 register microtiles and 16-byte shared loads
GRANULE = 4
#: shared memory one CTA may use on the H100 (227 KiB, opt-in maximum)
SMEM_PER_CTA = 232448
#: the q-block grid axis is the launch's y dimension
MAX_Q_BLOCKS = 65535
#: peak-rate key (``peak flops`` in the machine file) of the unit the
#: kernel's products run on: CUDA cores in fp32.  A tensor-core kernel
#: switches it to "BF16".
MATMUL_UNIT = "FP32"
#: cycles a CTA spends per kv step outside the arithmetic — four barriers
#: and the exposed latency of staging the k/v tiles.  An estimate; the
#: tuner's calibration factor absorbs its error.
STEP_OVERHEAD_CY = 1000.0
#: the kernel's dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: Starting configurations for the autotuner (:mod:`repro_torch.tune`),
#: keyed by the smallest kv sequence length the row applies to:
#: ``(block_q, block_kv)``.  Every row launches at head_dim 128 (the tiles
#: are staged in fp32 whatever the input type, so the dtype does not
#: change the working set); the TPU table's (256, 512) row would need
#: about 1 MiB of shared memory.
DEFAULT_CONFIGS: tuple[tuple[int, tuple[int, int]], ...] = (
    (4096, (64, 64)),
    (1024, (64, 64)),
    (256, (32, 64)),
    (0, (16, 32)),
)


@dataclasses.dataclass(frozen=True)
class LaunchLimits:
    """What one CTA of the kernel needs for a block pair, and why it
    cannot launch (``reason``, empty when it can)."""
    smem_bytes: int
    threads: int
    reason: str = ""

    @property
    def ok(self) -> bool:
        return not self.reason


def torch_dtype(dtype) -> torch.dtype:
    """``torch.float32``/``torch.bfloat16`` from a torch dtype or its name;
    raises ``TypeError`` for any other type."""
    t = _DTYPE_NAMES.get(dtype, dtype) if isinstance(dtype, str) else dtype
    if t not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, "
                        f"got {dtype}")
    return t


def launch_limits(block_q: int, block_kv: int, head_dim: int,
                  dtype=torch.float32) -> LaunchLimits:
    """Shared memory and threads of one CTA for ``(block_q, block_kv,
    head_dim)`` in ``dtype``, and whether the kernel can launch it: the
    three sizes positive multiples of :data:`GRANULE`, the dtype float32
    or bfloat16, and the CTA's shared memory — q and k staged transposed,
    v, the score tile and the accumulator, all fp32, plus m, l and alpha —
    within :data:`SMEM_PER_CTA`."""
    torch_dtype(dtype)
    bq, bkv, d = int(block_q), int(block_kv), int(head_dim)
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


def fit_blocks(seq_q: int, seq_kv: int, block_q: int, block_kv: int,
               head_dim: int) -> tuple[int, int]:
    """Clamp ``(block_q, block_kv)`` to the sequence lengths, halve each
    until it divides its length, then halve ``block_kv``, then
    ``block_q``, while the pair does not fit :func:`launch_limits`.  With
    blocks of the form ``GRANULE * 2**k`` and lengths that are multiples
    of :data:`GRANULE` the result launches; raises ``ValueError`` when no
    pair does."""
    bq = max(1, min(block_q, seq_q))
    bkv = max(1, min(block_kv, seq_kv))
    while seq_q % bq:
        bq //= 2
    while seq_kv % bkv:
        bkv //= 2

    def fits(a: int, b: int) -> bool:
        return launch_limits(a, b, head_dim).ok

    while not fits(bq, bkv) and bkv % (2 * GRANULE) == 0:
        bkv //= 2
    while not fits(bq, bkv) and bq % (2 * GRANULE) == 0:
        bq //= 2
    lim = launch_limits(bq, bkv, head_dim)
    if not lim.ok:
        raise ValueError(f"no launchable blocks for seq_q={seq_q}, "
                         f"seq_kv={seq_kv}: {lim.reason}")
    return bq, bkv


def default_config(seq_q: int, seq_kv: int, head_dim: int = 128
                   ) -> tuple[int, int]:
    """The default ``(block_q, block_kv)`` for a problem shape: the
    :data:`DEFAULT_CONFIGS` row for ``seq_kv``, clamped by halving to
    divisors of the sequence lengths and to the launch limits at
    ``head_dim`` (:func:`fit_blocks`)."""
    for floor, (bq, bkv) in DEFAULT_CONFIGS:
        if seq_kv >= floor:
            break
    return fit_blocks(seq_q, seq_kv, bq, bkv, head_dim)


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
    sequence (default ``skv - sq``).  On the card the kernel runs on the
    current stream without synchronising."""
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
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_attention operands must be contiguous")
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, q_offset=q_offset)
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention operands must start on a "
                             "16-byte boundary")
    fn = _build.entry("flash_attention",
                      [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                      + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                              ctypes.c_void_p])
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check_status("flash_attention", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, sq, skv, d, int(block_q), int(block_kv), int(causal),
            int(q_offset), _scale(d), DTYPES[q.dtype], stream))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
