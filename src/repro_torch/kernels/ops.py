"""Public wrappers for the port's kernels, with the launch plans and CTA
tiles chosen by the shared-memory advisors
(:func:`repro_torch.core.blocking.stencil_cta_tile`,
:func:`~repro_torch.core.blocking.attention_cta_tiles`) — the counterpart
of ``repro.kernels.ops``, whose VMEM working-set guards the advisors
replace.  A shape for which no legal tile exists raises ``ValueError``
before anything launches."""
from __future__ import annotations

import torch

from ..core import blocking
from . import flash_attention as _fa
from . import longrange3d as _lr
from . import stencil3d7pt as _s7


def plan(module, t: torch.Tensor) -> blocking.StencilPlan:
    """The advisor's launch plan for stencil ``module`` on grid ``t``."""
    if t.dim() != 3:
        raise ValueError(f"expected an (M, N, N) grid, got {tuple(t.shape)}")
    return blocking.stencil_cta_tile(module.RADIUS, tuple(t.shape),
                                     module.OWN)


def stencil3d7pt(a: torch.Tensor, coeffs) -> torch.Tensor:
    """The 7-point stencil of ``a``; coefficients in (W,E,N,S,F,B,s)."""
    return _s7.stencil3d7pt(a, coeffs, tile=plan(_s7, a))


def longrange3d(u: torch.Tensor, v: torch.Tensor, roc: torch.Tensor,
                coeffs) -> torch.Tensor:
    """The long-range stencil update of ``u``; coefficients c0..c4."""
    return _lr.longrange3d(u, v, roc, coeffs, tile=plan(_lr, u))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention with blocks from the shared-memory advisor, fitted to the
    lengths (a tensor-core pair wherever one divides them); kv heads
    broadcast by GQA callers.  The call is the operator
    :func:`~repro_torch.kernels.flash_attention.flash_op`
    (``repro_torch::flash_attention``); with grad mode on and an operand
    that requires grad, it goes through
    :class:`~repro_torch.kernels.flash_attention.FlashAttentionFn` (the
    same forward, on either device, and its backward).  ``scale`` is the
    softmax's (None: 1/sqrt(d))."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention takes (b, h, s, d) tensors")
    sq, d = int(q.shape[2]), int(q.shape[3])
    skv = int(k.shape[2])
    tiles = blocking.attention_cta_tiles(sq, skv, d, q.dtype)
    bq, bkv = _fa.fit_blocks(sq, skv, tiles.bq, tiles.bkv, d, q.dtype)
    q_offset = skv - sq if q_offset is None else int(q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _fa.FlashAttentionFn.apply(q, k, v, causal, bq, bkv, q_offset,
                                          scale)
    return _fa.flash_op(q, k, v, causal, bq, bkv, q_offset, scale)
