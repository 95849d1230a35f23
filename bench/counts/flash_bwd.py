"""Causal attention's backward: 8·d operations per visible (query, key)
pair and query head, the four products the gradient needs (dV = Pᵀ·dO,
dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀ·Q).  Re-forming S is the
implementation's choice and is not counted, so the yardstick reads the
same work whatever computes it.  Moved once: q, k, v and dO read, dq, dk
and dv written."""

from . import flash_fwd


def cost(batch: int, heads: int, sq: int, skv: int, head_dim: int,
         elem_bytes: int = 2) -> tuple[float, float]:
    ops = 8.0 * head_dim * flash_fwd.pairs(sq, skv) * batch * heads
    moved = elem_bytes * batch * heads * head_dim * (4 * sq + 3 * skv)
    return ops, float(moved)
