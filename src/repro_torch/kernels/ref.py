"""Plain PyTorch versions of the reference oracles (the counterparts of
``repro.kernels.ref.stencil3d7pt``, ``.longrange3d`` and ``.attention``).

They keep the JAX oracles' slicing, term order and masking, return a new
tensor, and run on whatever device their inputs live on.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import NEG_INF


# ----------------------------------------------------------------------
# paper Listing 1: 3D 7-point star stencil (radius 1, per-direction coeffs)
# ----------------------------------------------------------------------
def stencil3d7pt(a: torch.Tensor, coeffs) -> torch.Tensor:
    """a: (M, N, N). coeffs: dict(W, E, N, S, F, B, s). Boundary (width 1)
    copies ``a`` (the paper's loops run 1..N-2)."""
    c = coeffs
    interior = (
        c["W"] * a[1:-1, 1:-1, :-2] + c["E"] * a[1:-1, 1:-1, 2:]
        + c["N"] * a[1:-1, :-2, 1:-1] + c["S"] * a[1:-1, 2:, 1:-1]
        + c["F"] * a[:-2, 1:-1, 1:-1] + c["B"] * a[2:, 1:-1, 1:-1]
        + c["s"] * a[1:-1, 1:-1, 1:-1])
    out = a.clone()
    out[1:-1, 1:-1, 1:-1] = interior.to(a.dtype)
    return out


# ----------------------------------------------------------------------
# paper Listing 3: 3D long-range star stencil (radius 4, symmetric coeffs)
# ----------------------------------------------------------------------
def longrange3d(u: torch.Tensor, v: torch.Tensor, roc: torch.Tensor,
                c) -> torch.Tensor:
    """u, v, roc: (M, N, N); c: 5 coefficients c0..c4. Returns the updated
    U. Boundary width 4 copies u.

    A grid with any extent <= 8 is all boundary and returns a copy of u
    (the JAX oracle's negative slice stops wrap for extents 5..7 and
    raise there instead)."""
    r = 4
    M, J, I = v.shape
    if min(M, J, I) <= 2 * r:
        return u.clone()
    vi = v[r:-r, r:-r, r:-r]
    lap = c[0] * vi
    for d in range(1, r + 1):
        lap = lap + c[d] * (
            v[r:-r, r:-r, r + d:I - r + d] + v[r:-r, r:-r, r - d:I - r - d]
            + v[r:-r, r + d:J - r + d, r:-r] + v[r:-r, r - d:J - r - d, r:-r]
            + v[r + d:M - r + d, r:-r, r:-r] + v[r - d:M - r - d, r:-r, r:-r])
    upd = 2.0 * vi - u[r:-r, r:-r, r:-r] + roc[r:-r, r:-r, r:-r] * lap
    out = u.clone()
    out[r:-r, r:-r, r:-r] = upd.to(u.dtype)
    return out


# ----------------------------------------------------------------------
# flash attention (causal / full), grouped heads handled by the caller
# ----------------------------------------------------------------------
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """q: (b, h, sq, d), k/v: (b, h, skv, d) -> (b, h, sq, d); fp32 inside,
    the output in q's dtype.  The causal mask aligns the last query with
    the last key (query i sees keys up to ``i + skv - sq``)."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        mask = rows >= torch.arange(skv, device=q.device)[None]
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
