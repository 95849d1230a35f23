"""Public wrappers for the port's stencil kernels, with the CTA tile chosen
by the shared-memory advisor (:func:`repro_torch.core.blocking
.stencil_cta_tile`) — the counterpart of ``repro.kernels.ops``, whose VMEM
working-set guards the advisor replaces.  A grid for which no legal tile
exists raises ``ValueError`` before anything launches."""
from __future__ import annotations

import torch

from ..core import blocking
from . import longrange3d as _lr
from . import stencil3d7pt as _s7


def _tile(radius: int, t: torch.Tensor) -> tuple[int, int]:
    if t.dim() != 3:
        raise ValueError(f"expected an (M, N, N) grid, got {tuple(t.shape)}")
    tile = blocking.stencil_cta_tile(radius, tuple(t.shape))
    return tile.bj, tile.bi


def stencil3d7pt(a: torch.Tensor, coeffs) -> torch.Tensor:
    """The 7-point stencil of ``a``; coefficients in (W,E,N,S,F,B,s)."""
    return _s7.stencil3d7pt(a, coeffs, tile=_tile(_s7.RADIUS, a))


def longrange3d(u: torch.Tensor, v: torch.Tensor, roc: torch.Tensor,
                coeffs) -> torch.Tensor:
    """The long-range stencil update of ``u``; coefficients c0..c4."""
    return _lr.longrange3d(u, v, roc, coeffs, tile=_tile(_lr.RADIUS, u))
