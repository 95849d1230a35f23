"""The paper's Listing-3 3D long-range (radius-4, 25-point) star stencil —
the §3 case study: its traced point function, its hand-written Hopper
kernel (``csrc/longrange3d.cu``) and, beside it, its plain PyTorch version.

Counterpart of ``repro.kernels.longrange3d``.  ``point`` carries the same
spec and body as the JAX module's, so both trace to the same
``kernel_key``.  :func:`longrange3d` launches the CUDA kernel for tensors
on the card and raises if it cannot; for tensors on the CPU it runs
:func:`plain`.  ``longrange3d.launches`` counts the launches.
"""
from __future__ import annotations

import torch

from .. import convert
from ..core import blocking
from ..core.trace import kernel_spec
from . import _build, ref

RADIUS = 4
#: bare tiles each ring stage carries besides v's haloed one: u and roc
OWN = 2
# the kernel's (as the Pallas kernel's): each c_d multiplies the sum of its
# six neighbours once, where the traced Listing-3 body multiplies it thrice
FLOPS_PER_POINT = 33


@kernel_spec(name="3d-long-range",
             arrays={"U": ("M", "N", "N"), "V": ("M", "N", "N"),
                     "ROC": ("M", "N", "N")},
             loops=[("k", 4, "M-4"), ("j", 4, "N-4"), ("i", 4, "N-4")],
             element_bytes=8)
def point(U, V, ROC, c, k, j, i):
    """One innermost iteration of the long-range stencil: 25 reads of
    ``V`` plus ``U``/``ROC`` at the center, one write of ``U``, 15 muls +
    26 adds.  The ``range`` loop unrolls at trace time, mirroring the C
    body's textual sum."""
    lap = c[0] * V[k, j, i]
    for d in range(1, RADIUS + 1):
        lap = (lap + c[d] * (V[k, j, i + d] + V[k, j, i - d])
                   + c[d] * (V[k, j + d, i] + V[k, j - d, i])
                   + c[d] * (V[k + d, j, i] + V[k - d, j, i]))
    U[k, j, i] = 2.0 * V[k, j, i] - U[k, j, i] + ROC[k, j, i] * lap


def plain(u: torch.Tensor, v: torch.Tensor, roc: torch.Tensor,
          coeffs) -> torch.Tensor:
    """The plain PyTorch version: ``ref.longrange3d``."""
    return ref.longrange3d(u, v, roc, convert.longrange_vector(coeffs))


def longrange3d(u: torch.Tensor, v: torch.Tensor, roc: torch.Tensor, coeffs,
                *, tile) -> torch.Tensor:
    """U' = 2V - U + ROC * lap(V) in the interior; the width-4 boundary
    copies ``u``.

    ``u``, ``v``, ``roc``: float32 ``(M, N, N)``, contiguous, one device.
    ``coeffs``: 5 host numbers ``c0..c4``, passed to the kernel by value.
    ``tile``: the launch plan ``(bj, bi, c, stages, chunk)`` — the
    CTA's in-plane tile, points per thread, ring stages and output planes
    per CTA — or the
    :class:`~repro_torch.core.blocking.StencilPlan` that
    :func:`repro_torch.core.blocking.stencil_cta_tile` returns; a plan the
    kernel cannot take raises ``ValueError`` on every device.  On the card the
    kernel runs on the current stream without synchronising."""
    M, N = _build.check_grid(u, v, roc)
    cvec = convert.longrange_vector(coeffs)
    plan = _build.check_tile(blocking.check_launch(tile, RADIUS, OWN),
                             (M, N))
    if u.device.type == "cpu":
        return plain(u, v, roc, cvec)
    fn = _build.bind("longrange3d", n_ptrs=4, n_coef=5)
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check_status("longrange3d", fn(
            u.data_ptr(), v.data_ptr(), roc.data_ptr(), out.data_ptr(),
            M, N, *plan, *cvec, stream))
    longrange3d.launches += 1
    return out


longrange3d.launches = 0
