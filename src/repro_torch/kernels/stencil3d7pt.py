"""The paper's Listing-1 3D 7-point star stencil: its traced point function,
its hand-written Hopper kernel (``csrc/stencil3d7pt.cu``) and, beside it,
its plain PyTorch version.

Counterpart of ``repro.kernels.stencil3d7pt``.  ``point`` carries the same
spec and body as the JAX module's, so both trace to the same
``kernel_key``.  :func:`stencil3d7pt` launches the CUDA kernel for a
tensor on the card and raises if it cannot; for a tensor on the CPU it
runs :func:`plain`.  ``stencil3d7pt.launches`` counts the launches.
"""
from __future__ import annotations

import torch

from .. import convert
from ..core import blocking
from ..core.trace import kernel_spec
from . import _build, ref

RADIUS = 1
#: bare tiles each ring stage carries besides the haloed one
OWN = 0
FLOPS_PER_POINT = 13    # the kernel's: 7 multiplies, 6 adds


@kernel_spec(name="3d-7pt",
             arrays={"a": ("M", "N", "N"), "b": ("M", "N", "N")},
             loops=[("k", 1, "M-1"), ("j", 1, "N-1"), ("i", 1, "N-1")],
             element_bytes=8)
def point(a, b, w, k, j, i):
    """One innermost iteration of the stencil — the analyzable face of the
    CUDA kernel below: 7 affine reads of ``a``, one write of ``b``, 7 muls
    + 6 adds.  ``element_bytes=8`` matches the paper's C double; trace
    with ``element_bytes=4`` for the float32 the kernel runs."""
    b[k, j, i] = (w.wC * a[k, j, i]
                  + w.wW * a[k, j, i - 1] + w.wE * a[k, j, i + 1]
                  + w.wS * a[k, j - 1, i] + w.wN * a[k, j + 1, i]
                  + w.wB * a[k - 1, j, i] + w.wF * a[k + 1, j, i])


def plain(a: torch.Tensor, coeffs) -> torch.Tensor:
    """The plain PyTorch version: ``ref.stencil3d7pt`` with coefficients
    in the kernel's ``(W, E, N, S, F, B, s)`` vector order."""
    return ref.stencil3d7pt(a, convert.star7_dict(coeffs))


def stencil3d7pt(a: torch.Tensor, coeffs, *, tile) -> torch.Tensor:
    """b = 7-point stencil of ``a`` (boundary copies ``a``).

    ``a``: float32 ``(M, N, N)``, contiguous.  ``coeffs``: 7 host numbers
    in ``(W, E, N, S, F, B, s)`` order, passed to the kernel by value.
    ``tile``: the launch plan ``(bj, bi, c, stages, chunk)`` — the
    CTA's in-plane tile, points per thread, ring stages and output planes
    per CTA — or the
    :class:`~repro_torch.core.blocking.StencilPlan` that
    :func:`repro_torch.core.blocking.stencil_cta_tile` returns; a plan the
    kernel cannot take raises ``ValueError`` on every device.  On the card the
    kernel runs on the current stream without synchronising."""
    M, N = _build.check_grid(a)
    cvec = convert.star7_vector(coeffs)
    plan = _build.check_tile(blocking.check_launch(tile, RADIUS, OWN),
                             (M, N))
    if a.device.type == "cpu":
        return plain(a, cvec)
    fn = _build.bind("stencil3d7pt", n_ptrs=2, n_coef=7)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check_status("stencil3d7pt", fn(
            a.data_ptr(), out.data_ptr(), M, N, *plan, *cvec, stream))
    stencil3d7pt.launches += 1
    return out


stencil3d7pt.launches = 0
