"""Carrying the JAX side's inputs across.

numpy arrays become tensors on a given device (the parity tests make
inputs once with numpy and hand them to both packages), and stencil
coefficients map between ``ref.py``'s dict form and the kernels' vectors.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from . import device as _device

#: Order of the 7-point coefficient vector, as the Pallas kernel reads it:
#: W/E are i-1/i+1, N/S are j-1/j+1, F/B are k-1/k+1, s the centre.
STAR7_ORDER = ("W", "E", "N", "S", "F", "B", "s")
#: Number of long-range coefficients c0..c4 (centre, distances 1..4).
LONGRANGE_NCOEF = 5


def to_tensor(x, device=None, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy (or anything ``np.asarray`` takes) -> contiguous tensor on
    ``device`` (resolved by :func:`repro_torch.device.resolve`), cast to
    ``dtype``.  This is how attention's q, k and v cross from the tests'
    numpy: made in float32 and cast here, bfloat16 rounds to nearest even
    as ``jnp.asarray(x, jnp.bfloat16)`` does, so both packages get
    bit-identical inputs."""
    arr = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(arr).to(device=_device.resolve(device),
                                    dtype=dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def star7_vector(coeffs: Mapping[str, float] | Sequence[float]) -> tuple[float, ...]:
    """7-point coefficients as a ``(W, E, N, S, F, B, s)`` tuple of floats,
    from ``ref.py``'s dict or from a vector already in that order."""
    if isinstance(coeffs, Mapping):
        missing = [c for c in STAR7_ORDER if c not in coeffs]
        if missing:
            raise ValueError(f"7-point coefficients miss {missing}")
        return tuple(float(coeffs[c]) for c in STAR7_ORDER)
    return _host_floats(coeffs, len(STAR7_ORDER), "7-point")


def star7_dict(coeffs) -> dict[str, float]:
    """The inverse of :func:`star7_vector`: ``ref.py``'s dict form."""
    return dict(zip(STAR7_ORDER, star7_vector(coeffs)))


def longrange_vector(coeffs) -> tuple[float, ...]:
    """Long-range coefficients ``c0..c4`` as a tuple of floats."""
    return _host_floats(coeffs, LONGRANGE_NCOEF, "long-range")


def _host_floats(coeffs, n: int, what: str) -> tuple[float, ...]:
    if isinstance(coeffs, torch.Tensor) and coeffs.device.type != "cpu":
        # reading a device tensor on the host would synchronize every call
        raise TypeError(
            f"{what} coefficients must be host numbers (they travel to the "
            f"kernel by value), got a tensor on {coeffs.device}")
    vals = np.asarray(coeffs, dtype=np.float64).reshape(-1)
    if vals.size != n:
        raise ValueError(f"{what} stencil takes {n} coefficients, "
                         f"got {vals.size}")
    return tuple(float(v) for v in vals)
