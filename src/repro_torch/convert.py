"""Carrying the JAX side's inputs across.

numpy arrays become tensors on a given device (the parity tests make
inputs once with numpy and hand them to both packages), stencil
coefficients map between ``ref.py``'s dict form and the kernels' vectors,
and LM parameter and cache trees (``jax.tree.map(np.asarray, tree)``)
become the port's (:func:`lm_params`, :func:`lm_caches`).
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
    """A tensor's values as numpy (bfloat16, which numpy lacks, as the
    float32 values it holds exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def array_tensor(a, device=None, dtype: torch.dtype | None = None
                 ) -> torch.Tensor:
    """One array of a JAX tree as a tensor on ``device``, in ``dtype`` or
    else its own type.  ``np.asarray`` of a JAX bfloat16 array is an
    ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` refuses: it
    goes through float32, which holds every bfloat16 value exactly."""
    arr = np.asarray(a)
    own = None
    if arr.dtype.name == "bfloat16":
        arr, own = arr.astype(np.float32), torch.bfloat16
    t = torch.from_numpy(np.array(arr, order="C"))   # a writable copy
    return t.to(device=_device.resolve(device), dtype=dtype or own or t.dtype)


def _tree(recs, tree, device, dtype, keep_types: bool):
    from .models.common import tmap

    def one(rec, arr):
        if tuple(np.shape(arr)) != tuple(rec.shape):
            raise ValueError(f"leaf of shape {np.shape(arr)} where the "
                             f"record says {rec.shape}")
        want = None if keep_types else (rec.dtype or dtype)
        return array_tensor(arr, device, want)
    return tmap(one, recs, tree)


def lm_params(tree, cfg, device=None, dtype: torch.dtype | None = None):
    """A parameter tree shaped like ``LM(cfg).param_recs()`` (numpy or
    JAX arrays) as the port's tensors on ``device``.  A leaf whose record
    names a type (the MoE router's float32) takes it; the others take
    ``dtype``, or keep their own type when it is None.  Raises on a leaf
    whose shape differs from its record's."""
    from .models.lm import LM
    return _tree(LM(cfg).param_recs(), tree, device, dtype, False)


def lm_caches(tree, cfg, batch: int, max_len: int, device=None):
    """A cache tree shaped like ``LM(cfg).cache_recs(batch, max_len)`` as
    the port's tensors on ``device``, each leaf in its own type (a JAX
    cache after a float32 prefill holds the Mamba conv window in float32
    where the record says bfloat16)."""
    from .models.lm import LM
    return _tree(LM(cfg).cache_recs(batch, max_len), tree, device, None,
                 True)


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
