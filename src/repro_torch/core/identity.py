"""Structural identity keys for kernels and their containers.

A copy of ``repro.core.identity`` (the port keeps its own).  The
:mod:`~repro_torch.core.layer_conditions` caches and
:attr:`Machine.fingerprint <repro_torch.core.machine.Machine.fingerprint>`
need one notion of identity: two kernels with the same loops, accesses,
and bound constants share cache entries no matter how they were
constructed, and the parity tests compare :func:`kernel_key` across the
two packages.

Stringifying sympy expressions dominates key construction, and
``kernel.bind()`` shallow-copies — bound variants share the same loops /
accesses containers — so those sub-keys are cached by container identity.
Entries hold a reference to the container, which both validates the id
and prevents it from being garbage-collected and reused.  The cache is
bounded: long-running services parse fresh kernels per request, so past
the cap the oldest (insertion-order) entries are evicted — a re-derived
key is just a slower cache hit, never a correctness issue.
"""
from __future__ import annotations

import hashlib

from .kernel_ir import LoopKernel

_STRUCT_KEYS: dict[int, tuple] = {}
_STRUCT_KEYS_MAX = 4096


def structure_key(container, build) -> tuple:
    """Identity-cached structural key of a shared (frozen-by-convention)
    container: ``build(container)`` computed once per container object."""
    ent = _STRUCT_KEYS.get(id(container))
    if ent is not None and ent[0] is container:
        return ent[1]
    key = build(container)
    while len(_STRUCT_KEYS) >= _STRUCT_KEYS_MAX:
        _STRUCT_KEYS.pop(next(iter(_STRUCT_KEYS)))
    _STRUCT_KEYS[id(container)] = (container, key)
    return key


def loops_key(loops) -> tuple:
    return tuple((str(lp.var), str(lp.start), str(lp.stop), lp.step)
                 for lp in loops)


def accesses_key(accesses) -> tuple:
    return tuple((a.array.name, tuple(str(d) for d in a.array.dims),
                  a.array.element_bytes, tuple(str(i) for i in a.index),
                  a.is_write)
                 for a in accesses)


def arrays_key(arrays) -> tuple:
    # insertion order matters: the cache simulator lays arrays out
    # back-to-back in dict order, so base addresses (and set conflicts)
    # depend on it — and unaccessed arrays still shift later bases.
    return tuple((name, tuple(str(d) for d in arr.dims), arr.element_bytes)
                 for name, arr in arrays.items())


def kernel_key(kernel: LoopKernel) -> tuple:
    """Structural identity of a kernel: loops, accesses, bound constants.

    Everything the analyses read is captured; mutable containers are frozen
    so the key is hashable.  Two kernels with identical structure share a
    key no matter how they were constructed.
    """
    return (
        kernel.name,
        kernel.dtype_bytes,
        tuple(sorted(kernel.constants.items())),
        structure_key(kernel.loops, loops_key),
        structure_key(kernel.accesses, accesses_key),
        structure_key(kernel.arrays, arrays_key),
        (kernel.flops.add, kernel.flops.mul, kernel.flops.div,
         kernel.flops.fma),
    )


def _canonical(v):
    """Hashable, *cross-process* stable form of a payload: dict keys are
    stringified before sorting (YAML payloads mix int and str keys, which
    Python 3 refuses to order) and anything that is not a JSON-ish scalar
    is reduced to its repr."""
    if isinstance(v, dict):
        return tuple(sorted((str(k), _canonical(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple, set)):
        return tuple(_canonical(x) for x in v)
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def stable_digest(v, length: int = 16) -> str:
    """Deterministic content hash of any nested key/payload structure.

    Unlike ``hash()`` (salted per process), the digest is stable across
    processes and machine restarts; :attr:`Machine.fingerprint
    <repro_torch.core.machine.Machine.fingerprint>` is built on it.
    """
    blob = repr(_canonical(v)).encode()
    return hashlib.sha256(blob).hexdigest()[:length]
