"""The InCoreModel registry: one dispatch point for the paper's
replaceable in-core component (a copy of ``repro.core.incore.registry``).

Kerncraft delegates in-core prediction to IACA and aggregates its per-port
throughput into the machine file's overlapping/non-overlapping classes
(paper §2.5).  Every in-core model registers here and ECM and Roofline
resolve models by name through :func:`resolve_incore`.  The port registers
only ``"simple"``; the JAX package's ``"ports"`` scheduler is not ported.
"""
from __future__ import annotations

import abc

from ..kernel_ir import LoopKernel
from ..machine import Machine
from .result import InCoreResult


class InCoreModel(abc.ABC):
    """One in-core execution model: kernel + machine → :class:`InCoreResult`.

    In-core analysis reads only the kernel's *structure* (flops, access
    widths, inner step, dtype), never its bound constants.
    """

    name: str = "?"

    @abc.abstractmethod
    def analyze(self, kernel: LoopKernel, machine: Machine,
                **opts) -> InCoreResult:
        ...


INCORE_REGISTRY: dict[str, InCoreModel] = {}


def register_incore(cls: type[InCoreModel]) -> type[InCoreModel]:
    INCORE_REGISTRY[cls.name.lower()] = cls()
    return cls


def resolve_incore(name: str) -> InCoreModel:
    try:
        return INCORE_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown in-core model {name!r}; "
            f"available: {sorted(INCORE_REGISTRY)}") from None


def analyze(kernel: LoopKernel, machine: Machine, model: str = "simple",
            **opts) -> InCoreResult:
    """Run the named in-core model — the uniform ``incore=`` dispatch the
    performance models route through."""
    return resolve_incore(model).analyze(kernel, machine, **opts)
