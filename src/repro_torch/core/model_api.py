"""Unified performance-model API (a copy of ``repro.core.model_api``).

The paper's CLI exposes a family of interchangeable models (``-p ECM``,
``-p Roofline``, ``-p RooflineIACA``) over interchangeable cache predictors
(``--cache-predictor LC|SIM``).  This module gives that family one abstract
interface so reports, sweeps, and the autotuner can iterate over models by
name:

    result = model_api.analyze("ecm", kernel, machine, predictor="LC")
    result.to_dict()                       # machine-readable, JSON-safe

Every concrete model registers itself in :data:`MODEL_REGISTRY`; the
memoizing :class:`~repro_torch.core.session.AnalysisSession` and
:func:`repro_torch.core.analyze` resolve names through
:func:`resolve_model` and feed models precomputed predictor volumes and
in-core results so nothing is recomputed across a sweep.

The port registers the three loop models.  ``hlo-roofline`` prices XLA
HLO text and waits for a graph frontend of the port (ROADMAP.md Queue 1,
item 6); :func:`resolve_model` names that item.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Protocol, runtime_checkable

from . import ecm as _ecm
from . import roofline as _roofline
from .kernel_ir import LoopKernel
from .machine import Machine

@dataclasses.dataclass(frozen=True)
class NotPorted:
    """A model of the JAX package's registry that the port does not carry
    yet: its name and the kernel kind it consumes (all that lint's cross
    rules X301/X302 read, so a request for it draws the JAX package's
    findings), and why it is missing."""
    name: str
    input_kind: str
    why: str


#: registry names of the JAX package that the port does not carry yet
NOT_PORTED = {
    "hlo-roofline": NotPorted(
        "hlo-roofline", "hlo",
        "the HLO roofline prices XLA HLO text; it waits for the port's "
        "graph frontend (ROADMAP.md Queue 1, item 6)"),
}


@runtime_checkable
class Result(Protocol):
    """Minimal contract every model result satisfies."""

    def to_dict(self) -> dict: ...


class PerformanceModel(abc.ABC):
    """One analytic performance model over a kernel object.

    ``input_kind`` declares what the model consumes — ``"loop"`` for the
    affine :class:`LoopKernel` IR every frontend of the port produces — so
    the session and the unified ``analyze`` entry point can check
    frontend/model compatibility up front.

    For loop models, ``analyze`` accepts the uniform option set
    (``predictor``, ``cores``, ``sim_kwargs``) plus the shared-work
    shortcuts ``volumes`` and ``incore_result``; concrete models forward
    them to their module-level ``model()`` functions, which remain usable
    directly.

    ``cores_invariant_result`` declares that two calls differing only in
    ``cores`` but with identical predicted traffic return identical
    results — true for ECM, whose result only *derives* multicore scaling
    (``performance_flops(cores)``/``saturation_cores`` are methods of the
    core count), false for Roofline, which bakes the per-cores measured
    bandwidth into the result.  The compiled N-D sweep uses it to
    broadcast one regime representative across the whole cores axis.
    """

    name: str = "?"
    input_kind: str = "loop"
    cores_invariant_result: bool = False

    @abc.abstractmethod
    def analyze(self, kernel, machine: Machine, **opts) -> Result:
        ...


MODEL_REGISTRY: dict[str, PerformanceModel] = {}


def register_model(cls: type[PerformanceModel]) -> type[PerformanceModel]:
    MODEL_REGISTRY[cls.name.lower()] = cls()
    return cls


@register_model
class ECMModel(PerformanceModel):
    """Execution-Cache-Memory model (paper §1.2.2, §3.2)."""

    name = "ecm"
    cores_invariant_result = True

    def analyze(self, kernel: LoopKernel, machine: Machine,
                **opts) -> _ecm.ECMResult:
        return _ecm.model(kernel, machine, **opts)


@register_model
class RooflineModel(PerformanceModel):
    """Classic Roofline: P_max from the flops/cy table (paper §1.2.1)."""

    name = "roofline"
    variant = "classic"

    def analyze(self, kernel: LoopKernel, machine: Machine,
                **opts) -> _roofline.RooflineResult:
        if "variant" in opts:
            raise ValueError(
                "the roofline variant is selected by registry name "
                "('roofline' = classic, 'roofline-iaca' = port model), "
                "not by a variant= option")
        return _roofline.model(kernel, machine, variant=self.variant, **opts)


@register_model
class RooflineIACAModel(RooflineModel):
    """Roofline with the in-core port model as the compute bound (§2.5)."""

    name = "roofline-iaca"
    variant = "IACA"


def resolve_model(name: str) -> PerformanceModel:
    try:
        return MODEL_REGISTRY[name.lower()]
    except KeyError:
        why = (f" (not ported to repro_torch yet: "
               f"{NOT_PORTED[name.lower()].why})"
               if name.lower() in NOT_PORTED else "")
        raise ValueError(
            f"unknown performance model {name!r}{why}; "
            f"available: {sorted(MODEL_REGISTRY)}") from None


def analyze(model: str, kernel, machine: Machine, **opts) -> Result:
    """Resolve ``model`` by registry name and run it over an already-built
    kernel object.  The frontend-aware, memoizing entry point is
    :func:`repro_torch.core.analyze` (see :mod:`repro_torch.core.api`)."""
    return resolve_model(model).analyze(kernel, machine, **opts)
