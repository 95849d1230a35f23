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

The registry holds the JAX package's four models: the three loop models
and ``hlo-roofline``, which prices an HLO program from the ``hlo``
frontend against a machine file's accelerator fields.
"""
from __future__ import annotations

import abc
from typing import Protocol, runtime_checkable

from . import ecm as _ecm
from . import hlo_analysis as _hlo
from . import roofline as _roofline
from .kernel_ir import LoopKernel
from .machine import Machine


@runtime_checkable
class Result(Protocol):
    """Minimal contract every model result satisfies."""

    def to_dict(self) -> dict: ...


class PerformanceModel(abc.ABC):
    """One analytic performance model over a kernel object.

    ``input_kind`` declares what the model consumes — ``"loop"`` for the
    affine :class:`LoopKernel` IR, ``"hlo"`` for the ``hlo`` frontend's
    :class:`~repro_torch.core.frontends.hlo.HLOProgram` — so the session
    and the unified ``analyze`` entry point can check frontend/model
    compatibility up front.

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


@register_model
class HLORooflineModel(PerformanceModel):
    """Kerncraft-for-XLA roofline over a compiled HLO module.

    Consumes the ``hlo`` frontend's :class:`~repro_torch.core.frontends.hlo
    .HLOProgram` (or the ``graph`` frontend's ``GraphProgram``, priced
    from its recorded analysis) instead of a loop kernel; machine constants
    come from the accelerator fields of the machine description (``peak
    flops``, ``hbm bandwidth``, ``ici link bandwidth``: the TPU fields of
    ``tpu_v5e.yaml``, which ``h100_sxm.yaml`` carries too).  A machine
    with none of those fields (an x86 cache machine like IVY) is rejected rather than silently
    costed with v5e numbers, as is a ``dtype`` the machine has no peak for.
    The words of the errors are the JAX package's.
    """

    name = "hlo-roofline"
    input_kind = "hlo"

    def analyze(self, program, machine: Machine,
                dtype: str = "BF16", **opts) -> _hlo.HLORooflineResult:
        if opts:
            raise TypeError(
                f"hlo-roofline got unknown options {sorted(opts)}")
        if not hasattr(program, "text") and \
                not hasattr(program, "analysis"):
            raise TypeError(
                "hlo-roofline consumes an HLOProgram (use the 'hlo' "
                f"frontend), got {type(program).__name__}")
        if not machine.peak_flops and not machine.hbm_bandwidth:
            raise ValueError(
                f"machine {machine.name!r} carries no TPU fields "
                "('peak flops', 'hbm bandwidth'); hlo-roofline needs a "
                "TPU machine description (e.g. V5E)")
        if machine.peak_flops:
            peak = machine.peak_flops.get(dtype.upper())
            if peak is None:
                raise ValueError(
                    f"machine {machine.name!r} has no peak flops for dtype "
                    f"{dtype!r}; available: {sorted(machine.peak_flops)}")
        else:                         # hbm given, peak table absent
            peak = _hlo.PEAK_FLOPS_BF16
        ana = program_analysis(program)
        vpu_peak = machine.peak_flops.get("FP32") or _hlo.PEAK_FLOPS_FP32
        return _hlo.roofline_result(
            ana, program=program.name, machine_name=machine.name,
            peak_flops=peak,
            hbm_bandwidth=machine.hbm_bandwidth or _hlo.HBM_BW,
            ici_bandwidth=machine.ici_link_bandwidth or _hlo.ICI_LINK_BW,
            vpu_peak_flops=vpu_peak)


def program_analysis(program, per_op: bool = False) -> _hlo.HLOAnalysis:
    """The analysis ``hlo-roofline`` prices: a
    :class:`~repro_torch.core.frontends.graph.GraphProgram` carries its
    own (per-op records included); an HLO program's text is walked."""
    if hasattr(program, "analysis"):
        return program.analysis
    return _hlo.analyze_hlo_text(
        program.text, default_group=program.default_group,
        assume_rs_rewrite=program.assume_rs_rewrite, per_op=per_op)


def resolve_model(name: str) -> PerformanceModel:
    try:
        return MODEL_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown performance model {name!r}; "
            f"available: {sorted(MODEL_REGISTRY)}") from None


def analyze(model: str, kernel, machine: Machine, **opts) -> Result:
    """Resolve ``model`` by registry name and run it over an already-built
    kernel object.  The frontend-aware, memoizing entry point is
    :func:`repro_torch.core.analyze` (see :mod:`repro_torch.core.api`)."""
    return resolve_model(model).analyze(kernel, machine, **opts)
