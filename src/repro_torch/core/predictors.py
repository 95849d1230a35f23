"""Cache-predictor layer: one registry owning the paper's
``--cache-predictor`` switch (a copy of ``repro.core.predictors``).

Both performance models consume the same input — the traffic β_k between
adjacent memory levels.  The paper offers two ways to predict it: layer
conditions (analytic) and the cache simulator.  The port carries LC only;
``predictor="SIM"`` raises until the simulator is ported (ROADMAP.md,
"left out of the first port slice").  :mod:`repro_torch.core.ecm` and
:mod:`repro_torch.core.roofline` receive a finished
:class:`VolumePrediction` and never branch on the predictor name.
"""
from __future__ import annotations

import abc
import dataclasses

from . import layer_conditions
from .kernel_ir import LoopKernel
from .machine import Machine


@dataclasses.dataclass(frozen=True)
class VolumePrediction:
    """Per-level traffic prediction: β_k in bytes per innermost iteration.

    ``bytes_per_it[level]`` is the traffic between ``level`` and the next
    farther one (load misses + write-backs), the common input of ECM and
    Roofline.  ``detail`` keeps the predictor-specific evidence (the
    per-level :class:`~repro_torch.core.layer_conditions.LCState` map for
    LC) for reports.  ``params`` records the predictor options actually
    used (none for LC), so results carry full provenance (see
    ``ECMResult.predictor_params``).
    """
    predictor: str
    bytes_per_it: dict[str, float]
    detail: object = None
    params: dict = dataclasses.field(default_factory=dict)

    def volume(self, level: str) -> float:
        return self.bytes_per_it.get(level, 0.0)

    def to_dict(self) -> dict:
        return {"predictor": self.predictor,
                "bytes_per_it": dict(self.bytes_per_it),
                "params": dict(self.params)}


class CachePredictor(abc.ABC):
    """One prediction backend for per-level cache traffic."""

    name: str = "?"

    @abc.abstractmethod
    def predict(self, kernel: LoopKernel, machine: Machine,
                cores: int = 1) -> VolumePrediction:
        ...


PREDICTOR_REGISTRY: dict[str, CachePredictor] = {}


def register_predictor(cls: type[CachePredictor]) -> type[CachePredictor]:
    PREDICTOR_REGISTRY[cls.name.upper()] = cls()
    return cls


@register_predictor
class LayerConditionPredictor(CachePredictor):
    """Analytic LC prediction (paper §2.4.2) — smooth in the loop sizes."""

    name = "LC"

    def predict(self, kernel: LoopKernel, machine: Machine,
                cores: int = 1) -> VolumePrediction:
        states = layer_conditions.volumes_per_level(kernel, machine,
                                                    cores=cores)
        return VolumePrediction(
            predictor=self.name,
            bytes_per_it={k: st.total_bytes_per_it for k, st in states.items()},
            detail=states)


def predictor_tag(predictor: str, params: dict) -> str:
    """Compact provenance tag for reports, e.g. ``LC`` — the one
    definition behind ``ECMResult``/``RooflineResult`` ``.predictor_tag``."""
    backend = params.get("backend")
    return predictor + (f":{backend}" if backend else "")


def resolve_predictor(name: str) -> CachePredictor:
    if name.upper() == "SIM":
        raise ValueError(
            "cache predictor 'SIM' (the cache simulator) is not ported to "
            "repro_torch yet; see ROADMAP.md Queue 1, 'left out of the "
            "first port slice'.  Use predictor='LC'.")
    try:
        return PREDICTOR_REGISTRY[name.upper()]
    except KeyError:
        raise ValueError(
            f"unknown cache predictor {name!r}; "
            f"available: {sorted(PREDICTOR_REGISTRY)}") from None


def predict_volumes(kernel: LoopKernel, machine: Machine,
                    predictor: str = "LC",
                    cores: int = 1) -> VolumePrediction:
    """The one entry point for β_k prediction (the paper's
    ``--cache-predictor`` switch)."""
    return resolve_predictor(predictor).predict(kernel, machine, cores=cores)
