"""Cache-predictor layer: one registry owning the paper's
``--cache-predictor`` switch (a copy of ``repro.core.predictors``).

Both performance models consume the same input — the traffic β_k between
adjacent memory levels — but the paper offers two ways to predict it:
layer conditions (``"LC"``: analytic, fast, associativity-blind) and the
cache simulator (``"SIM"``: slow, associativity-aware, the paper's
fallback where LC analysis is not easily possible).  This module is the
only place that dispatch lives; :mod:`repro_torch.core.ecm` and
:mod:`repro_torch.core.roofline` receive a finished
:class:`VolumePrediction` and never branch on the predictor name.
"""
from __future__ import annotations

import abc
import dataclasses

from . import layer_conditions
from .cachesim import normalize_sim_kwargs, simulate
from .kernel_ir import LoopKernel
from .machine import Machine


@dataclasses.dataclass(frozen=True)
class VolumePrediction:
    """Per-level traffic prediction: β_k in bytes per innermost iteration.

    ``bytes_per_it[level]`` is the traffic between ``level`` and the next
    farther one (load misses + write-backs), the common input of ECM and
    Roofline.  ``detail`` keeps the predictor-specific evidence (the
    per-level :class:`~repro_torch.core.layer_conditions.LCState` map for
    LC, the :class:`~repro_torch.core.cachesim.SimResult` for SIM) for
    reports.  ``params`` records the predictor options actually used — for
    SIM the resolved backend and warm-up/measure windows — so downstream
    results carry full provenance (see ``ECMResult.predictor_params``).
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
    """One prediction backend for per-level cache traffic.

    ``uses_sim_kwargs`` declares whether the backend consumes the
    simulation options the CLI calls ``sim_kwargs`` (warm-up/measure
    windows, seeds); analytic predictors leave it False and never see
    them.

    ``supports_compiled`` declares whether the prediction is analytic in
    the loop sizes and can be lowered by :mod:`repro_torch.core.compiled`
    into a batched sweep plan (true for LC, whose traffic is
    piecewise-constant in a single loop symbol; false for the simulator,
    whose output has no closed form).  The session's sweep auto-routing
    and ``blocking.grid_search`` check this instead of hard-coding
    predictor names.
    """

    name: str = "?"
    uses_sim_kwargs: bool = False
    supports_compiled: bool = False

    @abc.abstractmethod
    def predict(self, kernel: LoopKernel, machine: Machine, cores: int = 1,
                **kwargs) -> VolumePrediction:
        ...


PREDICTOR_REGISTRY: dict[str, CachePredictor] = {}


def register_predictor(cls: type[CachePredictor]) -> type[CachePredictor]:
    PREDICTOR_REGISTRY[cls.name.upper()] = cls()
    return cls


@register_predictor
class LayerConditionPredictor(CachePredictor):
    """Analytic LC prediction (paper §2.4.2) — smooth in the loop sizes."""

    name = "LC"
    supports_compiled = True

    def predict(self, kernel: LoopKernel, machine: Machine, cores: int = 1,
                **kwargs) -> VolumePrediction:
        states = layer_conditions.volumes_per_level(kernel, machine,
                                                    cores=cores)
        return VolumePrediction(
            predictor=self.name,
            bytes_per_it={k: st.total_bytes_per_it for k, st in states.items()},
            detail=states)


@register_predictor
class CacheSimulationPredictor(CachePredictor):
    """Set-associative simulation (paper §2.4.1) — sees real set indices.

    Extra keyword arguments (``warmup_rows``, ``measure_rows``, ``seed``,
    ``backend``) are forwarded to
    :func:`repro_torch.core.cachesim.simulate`; ``backend`` is the
    scalar/vector engine switch (the JAX CLI's ``--sim-backend``).  The
    returned prediction's ``params`` records the options actually used,
    with ``backend`` resolved (never ``auto``).  ``cores`` is dropped, as the
    JAX package drops it: one core simulates every shared level whole.
    """

    name = "SIM"
    uses_sim_kwargs = True

    def predict(self, kernel: LoopKernel, machine: Machine, cores: int = 1,
                **kwargs) -> VolumePrediction:
        params = normalize_sim_kwargs(kwargs, machine)
        res = simulate(kernel, machine, **params)
        return VolumePrediction(
            predictor=self.name,
            bytes_per_it={n: res.total_bytes_per_it(n)
                          for n in machine.level_names},
            detail=res,
            params=params)


def predictor_tag(predictor: str, params: dict) -> str:
    """Compact provenance tag for reports, e.g. ``LC`` or ``SIM:vector`` —
    the one definition behind ``ECMResult``/``RooflineResult``
    ``.predictor_tag``."""
    backend = params.get("backend")
    return predictor + (f":{backend}" if backend else "")


def resolve_predictor(name: str) -> CachePredictor:
    try:
        return PREDICTOR_REGISTRY[name.upper()]
    except KeyError:
        raise ValueError(
            f"unknown cache predictor {name!r}; "
            f"available: {sorted(PREDICTOR_REGISTRY)}") from None


def predict_volumes(kernel: LoopKernel, machine: Machine,
                    predictor: str = "LC", cores: int = 1,
                    sim_kwargs: dict | None = None) -> VolumePrediction:
    """The one entry point for β_k prediction (the paper's
    ``--cache-predictor`` switch).  ``sim_kwargs`` only reaches backends
    declaring ``uses_sim_kwargs`` (SIM), mirroring the CLI semantics where
    the analytic predictor has no simulation options.
    """
    pred = resolve_predictor(predictor)
    kwargs = dict(sim_kwargs or {}) if pred.uses_sim_kwargs else {}
    return pred.predict(kernel, machine, cores=cores, **kwargs)
