"""Roofline model (paper §1.2.1, §2.3) in both variants.

A copy of ``repro.core.roofline`` (result type and model; the compiled
``terms_arrays`` waits for compiled sweeps).

``Roofline``      — counts high-level flops against the machine's FLOPs/cy
                    table and models L1<->register traffic with the measured
                    L1 streaming bandwidth.
``RooflineIACA``  — replaces the in-core bound with the port model
                    (:mod:`repro_torch.core.incore`), the preferred variant.

For every memory level: ``T_k = β_k / B_k`` with β_k from the cache
predictor (LC or SIM) and B_k the measured streaming bandwidth of the
benchmark kernel whose read/write stream mix best matches the analyzed
kernel. The bottleneck is ``max_k(T_core, T_k)`` — equivalently the level
with the smallest ``AI_k · B_k``.
"""
from __future__ import annotations

import dataclasses
import math

from . import incore as _incore
from .incore import InCoreResult
from .kernel_ir import LoopKernel
from .machine import Machine
from .predictors import VolumePrediction, predict_volumes, predictor_tag


@dataclasses.dataclass(frozen=True)
class RooflineLevel:
    level: str
    arithmetic_intensity: float   # flop / byte out of this level
    bandwidth: float              # bytes/s (measured, stream-matched)
    bench_kernel: str
    performance: float            # flop/s bound by this level
    time_cy_per_unit: float       # cy per unit of work (8 it)


@dataclasses.dataclass(frozen=True)
class RooflineResult:
    unit_iterations: int
    t_core: float                 # cy per unit
    core_performance: float       # flop/s
    levels: list[RooflineLevel]
    flops_per_unit: float
    clock_hz: float
    variant: str = "IACA"         # which in-core bound produced t_core
    # provenance (mirrors ECMResult): predictor that produced β_k + its
    # resolved options, so serialized reports are self-describing
    predictor: str = "LC"
    predictor_params: dict = dataclasses.field(default_factory=dict)
    # in-core provenance: the registered InCoreModel behind t_core (IACA
    # variant only; the classic variant's P_max uses the flops/cy table
    # and leaves these empty) plus its full scheduler breakdown
    incore_model: str = ""
    incore: dict = dataclasses.field(default_factory=dict)
    # True when the machine's tuned calibration factors were applied to
    # the in-core and per-level bandwidth terms (autotuner feedback loop)
    calibrated: bool = False

    @property
    def predictor_tag(self) -> str:
        """Compact provenance tag, e.g. ``LC`` or ``SIM:vector``."""
        return predictor_tag(self.predictor, self.predictor_params)

    @property
    def bottleneck(self) -> str:
        perf, lvl = self.core_performance, "CPU"
        for l in self.levels:
            if l.performance < perf:
                perf, lvl = l.performance, l.level
        return lvl

    @property
    def performance(self) -> float:
        return min([self.core_performance] + [l.performance for l in self.levels])

    @property
    def time_cy(self) -> float:
        return max([self.t_core] + [l.time_cy_per_unit for l in self.levels])

    # --- machine-readable output -------------------------------------
    def to_dict(self) -> dict:
        """JSON-serializable form; primary fields plus derived summaries.
        ``model`` carries the registry name so re-dispatching from the
        serialized record reproduces the same in-core bound.  The
        ``calibrated`` key is emitted only when True so uncalibrated
        payloads stay byte-identical to pre-calibration goldens."""
        out = {
            "model": ("roofline-iaca" if self.variant.upper() == "IACA"
                      else "roofline"),
            "unit_iterations": self.unit_iterations,
            "t_core": self.t_core,
            "core_performance": self.core_performance,
            "levels": [dataclasses.asdict(l) for l in self.levels],
            "flops_per_unit": self.flops_per_unit,
            "clock_hz": self.clock_hz,
            "predictor": self.predictor,
            "predictor_params": dict(self.predictor_params),
            "incore_model": self.incore_model,
            "incore": dict(self.incore),
            # derived, for consumers that only read the dict:
            "bottleneck": self.bottleneck,
            "performance": self.performance,
        }
        if self.calibrated:
            out["calibrated"] = True
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "RooflineResult":
        return cls(unit_iterations=int(d["unit_iterations"]),
                   t_core=float(d["t_core"]),
                   core_performance=float(d["core_performance"]),
                   levels=[RooflineLevel(**l) for l in d["levels"]],
                   flops_per_unit=float(d["flops_per_unit"]),
                   clock_hz=float(d["clock_hz"]),
                   variant=("IACA" if d.get("model") == "roofline-iaca"
                            else "classic"),
                   predictor=str(d.get("predictor", "LC")),
                   predictor_params=dict(d.get("predictor_params", {})),
                   incore_model=str(d.get("incore_model", "")),
                   incore=dict(d.get("incore", {})),
                   calibrated=bool(d.get("calibrated", False)))


def model(kernel: LoopKernel, machine: Machine, predictor: str = "LC",
          variant: str = "IACA", cores: int = 1,
          volumes: VolumePrediction | None = None,
          incore_result: InCoreResult | None = None,
          incore: str = "simple",
          calibrated: bool = False) -> RooflineResult:
    """Roofline model; ``predictor`` names a registered cache predictor
    and ``incore`` a registered in-core model (IACA variant only; the
    classic variant's compute bound is the flops/cy table's P_max).

    Like :func:`repro_torch.core.ecm.model`, precomputed ``volumes`` /
    ``incore_result`` skip the corresponding analyses.  ``calibrated=True``
    applies the machine's tuned ``calibration`` factors (see
    :func:`repro_torch.core.ecm.model`): the
    ``compute`` factor slows the in-core bound, each ``levels`` factor
    derates that level's effective bandwidth.  Off by default so every
    uncalibrated golden stays bit-identical.
    """
    unit = kernel.iterations_per_cacheline(machine.cacheline_bytes)
    flops_unit = kernel.flops.total * unit
    apply_cal = bool(calibrated and machine.calibration)
    f_c = machine.calibration_factor("compute") if apply_cal else 1.0

    # ---- in-core bound -------------------------------------------------
    ic = None
    if variant.upper() == "IACA":
        ic = incore_result or _incore.analyze(kernel, machine, model=incore)
        t_core = ic.t_core * f_c
        core_perf = (flops_unit / t_core * machine.clock_hz
                     if t_core > 0 else math.inf)
    else:
        pmax = _incore.applicable_peak(kernel, machine) / f_c   # flop/cy
        core_perf = pmax * machine.clock_hz * cores
        t_core = flops_unit / pmax if pmax else 0.0

    # ---- per-level transfer bounds --------------------------------------
    if volumes is None:
        volumes = predict_volumes(kernel, machine, predictor, cores=cores)

    r, w, rw = kernel.stream_counts()
    levels: list[RooflineLevel] = []
    names = machine.level_names
    flops_it = kernel.flops.total
    for i, lv in enumerate(machine.levels):
        vol_it = volumes.volume(lv.name)
        # traffic out of level i feeds the roofline entry of the *next* level
        label = names[i + 1] if i + 1 < len(names) else "MEM"
        try:
            bw, bench = machine.measured_bandwidth(label, cores, r, w, rw)
        except (ValueError, KeyError):
            bw, bench = machine.main_memory_bandwidth, "copy"
        if apply_cal:
            # a measured/predicted ratio > 1 means transfers take longer
            # than modeled: derate this level's effective bandwidth
            bw = bw / machine.calibration_factor("level", lv.name)
        ai = flops_it / vol_it if vol_it > 0 else math.inf
        perf = ai * bw
        t_cy = vol_it * unit * machine.clock_hz / bw if bw else 0.0
        levels.append(RooflineLevel(level=label, arithmetic_intensity=ai,
                                    bandwidth=bw, bench_kernel=bench,
                                    performance=perf, time_cy_per_unit=t_cy))
    # L1<->register entry (classic variant models it with L1 bandwidth)
    if variant.upper() != "IACA":
        l1_bytes = kernel.first_level_bytes() if hasattr(kernel, "first_level_bytes") \
            else sum(a.array.element_bytes for a in kernel.accesses)
        try:
            bw, bench = machine.measured_bandwidth("L1", cores, r, w, rw)
            ai = flops_it / l1_bytes
            levels.insert(0, RooflineLevel(
                level="L1", arithmetic_intensity=ai, bandwidth=bw,
                bench_kernel=bench, performance=ai * bw,
                time_cy_per_unit=l1_bytes * unit * machine.clock_hz / bw))
        except (ValueError, KeyError):
            pass
    return RooflineResult(unit_iterations=unit, t_core=t_core,
                          core_performance=core_perf, levels=levels,
                          flops_per_unit=flops_unit, clock_hz=machine.clock_hz,
                          variant=("IACA" if variant.upper() == "IACA"
                                   else "classic"),
                          predictor=volumes.predictor,
                          predictor_params=dict(volumes.params),
                          incore_model=ic.model if ic is not None else "",
                          incore=ic.to_dict() if ic is not None else {},
                          calibrated=apply_cal)
