"""The Execution-Cache-Memory model (paper §1.2.2, §3.2).

A copy of ``repro.core.ecm`` (result type, data terms, model).
``T_ECM = max(T_OL, T_nOL + T_L1L2 + T_L2L3 + T_L3MEM)`` on x86 (strictly
non-overlapping hierarchy, as Kerncraft implements).  Each level carries an
``overlap`` flag: overlapping transfers (double-buffered DMA on a TPU, many
resident warps on a GPU) contribute max-wise, serialized ones add.

Multicore/multichip scaling assumes perfect scalability until the shared
bottleneck saturates: ``n_s = ceil(T_ECM / T_mem)`` (paper §3.2).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import incore as _incore
from .incore import InCoreResult
from .kernel_ir import LoopKernel
from .machine import Machine
from .predictors import VolumePrediction, predict_volumes, predictor_tag


@dataclasses.dataclass(frozen=True)
class ECMResult:
    unit_iterations: int
    t_ol: float
    t_nol: float
    contributions: list[tuple[str, float]]   # [('L1-L2', cy), ...] serialized
    overlapped: list[tuple[str, float]]      # TPU overlap-mode contributions
    flops_per_unit: float
    clock_hz: float
    # provenance: which cache predictor produced the data terms, and (for
    # SIM) the resolved simulation options — so cached, fresh, and
    # JSON-round-tripped reports are distinguishable
    predictor: str = "LC"
    predictor_params: dict = dataclasses.field(default_factory=dict)
    # in-core provenance (mirrors the predictor fields): which registered
    # InCoreModel produced T_OL/T_nOL, plus its full breakdown (per-port
    # occupation, latency bound) for reports and JSON consumers
    incore_model: str = "simple"
    incore: dict = dataclasses.field(default_factory=dict)
    # True when the machine's tuned calibration factors were applied to
    # the in-core and transfer terms (autotuner feedback loop)
    calibrated: bool = False

    @property
    def t_data(self) -> float:
        return self.t_nol + sum(c for _, c in self.contributions)

    @property
    def t_incore_latency(self) -> float:
        """The in-core model's loop-carried latency bound (cy per unit;
        0 unless the 'ports' scheduler found a binding carried chain)."""
        return float(self.incore.get("t_latency", 0.0)) if self.incore \
            else 0.0

    @property
    def t_ecm(self) -> float:
        # a loop-carried dependence chain bounds the core below, data
        # transfers notwithstanding — keep T_ECM consistent with the
        # in-core breakdown the result carries
        cand = [self.t_ol, self.t_data, self.t_incore_latency]
        cand += [c for _, c in self.overlapped]
        return max(cand)

    @property
    def t_mem(self) -> float:
        terms = self.contributions + self.overlapped
        return terms[-1][1] if terms else 0.0

    @property
    def saturation_cores(self) -> int:
        if self.t_mem <= 0:
            return 1
        return max(1, math.ceil(self.t_ecm / self.t_mem))

    @property
    def predictor_tag(self) -> str:
        """Compact provenance tag, e.g. ``LC`` or ``SIM:vector``."""
        return predictor_tag(self.predictor, self.predictor_params)

    def notation(self) -> str:
        segs = " | ".join(f"{c:.1f}" for _, c in self.contributions)
        return ("{ " + f"{self.t_ol:.1f} || {self.t_nol:.1f}"
                + (f" | {segs}" if segs else "") + " } cy/CL"
                + f" [{self.predictor_tag}] [{self.incore_model}]")

    def notation_cumulative(self) -> str:
        acc = self.t_nol
        parts = [f"{max(self.t_ol, acc):.1f}"]
        for _, c in self.contributions:
            acc += c
            parts.append(f"{max(self.t_ol, acc):.1f}")
        return "{ " + " \\ ".join(parts) + " } cy/CL"

    # --- performance conversions --------------------------------------
    def performance_flops(self, cores: int = 1) -> float:
        """Predicted flop/s at ``cores`` under the saturation model."""
        if self.flops_per_unit == 0 or self.t_ecm == 0:
            return 0.0
        single = self.flops_per_unit / self.t_ecm * self.clock_hz
        sat = (self.flops_per_unit / self.t_mem * self.clock_hz
               if self.t_mem > 0 else math.inf)
        return min(single * cores, sat)

    def scaling_curve(self, max_cores: int) -> list[float]:
        """``performance_flops`` at 1..max_cores in one vectorized pass.

        The saturation inputs (``t_ecm``, ``t_mem`` — each a walk over
        the contribution lists) are computed once instead of once per
        core count; output parity with the per-cores loop is pinned by
        tests."""
        n = int(max_cores)
        if n <= 0:
            return []
        if self.flops_per_unit == 0 or self.t_ecm == 0:
            return [0.0] * n
        single = self.flops_per_unit / self.t_ecm * self.clock_hz
        sat = (self.flops_per_unit / self.t_mem * self.clock_hz
               if self.t_mem > 0 else math.inf)
        curve = np.minimum(single * np.arange(1, n + 1, dtype=np.float64),
                           sat)
        return [float(x) for x in curve]

    # --- machine-readable output -------------------------------------
    def to_dict(self) -> dict:
        """JSON-serializable form; primary fields plus derived summaries.
        The ``calibrated`` key is emitted only when True, so every
        uncalibrated payload stays byte-identical to pre-calibration
        goldens."""
        out = {
            "model": "ecm",
            "unit_iterations": self.unit_iterations,
            "t_ol": self.t_ol,
            "t_nol": self.t_nol,
            "contributions": [[n, c] for n, c in self.contributions],
            "overlapped": [[n, c] for n, c in self.overlapped],
            "flops_per_unit": self.flops_per_unit,
            "clock_hz": self.clock_hz,
            "predictor": self.predictor,
            "predictor_params": dict(self.predictor_params),
            "incore_model": self.incore_model,
            "incore": dict(self.incore),
            # derived, for consumers that only read the dict:
            "t_data": self.t_data,
            "t_ecm": self.t_ecm,
            "saturation_cores": self.saturation_cores,
            "notation": self.notation(),
        }
        if self.calibrated:
            out["calibrated"] = True
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "ECMResult":
        return cls(unit_iterations=int(d["unit_iterations"]),
                   t_ol=float(d["t_ol"]), t_nol=float(d["t_nol"]),
                   contributions=[(str(n), float(c))
                                  for n, c in d["contributions"]],
                   overlapped=[(str(n), float(c)) for n, c in d["overlapped"]],
                   flops_per_unit=float(d["flops_per_unit"]),
                   clock_hz=float(d["clock_hz"]),
                   predictor=str(d.get("predictor", "LC")),
                   predictor_params=dict(d.get("predictor_params", {})),
                   incore_model=str(d.get("incore_model", "simple")),
                   incore=dict(d.get("incore", {})),
                   calibrated=bool(d.get("calibrated", False)))


def data_terms(machine: Machine, volumes_bpi: dict,
               unit: int) -> tuple[list[tuple[str, object]], list[tuple[str, object]]]:
    """Lower per-level traffic β_k into the ECM transfer terms (cycles per
    unit of work), split into serialized and overlapping contributions.

    Pure elementwise arithmetic, so ``volumes_bpi`` values may also be
    numpy arrays over a sweep grid (as the JAX package's compiled plans
    use it).
    """
    serial: list[tuple[str, object]] = []
    overlapped: list[tuple[str, object]] = []
    names = machine.level_names
    for i, lv in enumerate(machine.levels):
        vol = volumes_bpi.get(lv.name, 0.0) * unit
        nxt = names[i + 1] if i + 1 < len(names) else "MEM"
        if lv.cycles_per_cacheline is not None:
            cy = vol / lv.cl_size * lv.cycles_per_cacheline
        elif lv.bandwidth_bytes_per_cycle:
            cy = vol / lv.bandwidth_bytes_per_cycle
        else:  # last level: measured saturated main-memory bandwidth
            cy = vol * machine.clock_hz / machine.main_memory_bandwidth
        (overlapped if lv.overlap else serial).append((f"{lv.name}-{nxt}", cy))
    return serial, overlapped


def _scale_terms(machine: Machine, terms: list) -> list:
    """Scale each transfer term ('VMEM-MEM', cy) by its *source* level's
    calibration factor (the term label's left-hand level)."""
    return [(label, cy * machine.calibration_factor(
        "level", label.split("-", 1)[0])) for label, cy in terms]


def model(kernel: LoopKernel, machine: Machine, predictor: str = "LC",
          cores: int = 1, sim_kwargs: dict | None = None,
          volumes: VolumePrediction | None = None,
          incore_result: InCoreResult | None = None,
          incore: str = "simple", calibrated: bool = False) -> ECMResult:
    """Build the full ECM model: in-core + cache prediction + data terms.

    ``predictor`` names a registered :class:`~repro_torch.core.predictors
    .CachePredictor` ('LC' or 'SIM'; ``sim_kwargs`` reaches SIM only) and
    ``incore`` a registered :class:`~repro_torch.core.incore.InCoreModel`
    ('simple' or 'ports'), mirroring the CLI's ``--cache-predictor`` /
    ``--incore`` switches.  A precomputed ``volumes`` prediction and/or
    ``incore_result`` short-circuits the corresponding analysis so
    multi-model reports share work (``incore_result`` takes precedence
    over the ``incore`` name).

    ``calibrated=True`` applies the machine's tuned ``calibration``
    factors (written by the JAX package's autotuner): the
    ``compute`` factor scales T_OL/T_nOL, each ``levels`` factor scales
    that level's transfer term.  Off by default — an uncalibrated call on
    a calibrated machine file is bit-identical to one on the pristine
    file, keeping every existing golden stable.
    """
    unit = kernel.iterations_per_cacheline(machine.cacheline_bytes)
    ic = incore_result or _incore.analyze(kernel, machine, model=incore)
    if volumes is None:
        volumes = predict_volumes(kernel, machine, predictor, cores=cores,
                                  sim_kwargs=sim_kwargs)
    serial, overl = data_terms(machine, volumes.bytes_per_it, unit)
    t_ol, t_nol = ic.t_ol, ic.t_nol
    apply_cal = bool(calibrated and machine.calibration)
    if apply_cal:
        f_c = machine.calibration_factor("compute")
        t_ol, t_nol = t_ol * f_c, t_nol * f_c
        serial = _scale_terms(machine, serial)
        overl = _scale_terms(machine, overl)
    return ECMResult(unit_iterations=unit, t_ol=t_ol, t_nol=t_nol,
                     contributions=serial, overlapped=overl,
                     flops_per_unit=ic.flops_per_unit, clock_hz=machine.clock_hz,
                     predictor=volumes.predictor,
                     predictor_params=dict(volumes.params),
                     incore_model=ic.model, incore=ic.to_dict(),
                     calibrated=apply_cal)
