"""The in-core analysis result shared by every registered in-core model
(a copy of ``repro.core.incore.result``; the scheduler fields stay so that
``to_dict`` matches the JAX package key for key).

``t_ol`` / ``t_nol`` are the ECM's two port classes (paper §2.5): the
overlapping part (arithmetic + stores, hidden behind data transfers) and
the non-overlapping part (L1 load cycles, serialized with transfers).
The registry models differ in *how* they derive the two numbers — the
``"simple"`` heuristic aggregates machine-file port rates per flop kind,
the ``"ports"`` scheduler computes per-port occupation over the lowered
op stream — but both report through this one dataclass.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InCoreResult:
    unit_iterations: int          # iterations per unit of work (one CL)
    t_ol: float                   # cy per unit: overlapping (arith + stores)
    t_nol: float                  # cy per unit: non-overlapping (loads)
    port_cycles: dict[str, float]  # per op kind (ADD/MUL/.../LOAD/STORE)
    flops_per_unit: float
    # --- provenance + scheduler breakdown (the "ports" model) ----------
    model: str = "simple"          # registry name that produced this result
    port_occupation: dict[str, float] = dataclasses.field(
        default_factory=dict)      # per scheduler port (cy per unit)
    t_latency: float = 0.0         # loop-carried dependency bound (cy/unit)
    critical_path: float = 0.0     # one iteration's dep-chain latency (cy)
    bound: str = "throughput"      # which bound binds: throughput | latency

    @property
    def t_core(self) -> float:
        return max(self.t_ol, self.t_nol, self.t_latency)

    # --- machine-readable output (DESIGN.md §4) -----------------------
    def to_dict(self) -> dict:
        return {
            "model": self.model,
            "unit_iterations": self.unit_iterations,
            "t_ol": self.t_ol,
            "t_nol": self.t_nol,
            "port_cycles": dict(self.port_cycles),
            "flops_per_unit": self.flops_per_unit,
            "port_occupation": dict(self.port_occupation),
            "t_latency": self.t_latency,
            "critical_path": self.critical_path,
            "bound": self.bound,
            "t_core": self.t_core,        # derived, for dict-only readers
        }

    @classmethod
    def from_dict(cls, d: dict) -> "InCoreResult":
        return cls(
            unit_iterations=int(d["unit_iterations"]),
            t_ol=float(d["t_ol"]), t_nol=float(d["t_nol"]),
            port_cycles={str(k): float(v)
                         for k, v in d.get("port_cycles", {}).items()},
            flops_per_unit=float(d["flops_per_unit"]),
            model=str(d.get("model", "simple")),
            port_occupation={str(k): float(v)
                             for k, v in d.get("port_occupation", {}).items()},
            t_latency=float(d.get("t_latency", 0.0)),
            critical_path=float(d.get("critical_path", 0.0)),
            bound=str(d.get("bound", "throughput")))
