"""TuneReport: the record of one predict → measure → calibrate run.

A copy of ``repro.tune.report``.  It round-trips through plain dicts in
the JAX package's format, so either package's ``from_dict`` decodes the
other's ``to_dict``.  ``options["device"]`` names the device the
measurements ran on.
"""
from __future__ import annotations

import dataclasses
import math

from .measure import TimedRun

#: candidate record statuses
STATUS_OK = "ok"                 # measured successfully
STATUS_FAILED = "failed"         # measurement crashed / timed out
STATUS_PREDICTED = "predicted"   # ranked analytically, not shortlisted
STATUS_INFEASIBLE = "infeasible"


@dataclasses.dataclass(frozen=True)
class CandidateOutcome:
    """One candidate's place in a tune run: its analytic prediction (with
    the binding term class) and, when shortlisted, its measurement."""
    params: dict
    status: str
    predicted_s: float | None = None
    bound: str = ""
    reason: str = ""
    measured: TimedRun | None = None

    @property
    def measured_s(self) -> float | None:
        if self.measured is not None and self.measured.ok:
            return self.measured.wall_s
        return None

    def to_dict(self) -> dict:
        out: dict = {"params": dict(self.params), "status": self.status}
        if self.predicted_s is not None and math.isfinite(self.predicted_s):
            out["predicted_s"] = self.predicted_s
        if self.bound:
            out["bound"] = self.bound
        if self.reason:
            out["reason"] = self.reason
        if self.measured is not None:
            out["measured"] = self.measured.to_dict()
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "CandidateOutcome":
        meas = d.get("measured")
        return cls(params=dict(d["params"]), status=str(d["status"]),
                   predicted_s=(float(d["predicted_s"])
                                if "predicted_s" in d else None),
                   bound=str(d.get("bound", "")),
                   reason=str(d.get("reason", "")),
                   measured=TimedRun.from_dict(meas) if meas else None)


@dataclasses.dataclass(frozen=True)
class TuneReport:
    """Everything one ``python -m repro_torch tune`` run decided and why.

    ``candidates`` lists the shortlisted (measured) outcomes plus the
    top predicted tail, best-first; full enumeration totals live in
    ``n_enumerated``/``n_feasible`` (the report caps the stored list so a
    2000-candidate space doesn't balloon the result store).
    """
    family: str
    machine: str
    machine_fingerprint: str
    config: dict
    options: dict
    candidates: tuple[CandidateOutcome, ...]
    n_enumerated: int
    n_feasible: int
    default_params: dict
    chosen_params: dict
    predicted_chosen_s: float | None = None
    predicted_default_s: float | None = None
    measured_chosen_s: float | None = None
    measured_default_s: float | None = None
    speedup_vs_default: float | None = None
    error: dict = dataclasses.field(default_factory=dict)
    calibration: dict = dataclasses.field(default_factory=dict)

    @property
    def measured_outcomes(self) -> list[CandidateOutcome]:
        return [c for c in self.candidates
                if c.status in (STATUS_OK, STATUS_FAILED)]

    @property
    def n_failed(self) -> int:
        return sum(1 for c in self.candidates if c.status == STATUS_FAILED)

    def to_dict(self) -> dict:
        return {
            "kind": "tune",
            "family": self.family,
            "machine": self.machine,
            "machine_fingerprint": self.machine_fingerprint,
            "config": dict(self.config),
            "options": dict(self.options),
            "candidates": [c.to_dict() for c in self.candidates],
            "n_enumerated": self.n_enumerated,
            "n_feasible": self.n_feasible,
            "default_params": dict(self.default_params),
            "chosen_params": dict(self.chosen_params),
            "predicted_chosen_s": self.predicted_chosen_s,
            "predicted_default_s": self.predicted_default_s,
            "measured_chosen_s": self.measured_chosen_s,
            "measured_default_s": self.measured_default_s,
            "speedup_vs_default": self.speedup_vs_default,
            "error": dict(self.error),
            "calibration": dict(self.calibration),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TuneReport":
        def _f(key: str) -> float | None:
            v = d.get(key)
            return None if v is None else float(v)
        return cls(
            family=str(d["family"]), machine=str(d["machine"]),
            machine_fingerprint=str(d.get("machine_fingerprint", "")),
            config=dict(d.get("config", {})),
            options=dict(d.get("options", {})),
            candidates=tuple(CandidateOutcome.from_dict(c)
                             for c in d.get("candidates", [])),
            n_enumerated=int(d.get("n_enumerated", 0)),
            n_feasible=int(d.get("n_feasible", 0)),
            default_params=dict(d.get("default_params", {})),
            chosen_params=dict(d.get("chosen_params", {})),
            predicted_chosen_s=_f("predicted_chosen_s"),
            predicted_default_s=_f("predicted_default_s"),
            measured_chosen_s=_f("measured_chosen_s"),
            measured_default_s=_f("measured_default_s"),
            speedup_vs_default=_f("speedup_vs_default"),
            error=dict(d.get("error", {})),
            calibration=dict(d.get("calibration", {})))

    # --- human-readable rendering -------------------------------------
    def render(self) -> str:
        def _p(params: dict) -> str:
            return ", ".join(f"{k}={v}" for k, v in sorted(params.items()))

        def _s(v: float | None) -> str:
            return "-" if v is None else f"{v * 1e3:.3f} ms"

        lines = [
            f"tune {self.family} on {self.machine}",
            f"  shape: {_p(self.config)}",
            f"  measured on: {self.options.get('device') or '-'}",
            f"  candidates: {self.n_enumerated} enumerated, "
            f"{self.n_feasible} feasible, "
            f"{len(self.measured_outcomes)} measured, "
            f"{self.n_failed} failed",
            f"  default: [{_p(self.default_params)}]  "
            f"pred {_s(self.predicted_default_s)}  "
            f"meas {_s(self.measured_default_s)}",
            f"  chosen:  [{_p(self.chosen_params)}]  "
            f"pred {_s(self.predicted_chosen_s)}  "
            f"meas {_s(self.measured_chosen_s)}",
        ]
        if self.speedup_vs_default is not None:
            lines.append(
                f"  speedup vs default: {self.speedup_vs_default:.2f}x")
        if self.error.get("n"):
            lines.append(
                f"  model error (rms log, n={self.error['n']}): "
                f"{self.error.get('rms_log', float('nan')):.3f} "
                f"(geomean meas/pred "
                f"{self.error.get('geomean_ratio', float('nan')):.3g})")
        if self.calibration:
            t = self.calibration.get("time", {}).get(self.family)
            if t is not None:
                lines.append(f"  derived calibration: time[{self.family}] "
                             f"= {t:.3g} (apply with --apply-calibration)")
        show = [c for c in self.candidates
                if c.status in (STATUS_OK, STATUS_FAILED)]
        if show:
            lines.append("  measured shortlist:")
            for c in show:
                if c.status == STATUS_OK:
                    lines.append(
                        f"    [{_p(c.params)}]  pred {_s(c.predicted_s)}  "
                        f"meas {_s(c.measured_s)}  ({c.bound}-bound)")
                else:
                    err = c.measured.error if c.measured else "failed"
                    lines.append(f"    [{_p(c.params)}]  FAILED: {err}")
        return "\n".join(lines)
