"""Diagnostic records and reports — the lint subsystem's output language.

(A copy of ``repro.core.lint.diagnostics``: the encodings are equal
field for field, so the parity tests compare them directly.)

A :class:`Diagnostic` is one finding: a stable rule code (``K101``,
``M203``, ``X303``…), a severity, a human message, a concrete suggestion
(the fix, phrased as the CLI flag or YAML edit that applies it), and —
when the kernel came from the C front end — a :class:`SourceSpan`
pointing at the offending source.  A :class:`LintReport` is an ordered
collection of findings with JSON (``to_dict``) and SARIF 2.1.0
(``to_sarif``) encodings, plus the text rendering the CLI prints.

:class:`LintError` is the exception ``analyze(..., lint="error")`` and
the CLI raise when error-severity findings exist; it subclasses
``ValueError`` so existing callers that treat analysis errors uniformly
keep working.
"""
from __future__ import annotations

import dataclasses

from ..kernel_ir import SourceSpan

#: Diagnostic severities, most severe first.
SEVERITIES = ("error", "warning", "info")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One lint finding (stable shape: pinned by tests and stored by the
    service tier, so only add fields, never rename)."""
    code: str                      # stable rule code, e.g. "K101"
    severity: str                  # "error" | "warning" | "info"
    message: str                   # what is wrong
    suggestion: str = ""           # how to fix it (CLI flag / YAML edit)
    span: SourceSpan | None = None
    subject: str = ""              # offending entity (array, level, model)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"unknown severity {self.severity!r}; "
                f"expected one of {list(SEVERITIES)}")

    def format(self, fallback: str = "<kernel>") -> str:
        loc = self.span.label(fallback) if self.span else fallback
        txt = f"{loc}: {self.severity} [{self.code}] {self.message}"
        if self.suggestion:
            txt += f" (suggestion: {self.suggestion})"
        return txt

    def to_dict(self) -> dict:
        return {"code": self.code, "severity": self.severity,
                "message": self.message, "suggestion": self.suggestion,
                "subject": self.subject,
                "span": self.span.to_dict() if self.span else None}

    @classmethod
    def from_dict(cls, d: dict) -> "Diagnostic":
        span = d.get("span")
        return cls(code=str(d["code"]), severity=str(d["severity"]),
                   message=str(d["message"]),
                   suggestion=str(d.get("suggestion", "")),
                   subject=str(d.get("subject", "")),
                   span=SourceSpan.from_dict(span) if span else None)


class LintError(ValueError):
    """Raised when error-severity findings block an analysis
    (``analyze(..., lint="error")`` or the CLI pre-flight).  Carries the
    full :class:`LintReport` on ``.report``."""

    def __init__(self, report: "LintReport"):
        self.report = report
        errs = report.errors
        lines = [d.format(report.target or "<kernel>") for d in errs]
        super().__init__(
            f"lint found {len(errs)} error(s):\n" + "\n".join(lines))


@dataclasses.dataclass
class LintReport:
    """Ordered lint findings over one (kernel, machine, request) triple."""
    diagnostics: list[Diagnostic] = dataclasses.field(default_factory=list)
    target: str = ""               # what was linted (kernel/machine names)

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    def codes(self) -> list[str]:
        return [d.code for d in self.diagnostics]

    def ok(self) -> bool:
        return not self.errors

    def extend(self, diags) -> None:
        self.diagnostics.extend(diags)

    def sorted(self) -> "LintReport":
        """Severity-major, code-minor ordering (stable for pinning)."""
        diags = sorted(self.diagnostics,
                       key=lambda d: (_SEV_RANK[d.severity], d.code))
        return LintReport(diagnostics=diags, target=self.target)

    def raise_if_errors(self) -> "LintReport":
        if self.errors:
            raise LintError(self)
        return self

    # -- encodings -----------------------------------------------------
    def to_dict(self) -> dict:
        return {"target": self.target,
                "errors": len(self.errors),
                "warnings": len(self.warnings),
                "diagnostics": [d.to_dict() for d in self.diagnostics]}

    @classmethod
    def from_dict(cls, d: dict) -> "LintReport":
        return cls(diagnostics=[Diagnostic.from_dict(x)
                                for x in d.get("diagnostics", [])],
                   target=str(d.get("target", "")))

    def to_sarif(self) -> dict:
        """Minimal SARIF 2.1.0 log (one run, one result per finding) —
        enough for GitHub code scanning and sarif viewers."""
        level = {"error": "error", "warning": "warning", "info": "note"}
        rules, seen = [], set()
        for d in self.diagnostics:
            if d.code not in seen:
                seen.add(d.code)
                rules.append({"id": d.code})
        results = []
        for d in self.diagnostics:
            res = {"ruleId": d.code, "level": level[d.severity],
                   "message": {"text": d.message + (
                       f" (suggestion: {d.suggestion})"
                       if d.suggestion else "")}}
            if d.span is not None:
                res["locations"] = [{"physicalLocation": {
                    "artifactLocation": {"uri": d.span.path or self.target},
                    "region": {"startLine": d.span.line,
                               "startColumn": d.span.col}}}]
            results.append(res)
        return {"version": "2.1.0",
                "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
                "runs": [{"tool": {"driver": {
                              "name": "repro-lint",
                              "rules": rules}},
                          "results": results}]}

    def render(self) -> str:
        """The CLI's text form: one line per finding plus a summary."""
        fallback = f"<{self.target}>" if self.target else "<kernel>"
        lines = [d.format(fallback) for d in self.diagnostics]
        n_err, n_warn = len(self.errors), len(self.warnings)
        n_info = len(self.diagnostics) - n_err - n_warn
        summary = (f"{n_err} error(s), {n_warn} warning(s), "
                   f"{n_info} info")
        if not self.diagnostics:
            summary = "no findings"
        lines.append(f"lint: {self.target or '<kernel>'}: {summary}")
        return "\n".join(lines)


class LintedResult:
    """A model result with its lint report attached.

    Results are cached and shared across callers (sessions memoize, the
    service keeps a memory tier), so diagnostics must never be written
    onto the result object itself — this delegating wrapper adds the
    ``diagnostics`` key to ``to_dict()`` and forwards everything else.
    """

    __slots__ = ("result", "report")

    def __init__(self, result, report: LintReport):
        object.__setattr__(self, "result", result)
        object.__setattr__(self, "report", report)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "result"), name)

    def __repr__(self) -> str:
        return f"LintedResult({self.result!r}, {len(self.report.diagnostics)} diagnostics)"

    def to_dict(self) -> dict:
        d = dict(self.result.to_dict())
        d["diagnostics"] = [dg.to_dict()
                            for dg in self.report.diagnostics]
        return d
