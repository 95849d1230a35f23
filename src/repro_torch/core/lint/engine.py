"""The lint engine: rule registry + runners (a copy of
``repro.core.lint.engine``).

Mirrors the repo's other registry subsystems
(:data:`~repro_torch.core.predictors.PREDICTOR_REGISTRY`,
:data:`~repro_torch.core.incore.INCORE_REGISTRY`): every rule is a
:class:`LintRule` subclass registered by stable code in
:data:`RULE_REGISTRY`, and :func:`run_lint` runs the applicable subset
over a :class:`LintContext` — the kernel (any frontend's output), the
machine description, and the analysis *request* (model / predictor /
incore / compiled names) — collecting :class:`Diagnostic` records into a
:class:`LintReport`.

Three rule families:

* ``kernel``  (K1xx) — properties of the loop nest itself: non-affine or
  data-dependent subscripts, out-of-bounds accesses, aliasing,
  reductions, LC applicability, compiled-sweep eligibility;
* ``machine`` (M2xx) — internal consistency of the machine YAML:
  bandwidth monotonicity, cache geometry, ports-table coverage, FMA
  decomposition, element-size support, hierarchy completeness;
* ``cross``   (X3xx) — request combinations that are individually valid
  but jointly not: model/input-kind mismatches, SIM with the compiled
  sweep plan, the ports in-core model on a machine without a ports table.

A rule that itself crashes is downgraded to an ``L000`` warning rather
than aborting the run: lint must never be the component that fails.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Iterable

from .. import identity as _identity
from ..kernel_ir import LoopKernel
from ..machine import Machine
from .diagnostics import Diagnostic, LintReport

#: Rule codes whose presence marks a kernel as outside the layer-condition
#: model's input language (the paper's "cases where LC analysis is not
#: easily possible", §4).  :func:`lc_safe` keys off this set; the
#: LC-vs-SIM soundness property test pins it.
LC_UNSAFE_CODES = frozenset({"K101", "K102", "K106"})


@dataclasses.dataclass
class LintContext:
    """Everything a rule may inspect.  Any field may be None — rules
    declare what they ``need`` and are skipped when it is missing."""
    kernel: Any = None             # LoopKernel | HLOProgram | None
    machine: Machine | None = None
    request: dict = dataclasses.field(default_factory=dict)
    filename: str = ""             # what to call the target in reports

    @property
    def loop_kernel(self) -> LoopKernel | None:
        return self.kernel if isinstance(self.kernel, LoopKernel) else None


class LintRule(abc.ABC):
    """One static check.  ``code`` is the stable registry key (never
    recycle a retired code), ``family`` routes it, ``needs`` lists the
    context fields that must be non-None for the rule to run."""

    code: str = "?"
    family: str = "kernel"         # "kernel" | "machine" | "cross"
    title: str = ""
    needs: tuple[str, ...] = ()

    @abc.abstractmethod
    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        ...

    def applicable(self, ctx: LintContext) -> bool:
        for field in self.needs:
            if getattr(ctx, field, None) is None:
                return False
        return True


RULE_REGISTRY: dict[str, LintRule] = {}

FAMILIES = ("kernel", "machine", "cross")


def register_rule(cls: type[LintRule]) -> type[LintRule]:
    if cls.code in RULE_REGISTRY:
        raise ValueError(f"duplicate lint rule code {cls.code!r}")
    if cls.family not in FAMILIES:
        raise ValueError(f"rule {cls.code}: unknown family {cls.family!r}")
    RULE_REGISTRY[cls.code] = cls()
    return cls


def resolve_rule(code: str) -> LintRule:
    try:
        return RULE_REGISTRY[code.upper()]
    except KeyError:
        raise ValueError(
            f"unknown lint rule {code!r}; "
            f"available: {sorted(RULE_REGISTRY)}") from None


def rules(families: Iterable[str] | None = None) -> list[LintRule]:
    """Registered rules in code order, optionally restricted by family."""
    fams = set(families) if families is not None else None
    return [r for code, r in sorted(RULE_REGISTRY.items())
            if fams is None or r.family in fams]


def _crash_diag(rule: LintRule, exc: Exception) -> Diagnostic:
    return Diagnostic(
        code="L000", severity="warning",
        message=f"lint rule {rule.code} crashed: "
                f"{type(exc).__name__}: {exc}",
        suggestion="report this; the rule's checks were skipped",
        subject=rule.code)


def run_lint(kernel=None, machine: Machine | None = None, *,
             families: Iterable[str] | None = None,
             filename: str = "", **request) -> LintReport:
    """Run every applicable registered rule and collect the findings.

    ``request`` carries the analysis request being vetted (``model=``,
    ``predictor=``, ``incore=``, ``compiled=``, ``cores=`` …); cross
    rules read it, kernel/machine rules ignore it.  Reports are memoized
    per (kernel structure, machine fingerprint, request): warm
    ``analyze(..., lint="warn")`` loops pay a dict lookup, not a sympy
    bound proof.
    """
    key = _memo_key(kernel, machine, families, filename, request)
    if key is not None:
        hit = _REPORTS.get(key)
        if hit is not None:
            return hit
    ctx = LintContext(kernel=kernel, machine=machine,
                      request=dict(request), filename=filename)
    target = filename or getattr(kernel, "name", "") or \
        (machine.name if machine is not None else "")
    report = LintReport(target=target)
    for rule in rules(families):
        if not rule.applicable(ctx):
            continue
        try:
            report.extend(rule.check(ctx))
        except Exception as e:              # noqa: BLE001 - see _crash_diag
            report.extend([_crash_diag(rule, e)])
    report = report.sorted()
    if key is not None:
        while len(_REPORTS) >= _REPORTS_MAX:
            _REPORTS.pop(next(iter(_REPORTS)))
        _REPORTS[key] = report
    return report


_REPORTS: dict[tuple, LintReport] = {}
_REPORTS_MAX = 1024


def _memo_key(kernel, machine, families, filename, request):
    try:
        kkey = _identity.source_key(kernel) if kernel is not None else None
        mkey = machine.fingerprint if machine is not None else None
        return (kkey, mkey,
                tuple(sorted(families)) if families is not None else None,
                filename, _identity.freeze(request))
    except (TypeError, ValueError):
        return None                         # unkeyable source: just run


def clear_report_cache() -> None:
    _REPORTS.clear()


# -- family-scoped runners ---------------------------------------------

def lint_kernel(kernel, machine: Machine | None = None,
                filename: str = "") -> LintReport:
    """Kernel rules only (machine optional context, e.g. cacheline size)."""
    return run_lint(kernel, machine, families=("kernel",),
                    filename=filename)


def lint_machine(machine: Machine, filename: str = "") -> LintReport:
    """Machine rules only (the ``machine validate`` CLI path)."""
    return run_lint(None, machine, families=("machine",),
                    filename=filename)


def lint_request(kernel, machine: Machine, *, filename: str = "",
                 **request) -> LintReport:
    """The full pre-analysis pass: all three families over one request
    (what ``analyze(..., lint=...)`` and the ``lint`` subcommand run)."""
    return run_lint(kernel, machine, filename=filename, **request)


def lint_cross(kernel, machine: Machine, **request) -> LintReport:
    """Cross rules only — the CLI's cheap pre-flight for invalid
    model/predictor/incore combinations."""
    return run_lint(kernel, machine, families=("cross",), **request)


def lc_safe(report: LintReport) -> bool:
    """True when no finding questions layer-condition applicability (the
    codes in :data:`LC_UNSAFE_CODES`)."""
    return not any(d.code in LC_UNSAFE_CODES for d in report.diagnostics)
