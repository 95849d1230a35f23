"""Static diagnostics over kernels, machine files, and analysis requests
(a copy of ``repro.core.lint``: the same rules, codes and words).

The paper's workflow assumes a lot before any number is trustworthy:
affine accesses for layer conditions, internally consistent machine
files, in-core tables covering the kernel's instruction mix.  This
package checks those assumptions *before* modeling and reports
structured :class:`Diagnostic` records instead of deep crashes or
silently wrong predictions:

    from repro_torch.core import lint
    report = lint.lint_request(kernel, machine, model="ecm",
                               predictor="LC", incore="simple")
    report.ok()            # no error-severity findings
    report.render()        # the CLI's text form
    report.to_sarif()      # SARIF 2.1.0 for code-scanning UIs

Entry points: ``analyze(..., lint="warn"|"error")`` and the ``lint`` and
``machine validate`` subcommands of ``python -m repro_torch``.  The rule
catalog is the JAX package's ``docs/lint.md``.
"""
from ..kernel_ir import SourceSpan  # noqa: F401
from .diagnostics import (Diagnostic, LintedResult, LintError,  # noqa: F401
                          LintReport, SEVERITIES)
from .engine import (FAMILIES, LC_UNSAFE_CODES,  # noqa: F401
                     LintContext, LintRule, RULE_REGISTRY,
                     clear_report_cache, lc_safe, lint_cross,
                     lint_kernel, lint_machine, lint_request,
                     register_rule, resolve_rule, rules, run_lint)

# importing the rule modules registers them
from . import rules_kernel, rules_machine, rules_cross  # noqa: E402,F401


def load_failure(source: str, exc: Exception, *,
                 kind: str = "kernel") -> LintReport:
    """Wrap a frontend/machine load failure as a one-diagnostic report
    (code ``K100`` for kernel sources, ``M200`` for machine files) — the
    lint CLI surfaces trace-spec mismatches, parse errors, and malformed
    YAML as diagnostics instead of exceptions."""
    code = "K100" if kind == "kernel" else "M200"
    d = Diagnostic(
        code=code, severity="error",
        message=f"failed to load {kind} {source!r}: "
                f"{type(exc).__name__}: {exc}",
        suggestion="fix the source before any rule can run",
        subject=source)
    return LintReport(diagnostics=[d], target=source)
