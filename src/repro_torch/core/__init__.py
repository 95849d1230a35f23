"""The analytic core of the port: frontends (C, builder, trace) → layer
conditions → ECM/Roofline against a machine file, memoized by sessions
and batched by compiled sweep plans, vetted by lint and rendered by
reports; the ``hlo`` frontend and :mod:`.hlo_analysis` price whole HLO
modules (``hlo-roofline``).  Copies of the JAX package's host-side
modules, so that ``repro_torch`` imports nothing of ``repro``."""
from . import hlo_analysis, lint, reports  # noqa: F401
from .api import (analyze, clear_sessions, get_session,  # noqa: F401
                  load_kernel, resolve_machine, sweep, tune)
from .c_parser import parse_kernel  # noqa: F401
from .frontends import HLOProgram  # noqa: F401
from .kernel_ir import FlopCount, LoopKernel, SourceSpan  # noqa: F401
from .lint import (RULE_REGISTRY, Diagnostic, LintedResult,  # noqa: F401
                   LintError, LintReport, LintRule, lint_kernel,
                   lint_machine, lint_request, register_rule, resolve_rule)
from .machine import Machine  # noqa: F401
from .machine import load as load_machine  # noqa: F401
from .session import AnalysisSession  # noqa: F401
from .trace import kernel_spec, trace_kernel  # noqa: F401
