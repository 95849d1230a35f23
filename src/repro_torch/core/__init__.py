"""The analytic core of the port: frontends (C, builder, trace) → layer
conditions → ECM/Roofline against a machine file, memoized by sessions
and batched by compiled sweep plans.  Copies of the JAX package's
host-side modules, so that ``repro_torch`` imports nothing of ``repro``."""
from .api import (analyze, clear_sessions, get_session,  # noqa: F401
                  load_kernel, resolve_machine, sweep, tune)
from .c_parser import parse_kernel  # noqa: F401
from .machine import Machine  # noqa: F401
from .machine import load as load_machine  # noqa: F401
from .session import AnalysisSession  # noqa: F401
from .trace import kernel_spec, trace_kernel  # noqa: F401
