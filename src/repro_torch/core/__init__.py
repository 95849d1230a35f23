"""The analytic core of the port: trace → layer conditions → ECM/Roofline
against a machine file.  Copies of the JAX package's host-side modules,
so that ``repro_torch`` imports nothing of ``repro``."""
from .api import analyze, load_kernel, resolve_machine, tune  # noqa: F401
from .machine import Machine  # noqa: F401
from .machine import load as load_machine  # noqa: F401
from .trace import kernel_spec, trace_kernel  # noqa: F401
