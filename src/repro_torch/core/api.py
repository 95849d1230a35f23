"""The analysis entry point of the port (the counterpart of
``repro.core.analyze``, without sessions, the service tier or lint).

    from repro_torch.core import analyze
    from repro_torch.kernels import longrange3d
    res = analyze(longrange3d.point, "H100", model="ecm",
                  constants={"M": 130, "N": 1015}, element_bytes=4)
    res.to_dict()

``source`` is a ``@kernel_spec`` point function, a ``"trace:<module>"``
reference, or a finished :class:`LoopKernel`; ``machine`` a
:class:`Machine`, a bundled short name (``"H100"``) or a YAML path.  The
three loop models of the JAX package's registry are dispatched by name.
"""
from __future__ import annotations

import functools
import pathlib
from typing import Any, Callable

from . import ecm as _ecm
from . import roofline as _roofline
from .kernel_ir import LoopKernel
from .machine import Machine
from .machine import load as load_machine
from .trace import _import_point, trace_kernel

#: Registry name -> model function, as in ``repro.core.model_api``
#: (``roofline`` is the classic variant, ``roofline-iaca`` the in-core one).
MODELS: dict[str, Callable] = {
    "ecm": _ecm.model,
    "roofline": functools.partial(_roofline.model, variant="classic"),
    "roofline-iaca": functools.partial(_roofline.model, variant="IACA"),
}


def resolve_machine(machine: Machine | str | pathlib.Path) -> Machine:
    """Accept a Machine, a bundled short name ('H100'), a bundled yaml name
    ('h100_sxm.yaml'), or a filesystem path."""
    if isinstance(machine, Machine):
        return machine
    return load_machine(str(machine))


def load_kernel(source: Any, constants: dict | None = None,
                element_bytes: int | None = None) -> LoopKernel:
    """Resolve ``source`` into a :class:`LoopKernel` with ``constants``
    bound (the CLI's ``-D``).  ``element_bytes`` overrides a traced
    spec's element size (4 for the float32 the CUDA kernels run)."""
    if isinstance(source, LoopKernel):
        if element_bytes is not None:
            raise ValueError("element_bytes applies to traced sources only")
        return source.bind(**constants) if constants else source
    if isinstance(source, str):
        if not source.startswith("trace:"):
            raise ValueError(
                f"unsupported source {source!r}: the port loads point "
                "functions, 'trace:<module>[:attr]' references and "
                "LoopKernels (the C frontend is not ported)")
        source = _import_point(source[len("trace:"):])
    if not callable(source) or not hasattr(source, "__kernel_spec__"):
        raise TypeError(
            "expected a @kernel_spec point function, a 'trace:' reference "
            f"or a LoopKernel, got {type(source).__name__}")
    return trace_kernel(source, constants=constants,
                        element_bytes=element_bytes)


def analyze(source: Any, machine: Machine | str, model: str = "ecm",
            predictor: str = "LC", constants: dict | None = None,
            cores: int = 1, incore: str = "simple",
            element_bytes: int | None = None):
    """Analyze ``source`` on ``machine`` under the registry ``model``
    ('ecm', 'roofline' or 'roofline-iaca') and return its result
    (``ECMResult`` or ``RooflineResult``; both have ``to_dict()``)."""
    try:
        fn = MODELS[model.lower()]
    except KeyError:
        raise ValueError(
            f"unknown performance model {model!r}; "
            f"available: {sorted(MODELS)}") from None
    kernel = load_kernel(source, constants, element_bytes)
    return fn(kernel, resolve_machine(machine), predictor=predictor,
              cores=cores, incore=incore)


def tune(family: str, machine: Machine | str, **opts):
    """Autotune a kernel family on ``machine`` — the predict → measure →
    calibrate loop (:func:`repro_torch.tune.tune`), with the same keyword
    arguments (``config=``, ``top_k=``, ``measure=``, ``device=``, ...);
    returns a :class:`repro_torch.tune.TuneReport`.  Imported lazily:
    analysis-only callers never load the tuner."""
    from ..tune import tune as _tune
    return _tune(family, machine, **opts)
