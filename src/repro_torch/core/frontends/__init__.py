"""Kernel-frontend registry (a copy of ``repro.core.frontends``).

The paper's tool accepts one input language — a C loop nest — and drives
every analysis from it.  This package generalizes that front door: a
*frontend* turns some source representation into the object the models
consume, and every frontend registers itself by name so the unified
:func:`repro_torch.core.analyze` entry point can resolve them uniformly:

    ========  =======================================  ==========
    name      accepts                                  produces
    ========  =======================================  ==========
    c         C source text / ``.c`` path              LoopKernel
    builder   LoopKernel / ``make_stencil`` kwargs     LoopKernel
    trace     Python ``@kernel_spec`` point function   LoopKernel
    hlo       HLO text / path / compiled executable    HLOProgram
    graph     ``graph:<arch>[:<shape>]``               GraphProgram
    ========  =======================================  ==========

The ``trace`` frontend is :mod:`repro_torch.core.trace`, registered here;
``hlo`` is :mod:`.hlo`; ``graph`` (:mod:`.graph`, the port's own
programs, captured by :mod:`repro_torch.core.graph_analysis`) has no JAX
counterpart and registers after ``hlo``.

The contract is :class:`KernelFrontend`: ``load(source, **opts)`` returns a
kernel object whose ``produces`` kind ("loop" or "hlo") tells the model
layer what it is;
:func:`detect_frontend` guesses the right frontend from the source value so
``analyze(source, machine)`` usually needs no ``frontend=`` argument.
"""
from __future__ import annotations

import abc
import pathlib
from typing import Any, Protocol, runtime_checkable

from .. import trace as _trace


@runtime_checkable
class KernelSource(Protocol):
    """Minimal contract of everything a frontend may return: models and the
    memoizing session only need a structural identity.
    :class:`~repro_torch.core.kernel_ir.LoopKernel` satisfies it through
    :func:`repro_torch.core.identity.kernel_key`; non-loop kernels
    (:class:`~repro_torch.core.frontends.hlo.HLOProgram`) implement
    ``cache_key()`` directly."""

    def cache_key(self) -> tuple: ...


class KernelFrontend(abc.ABC):
    """One way of turning a source representation into a kernel object.

    ``name`` is the registry key; ``produces`` declares the output kind
    ("loop" for :class:`~repro_torch.core.kernel_ir.LoopKernel`, "hlo"
    for HLO programs) so the model layer can check compatibility before
    analyzing.
    """

    name: str = "?"
    produces: str = "loop"

    @abc.abstractmethod
    def load(self, source: Any, **opts):
        """Build the kernel object from ``source``.

        Common options every frontend accepts (and may ignore): ``name``
        (kernel name) and ``constants`` (symbol bindings, the CLI's ``-D``).
        """

    @abc.abstractmethod
    def matches(self, source: Any) -> bool:
        """Cheap structural test used by :func:`detect_frontend`."""


FRONTEND_REGISTRY: dict[str, KernelFrontend] = {}


def register_frontend(cls: type[KernelFrontend]) -> type[KernelFrontend]:
    FRONTEND_REGISTRY[cls.name.lower()] = cls()
    return cls


def resolve_frontend(name: str) -> KernelFrontend:
    try:
        return FRONTEND_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown kernel frontend {name!r}; "
            f"available: {sorted(FRONTEND_REGISTRY)}") from None


# detection order: specific object types first, ambiguous strings last
# (HLO before C, as in the JAX package)
_DETECT_ORDER = ("builder", "trace", "graph", "hlo", "c")


def detect_frontend(source: Any) -> KernelFrontend:
    """Pick the frontend whose ``matches`` accepts ``source``."""
    for name in _DETECT_ORDER:
        fe = FRONTEND_REGISTRY.get(name)
        if fe is not None and fe.matches(source):
            return fe
    raise ValueError(
        f"no registered frontend recognizes source {type(source).__name__}: "
        f"{str(source)[:80]!r}; pass frontend= explicitly "
        f"(available: {sorted(FRONTEND_REGISTRY)})")


def resolve_path(source: str | pathlib.Path) -> pathlib.Path | None:
    """Resolve a source *path* against the cwd and the bundled configs.

    ``configs/stencils/stencil_3d7pt.c`` and bare names like
    ``stencil_3d7pt.c`` work from any working directory, mirroring how the
    machine loader resolves ``h100_sxm.yaml``; the port's own copies of
    the paper's listings live in ``repro_torch/configs/stencils``.
    """
    p = pathlib.Path(source)
    if p.exists():
        return p
    if p.is_absolute():
        return None
    pkg_root = pathlib.Path(__file__).resolve().parent.parent.parent
    for base in (pkg_root, pkg_root / "configs" / "stencils"):
        cand = base / p
        if cand.exists():
            return cand
    return None


def load_kernel(source: Any, frontend: str | None = None, **opts):
    """The one frontend entry point: resolve (or detect) a frontend and run
    it.  Returns what the frontend produces (a
    :class:`~repro_torch.core.kernel_ir.LoopKernel` or an HLO program)."""
    fe = resolve_frontend(frontend) if frontend else detect_frontend(source)
    return fe.load(source, **opts)


# importing the implementations registers them, in the JAX package's
# order (builder, c, hlo, trace), with the port's graph after hlo
from . import builder, c, hlo, graph  # noqa: E402,F401
from .graph import GraphProgram  # noqa: E402,F401
from .hlo import HLOProgram  # noqa: E402,F401


@register_frontend
class TraceFrontend(KernelFrontend):
    """Point functions carrying a ``@kernel_spec``, or ``trace:module[:attr]``
    references to them (:mod:`repro_torch.core.trace`)."""

    name = "trace"
    produces = "loop"

    def matches(self, source) -> bool:
        if callable(source) and hasattr(source, "__kernel_spec__"):
            return True
        return isinstance(source, str) and source.startswith("trace:")

    def load(self, source, name: str | None = None,
             constants: dict | None = None, **opts):
        if isinstance(source, str):
            ref = source[len("trace:"):] if source.startswith("trace:") \
                else source
            source = _trace._import_point(ref)
        if not callable(source):
            raise TypeError(
                f"trace frontend expects a point function (or "
                f"'module:attr' reference), got {type(source).__name__}")
        return _trace.trace_kernel(source, name=name, constants=constants,
                                   **opts)


from ..trace import kernel_spec, trace_kernel  # noqa: E402,F401
