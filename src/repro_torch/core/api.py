"""The analysis entry point of the port (the counterpart of
``repro.core.analyze`` and ``repro.core.sweep``, without the service tier
and lint).

    from repro_torch.core import analyze, sweep
    res = analyze("stencil_3d_long_range.c", "H100", model="ecm",
                  constants={"M": 130, "N": 1015})
    res.to_dict()
    sweep("trace:longrange3d", "H100", "N", range(64, 1025, 8),
          constants={"M": 130}, element_bytes=4)

``source`` is resolved through the frontend registry
(:mod:`repro_torch.core.frontends`): C text or a ``.c`` path (the paper's
listings are bundled as ``stencil_3d7pt.c``, ``stencil_3d_long_range.c``
and ``stencil_2d5pt.c``), a ``@kernel_spec`` point function or a
``"trace:<module>"`` reference, or a finished :class:`LoopKernel`;
``machine`` is a :class:`Machine`, a bundled short name (``"H100"``) or a
YAML path.  Models resolve by name through the registry of
:mod:`repro_torch.core.model_api`, and every call goes through a pooled
memoizing :class:`~repro_torch.core.session.AnalysisSession` per machine.
"""
from __future__ import annotations

import pathlib
from typing import Any

from .frontends import load_kernel as _frontend_load
from .machine import Machine
from .machine import load as load_machine
from .model_api import Result
from .session import AnalysisSession, _freeze

#: what the port leaves to ROADMAP.md Queue 1, item 7 (service tier, lint)
_NOT_PORTED = "is not ported to repro_torch yet (ROADMAP.md Queue 1, item 7)"

# session pool: one memoizing session per machine description, keyed by
# machine name (pass session= explicitly when juggling same-named variants)
_SESSIONS: dict[str, AnalysisSession] = {}


def resolve_machine(machine: Machine | str | pathlib.Path) -> Machine:
    """Accept a Machine, a bundled short name ('H100'), a bundled yaml name
    ('h100_sxm.yaml'), or a filesystem path."""
    if isinstance(machine, Machine):
        return machine
    return load_machine(str(machine))


def get_session(machine: Machine | str | pathlib.Path) -> AnalysisSession:
    """The pooled memoizing session for ``machine`` (created on first use)."""
    m = resolve_machine(machine)
    sess = _SESSIONS.get(m.name)
    if sess is None:
        sess = _SESSIONS[m.name] = AnalysisSession(m)
    return sess


def clear_sessions() -> None:
    _SESSIONS.clear()
    _KERNELS.clear()


# loaded-kernel cache: without it every warm analyze() call would still
# re-read and re-parse (or re-trace) its source just to compute the key
# that hits the session's result cache.  Only hashable sources (paths,
# source text, point functions) are cached; kernels are immutable
# (bind() copies).
_KERNELS: dict[tuple, Any] = {}
_KERNELS_MAX = 512


def load_kernel(source: Any, constants: dict | None = None,
                element_bytes: int | None = None, *,
                frontend: str | None = None, name: str | None = None,
                **frontend_opts):
    """Resolve ``source`` through the frontend registry (``frontend=``
    forces one, else it is detected) into a :class:`LoopKernel` with
    ``constants`` bound (the CLI's ``-D``) and ``name`` set.
    ``element_bytes`` overrides a traced spec's element size (4 for the
    float32 the CUDA kernels run); other ``frontend_opts`` go to the
    frontend."""
    opts = dict(frontend_opts)
    if element_bytes is not None:
        opts["element_bytes"] = element_bytes
    try:
        key = (frontend, source, name, _freeze(constants or {}),
               _freeze(opts))
        hash(key)
    except TypeError:                 # unhashable source (LoopKernel, dict)
        return _frontend_load(source, frontend=frontend, name=name,
                              constants=constants, **opts)
    hit = _KERNELS.get(key)
    if hit is not None:
        return hit
    kernel = _frontend_load(source, frontend=frontend, name=name,
                            constants=constants, **opts)
    while len(_KERNELS) >= _KERNELS_MAX:
        _KERNELS.pop(next(iter(_KERNELS)))
    _KERNELS[key] = kernel
    return kernel


def _refuse(service, workers: int = 0, lint: str = "off") -> None:
    if service is not None:
        raise ValueError(f"service= (the disk-backed result store) "
                         f"{_NOT_PORTED}")
    if workers and workers > 1:
        raise ValueError(f"workers > 1 (sharded sweeps over a process pool) "
                         f"{_NOT_PORTED}")
    if lint != "off":
        raise ValueError(f"lint={lint!r} (the static diagnostics pass) "
                         f"{_NOT_PORTED}")


def _session(session: AnalysisSession | None, mach: Machine
             ) -> AnalysisSession:
    sess = session if session is not None else get_session(mach)
    if sess.machine.name != mach.name:
        raise ValueError(
            f"session is bound to machine {sess.machine.name!r}, "
            f"not {mach.name!r}")
    return sess


def analyze(source: Any, machine: Machine | str, model: str = "ecm",
            predictor: str = "LC", *, frontend: str | None = None,
            name: str | None = None, constants: dict | None = None,
            cores: int = 1, sim_kwargs: dict | None = None,
            incore: str = "simple", lint: str = "off",
            session: AnalysisSession | None = None, service=None,
            element_bytes: int | None = None,
            frontend_opts: dict | None = None, **opts) -> Result:
    """Analyze any kernel source under any registered model ('ecm',
    'roofline' or 'roofline-iaca') and return its result (``ECMResult`` or
    ``RooflineResult``; both have ``to_dict()``).

    ``source`` goes through :func:`load_kernel`; ``predictor``, ``cores``,
    ``sim_kwargs``, ``incore`` and remaining ``opts`` (``calibrated=``) go
    to the model, through the pooled session for ``machine`` unless
    ``session=`` names one.  For the SIM predictor, ``sim_kwargs`` carries
    the simulator options — ``warmup_rows``/``measure_rows``/``seed`` and
    ``backend`` (``auto``/``scalar``/``vector``) — which the session
    normalizes into its cache keys and the result records as
    ``predictor_params``.  ``incore`` names a registered in-core model
    ('simple'/'ports').  ``lint`` and ``service`` are the JAX package's
    switches for parts the port does not carry yet: anything but their
    defaults raises."""
    _refuse(service, lint=lint)
    mach = resolve_machine(machine)
    kernel = load_kernel(source, constants, element_bytes,
                         frontend=frontend, name=name,
                         **(frontend_opts or {}))
    return _session(session, mach).analyze(
        kernel, model, predictor=predictor, cores=cores,
        sim_kwargs=sim_kwargs, incore=incore, **opts)


def sweep(source: Any, machine: Machine | str, param, values=None,
          models=("ecm",), predictor: str = "LC", *,
          frontend: str | None = None, name: str | None = None,
          constants: dict | None = None, cores=1,
          sim_kwargs: dict | None = None, incore: str = "simple",
          lint: str = "off", session: AnalysisSession | None = None,
          service=None, workers: int = 0,
          element_bytes: int | None = None,
          frontend_opts: dict | None = None,
          compiled: bool | str = "auto",
          **opts) -> dict[str, list[Result]]:
    """Frontend-aware batch API: load once, evaluate ``models`` over a
    parameter grid through the memoizing session (see
    :meth:`AnalysisSession.sweep`).

    ``param`` is one symbol name (``values`` = its value list) or a
    ``{symbol: values}`` mapping describing an N-dimensional grid;
    ``cores`` is a core count or a sequence, which adds a batched cores
    axis (innermost).  Results come back flattened in C order (axes in
    ``param`` order, cores last).  ``compiled`` selects the sweep engine:
    ``"auto"`` (default) batches eligible sweeps through the compiled
    analytic plan (:mod:`repro_torch.core.compiled`; results stay bit for
    bit identical to the per-point path), ``True`` requires it, ``False``
    forces the per-point symbolic path."""
    _refuse(service, workers, lint)
    mach = resolve_machine(machine)
    kernel = load_kernel(source, constants, element_bytes,
                         frontend=frontend, name=name,
                         **(frontend_opts or {}))
    return _session(session, mach).sweep(
        kernel, param, values, models=models, predictor=predictor,
        cores=cores, sim_kwargs=sim_kwargs, incore=incore,
        compiled=compiled, **opts)


def tune(family: str, machine: Machine | str, **opts):
    """Autotune a kernel family on ``machine`` — the predict → measure →
    calibrate loop (:func:`repro_torch.tune.tune`), with the same keyword
    arguments (``config=``, ``top_k=``, ``measure=``, ``device=``,
    ``session=``, ...); returns a :class:`repro_torch.tune.TuneReport`.
    Imported lazily: analysis-only callers never load the tuner."""
    from ..tune import tune as _tune
    return _tune(family, machine, **opts)
