"""The analysis entry point of the port (the counterpart of
``repro.core.analyze`` and ``repro.core.sweep``).

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
memoizing :class:`~repro_torch.core.session.AnalysisSession` per machine,
unless ``service=`` (a :class:`repro_torch.service.AnalysisService`) routes
it through the disk-backed, coalescing result store.  ``lint=`` runs the
static diagnostics pass (:mod:`repro_torch.core.lint`) first, and
``sweep(..., workers=N)`` shards a grid across a spawned process pool.
"""
from __future__ import annotations

import pathlib
from typing import Any

from .frontends import load_kernel as _frontend_load
from .machine import Machine
from .machine import load as load_machine
from .model_api import Result
from .session import AnalysisSession, _freeze

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


#: Accepted values for ``analyze(..., lint=)`` / ``sweep(..., lint=)``.
LINT_MODES = ("off", "warn", "error")


def _lint_gate(kernel, mach: Machine, mode: str, **request):
    """The pre-compute lint pass behind ``lint="warn"|"error"``: run all
    rule families over the loaded kernel + machine + request, raise
    :class:`~repro_torch.core.lint.LintError` for mode ``"error"`` when any
    error-severity finding exists, and hand the report back so results
    can carry it (``LintedResult``)."""
    if mode not in LINT_MODES:
        raise ValueError(
            f"unknown lint mode {mode!r}; expected one of {list(LINT_MODES)}")
    if mode == "off":
        return None
    from . import lint as lint_mod
    report = lint_mod.lint_request(
        kernel, mach,
        filename=getattr(kernel, "source_path", "")
        or getattr(kernel, "name", ""),
        **request)
    if mode == "error":
        report.raise_if_errors()
    return report


def _attach_report(out: dict, report) -> dict:
    """Wrap every sweep result in a ``LintedResult`` carrying ``report``
    (sweep payloads stay pure on the cache/store paths; wrapping happens
    on the way out)."""
    if report is None:
        return out
    from .lint import LintedResult
    return {m: [LintedResult(r, report) for r in rs]
            for m, rs in out.items()}


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
    ('simple'/'ports').  Pass ``service=`` (an
    :class:`repro_torch.service.AnalysisService`) to serve the request
    through the disk-backed, coalescing service tier instead.

    ``lint`` runs the static diagnostics pass (:mod:`repro_torch.core.lint`)
    before any model computes: ``"error"`` raises
    :class:`~repro_torch.core.lint.LintError` on error-severity findings,
    ``"warn"`` (and ``"error"`` with only warnings) returns a
    ``LintedResult`` whose ``to_dict()`` carries the findings under a
    ``"diagnostics"`` key — every modeled number stays bit-for-bit
    identical to ``lint="off"`` (the default)."""
    if service is not None:
        if session is not None:
            raise ValueError("pass either session= or service=, not both")
        return service.analyze(source, machine, model, predictor,
                               frontend=frontend, name=name,
                               constants=constants, cores=cores,
                               sim_kwargs=sim_kwargs, incore=incore,
                               lint=lint, element_bytes=element_bytes,
                               frontend_opts=frontend_opts, **opts)
    mach = resolve_machine(machine)
    kernel = load_kernel(source, constants, element_bytes,
                         frontend=frontend, name=name,
                         **(frontend_opts or {}))
    report = _lint_gate(kernel, mach, lint, model=model,
                        predictor=predictor, incore=incore)
    res = _session(session, mach).analyze(
        kernel, model, predictor=predictor, cores=cores,
        sim_kwargs=sim_kwargs, incore=incore, **opts)
    if report is not None:
        from .lint import LintedResult
        return LintedResult(res, report)
    return res


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
    forces the per-point symbolic path.  ``service=`` routes the whole
    sweep through an :class:`repro_torch.service.AnalysisService` (disk
    cache + coalescing); ``workers > 1`` shards the grid across a spawned
    process pool (:func:`repro_torch.service.sweep_sharded`) — both
    produce ``to_dict``-identical results.  ``lint`` behaves as in
    :func:`analyze`: the report is computed once for the whole sweep and
    attached to every returned result."""
    if service is not None:
        if session is not None:
            raise ValueError("pass either session= or service=, not both")
        return service.sweep(source, machine, param, values, models=models,
                             predictor=predictor, frontend=frontend,
                             name=name, constants=constants, cores=cores,
                             sim_kwargs=sim_kwargs, incore=incore,
                             lint=lint, element_bytes=element_bytes,
                             frontend_opts=frontend_opts,
                             compiled=compiled, workers=workers, **opts)
    mach = resolve_machine(machine)
    kernel = load_kernel(source, constants, element_bytes,
                         frontend=frontend, name=name,
                         **(frontend_opts or {}))
    report = _lint_gate(kernel, mach, lint, models=list(models),
                        predictor=predictor, incore=incore,
                        compiled=compiled,
                        sweep_params=(list(param) if isinstance(param, dict)
                                      else [str(param)]),
                        cores_axis=AnalysisSession._cores_axis(cores)
                        is not None)
    if workers and workers > 1:
        from ..service.workers import sweep_sharded
        out = sweep_sharded(kernel, mach, param, values, models=models,
                            predictor=predictor, cores=cores,
                            sim_kwargs=sim_kwargs, incore=incore,
                            compiled=compiled, workers=workers, opts=opts)
        return _attach_report(out, report)
    out = _session(session, mach).sweep(
        kernel, param, values, models=models, predictor=predictor,
        cores=cores, sim_kwargs=sim_kwargs, incore=incore,
        compiled=compiled, **opts)
    return _attach_report(out, report)


def tune(family: str, machine: Machine | str, **opts):
    """Autotune a kernel family on ``machine`` — the predict → measure →
    calibrate loop (:func:`repro_torch.tune.tune`), with the same keyword
    arguments (``config=``, ``top_k=``, ``measure=``, ``device=``,
    ``session=``, ``service=``, ...); returns a
    :class:`repro_torch.tune.TuneReport`.
    Imported lazily: analysis-only callers never load the tuner."""
    from ..tune import tune as _tune
    return _tune(family, machine, **opts)
