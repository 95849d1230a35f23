"""Memoizing analysis session (a copy of ``repro.core.session``).

Blocking sweeps, multi-model reports, and any high-traffic analysis service
evaluate the same kernel at many parameter points and under several models.
The expensive pieces — sympy-heavy layer conditions, the cache simulator,
the in-core models — depend only on ``(kernel, machine, predictor,
opts)``, so an :class:`AnalysisSession` caches all three tiers:

  1. in-core analysis        (keyed by kernel *structure* × in-core model:
                              bound constants never enter, so one entry
                              serves every point of a sweep)
  2. predictor volumes       (keyed by kernel × predictor × cores × opts)
  3. full model results      (keyed by model × kernel × predictor ×
                              in-core model × opts)

For the SIM predictor the option key is *normalized* — defaults filled
in and ``backend='auto'`` resolved against the machine — so equivalent
spellings share entries while different simulator backends/windows key
separately; predictors that never see sim options (LC) drop them from
the key entirely.

The session exposes a batch API::

    sess = AnalysisSession(machine)
    results = sess.sweep(kernel, "N", range(100, 1100, 10),
                         models=["ecm", "roofline-iaca"])

Within a sweep the ECM and Roofline models share each point's predictor
volumes and in-core result instead of recomputing them; repeating a sweep
(or re-analyzing any kernel the session has seen) is a pure cache hit.

A session is bound to one machine.  Keys are structural — two kernels with
the same loops, accesses, and bound constants share cache entries no matter
how they were constructed.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Mapping, Sequence

import numpy as np

from . import incore as _incore
from .cachesim import normalize_sim_kwargs
from .compiled import (CompiledSweepPlan, CompileError, compile_plan,
                       meshgrid_points)
from .identity import freeze as _freeze
from .identity import incore_key, kernel_key, source_key  # noqa: F401
from .incore import InCoreResult
from .kernel_ir import LoopKernel
from .machine import Machine
from .model_api import MODEL_REGISTRY, Result, resolve_model
from .predictors import VolumePrediction, predict_volumes, resolve_predictor


@dataclasses.dataclass
class SessionStats:
    incore_hits: int = 0
    incore_misses: int = 0
    volume_hits: int = 0
    volume_misses: int = 0
    result_hits: int = 0
    result_misses: int = 0
    # compiled-sweep tier
    plan_compiles: int = 0          # sweep plans lowered (per structure)
    plan_broadcasts: int = 0        # points answered by regime broadcast
    plan_fallback_points: int = 0   # points demoted to per-point symbolic

    @property
    def hits(self) -> int:
        return self.incore_hits + self.volume_hits + self.result_hits

    @property
    def misses(self) -> int:
        return self.incore_misses + self.volume_misses + self.result_misses

    def to_dict(self) -> dict:
        """JSON-safe counters (the CLI's ``--stats`` / service ``cache
        stats`` payload): every field plus the derived totals."""
        d = dataclasses.asdict(self)
        d["hits"] = self.hits
        d["misses"] = self.misses
        return d

    def add(self, other: "SessionStats") -> "SessionStats":
        """Elementwise sum (aggregating a service's per-machine sessions)."""
        return SessionStats(**{
            f.name: getattr(self, f.name) + getattr(other, f.name)
            for f in dataclasses.fields(SessionStats)})


class AnalysisSession:
    """Shared, memoized predictor/in-core/model state for one machine."""

    def __init__(self, machine: Machine, predictor: str = "LC",
                 cores: int = 1, sim_kwargs: dict | None = None,
                 incore: str = "simple"):
        self.machine = machine
        self.predictor = predictor
        self.cores = cores
        self.sim_kwargs = dict(sim_kwargs or {})
        self.incore_model = incore
        self.stats = SessionStats()
        self._incore: dict[tuple, InCoreResult] = {}
        self._volumes: dict[tuple, VolumePrediction] = {}
        self._results: dict[tuple, Result] = {}
        self._plans: dict[tuple, CompiledSweepPlan] = {}

    # ------------------------------------------------------------------
    def clear(self) -> None:
        self._incore.clear()
        self._volumes.clear()
        self._results.clear()
        self._plans.clear()
        self.stats = SessionStats()

    def _defaults(self, predictor, cores, sim_kwargs):
        return (self.predictor if predictor is None else predictor,
                self.cores if cores is None else cores,
                self.sim_kwargs if sim_kwargs is None else sim_kwargs)

    def _loop_key(self, model_name: str, kernel: LoopKernel, predictor: str,
                  cores: int, sim_kwargs: dict, incore: str,
                  opts: dict) -> tuple:
        """Result-cache key for a loop model run (shared by :meth:`analyze`
        and the compiled-sweep broadcast, which prefills the same tier)."""
        return (model_name, kernel_key(kernel), self.machine.name,
                predictor.upper(), cores,
                self.sim_key(predictor, sim_kwargs), incore.lower(),
                _freeze(opts))

    def sim_key(self, predictor: str, sim_kwargs: dict) -> tuple:
        """Cache-key fragment for the simulation options.

        Normalized so equivalent spellings share entries: predictors that
        never see sim_kwargs (LC) key as ``()``, and for SIM the defaults
        are filled in and ``backend='auto'`` is resolved against the
        machine — the key always names the backend actually simulating.
        """
        if not resolve_predictor(predictor).uses_sim_kwargs:
            return ()
        return _freeze(normalize_sim_kwargs(sim_kwargs, self.machine))

    # ------------------------------------------------------------------
    def incore(self, kernel: LoopKernel,
               model: str | None = None) -> InCoreResult:
        """Memoized in-core analysis (paper §2.5) under the named
        registered :class:`~repro_torch.core.incore.InCoreModel`.

        Keyed by kernel *structure* (:func:`~repro_torch.core.identity
        .incore_key`): in-core never reads bound constants, so every
        point of a sweep — compiled or per-point — shares one entry.
        """
        model = self.incore_model if model is None else model
        key = (incore_key(kernel), self.machine.name, model.lower())
        hit = self._incore.get(key)
        if hit is not None:
            self.stats.incore_hits += 1
            return hit
        self.stats.incore_misses += 1
        res = _incore.analyze(kernel, self.machine, model=model)
        self._incore[key] = res
        return res

    def volumes(self, kernel: LoopKernel, predictor: str | None = None,
                cores: int | None = None,
                sim_kwargs: dict | None = None) -> VolumePrediction:
        """Memoized per-level traffic prediction (β_k)."""
        predictor, cores, sim_kwargs = self._defaults(predictor, cores,
                                                      sim_kwargs)
        key = (kernel_key(kernel), self.machine.name, predictor.upper(),
               cores, self.sim_key(predictor, sim_kwargs))
        hit = self._volumes.get(key)
        if hit is not None:
            self.stats.volume_hits += 1
            return hit
        self.stats.volume_misses += 1
        res = predict_volumes(kernel, self.machine, predictor, cores=cores,
                              sim_kwargs=sim_kwargs)
        self._volumes[key] = res
        return res

    def analyze(self, kernel, model: str = "ecm",
                predictor: str | None = None, cores: int | None = None,
                sim_kwargs: dict | None = None,
                incore: str | None = None, **opts) -> Result:
        """Memoized full model run, routed through :data:`MODEL_REGISTRY`.

        ``kernel`` is any frontend output.  For loop models, a miss feeds
        the model the session's memoized volumes and in-core result
        (``incore`` names the registered in-core model, defaulting to the
        session's), so several models over one kernel share both;
        non-loop models skip the predictor and in-core tiers — those
        switches do not apply to them — but still memoize full results.
        """
        m = resolve_model(model)
        if m.input_kind != "loop":
            if isinstance(kernel, LoopKernel):
                raise TypeError(
                    f"model {m.name!r} consumes {m.input_kind!r} sources, "
                    "not LoopKernel IR; load the source through the "
                    f"{m.input_kind!r} frontend")
            key = (m.name, source_key(kernel), self.machine.name,
                   _freeze(opts))
            hit = self._results.get(key)
            if hit is not None:
                self.stats.result_hits += 1
                return hit
            self.stats.result_misses += 1
            res = m.analyze(kernel, self.machine, **opts)
            self._results[key] = res
            return res
        if not isinstance(kernel, LoopKernel):
            loop_models = sorted(
                n for n, mm in MODEL_REGISTRY.items()
                if mm.input_kind != "loop")
            raise TypeError(
                f"model {m.name!r} consumes LoopKernel IR, got "
                f"{type(kernel).__name__}; use one of the non-loop models "
                f"{loop_models} or a loop frontend (c/builder/trace)")
        predictor, cores, sim_kwargs = self._defaults(predictor, cores,
                                                      sim_kwargs)
        incore = self.incore_model if incore is None else incore
        key = self._loop_key(m.name, kernel, predictor, cores, sim_kwargs,
                             incore, opts)
        hit = self._results.get(key)
        if hit is not None:
            self.stats.result_hits += 1
            return hit
        self.stats.result_misses += 1
        vols = self.volumes(kernel, predictor, cores, sim_kwargs)
        ic = self.incore(kernel, incore)
        res = m.analyze(kernel, self.machine, predictor=predictor,
                        cores=cores, sim_kwargs=sim_kwargs, volumes=vols,
                        incore_result=ic, **opts)
        self._results[key] = res
        return res

    def seed_result(self, kernel, model: str, result: Result,
                    predictor: str | None = None, cores: int | None = None,
                    sim_kwargs: dict | None = None,
                    incore: str | None = None, **opts) -> None:
        """Prefill the result tier with an externally computed ``result``.

        A service tier can use this to back-fill disk-cache hits and
        worker-pool shards, so later lookups through this session are warm
        hits instead of recomputations.  The key is built exactly like
        :meth:`analyze`'s, so a seeded entry and a computed one are
        indistinguishable.
        """
        m = resolve_model(model)
        if m.input_kind != "loop":
            key = (m.name, source_key(kernel), self.machine.name,
                   _freeze(opts))
        else:
            predictor, cores, sim_kwargs = self._defaults(predictor, cores,
                                                          sim_kwargs)
            incore = self.incore_model if incore is None else incore
            key = self._loop_key(m.name, kernel, predictor, cores,
                                 sim_kwargs, incore, opts)
        self._results[key] = result

    # ------------------------------------------------------------------
    def sweep_plan(self, kernel: LoopKernel, param,
                   cores: int | None = None,
                   incore: str | None = None) -> CompiledSweepPlan:
        """The compiled sweep plan for ``kernel``'s structure with ``param``
        unbound (lowered once, then cached alongside the other tiers).
        ``param`` is one symbol or an ordered sequence of them (N-D
        grids); N-D plans key without a core count — ``cores`` is a
        runtime axis of every evaluation call, not part of the lowered
        structure.  The plan's in-core result comes through the session's
        memoized tier — in-core is structure-only, so one analysis serves
        the entire grid."""
        incore = self.incore_model if incore is None else incore
        symbols = ((str(param),) if isinstance(param, str)
                   else tuple(str(s) for s in param))
        template = dataclasses.replace(
            kernel, constants={k: v for k, v in kernel.constants.items()
                               if k not in symbols})
        if isinstance(param, str):
            cores = self.cores if cores is None else cores
            key = (kernel_key(template), str(param), cores, incore.lower())
        else:
            cores = self.cores if cores is None else cores
            key = (kernel_key(template), symbols, incore.lower())
        plan = self._plans.get(key)
        if plan is None:
            plan = compile_plan(kernel, self.machine,
                                param if isinstance(param, str) else symbols,
                                cores=cores,
                                incore_result=self.incore(kernel, incore))
            self._plans[key] = plan
            self.stats.plan_compiles += 1
        return plan

    @staticmethod
    def _cores_axis(cores):
        """A ``cores`` argument as an axis: the list of core counts when a
        sequence was passed, else None (scalar core count, no axis)."""
        if isinstance(cores, (Sequence, np.ndarray)) \
                and not isinstance(cores, (str, bytes)):
            return [int(c) for c in cores]
        return None

    def _compile_blocker(self, param, values, models, predictor,
                         cores_axis=None) -> str | None:
        """Why this sweep cannot take the compiled path (None if it can)."""
        if not resolve_predictor(predictor).supports_compiled:
            return (f"predictor {predictor!r} has no analytic closed form "
                    "to compile")
        for m in models:
            if resolve_model(m).input_kind != "loop":
                return f"model {str(m)!r} does not consume LoopKernel IR"
        params = param if isinstance(param, Mapping) else {param: values}
        if not params:
            return "empty sweep"
        for s, vals in params.items():
            vals = list(vals) if vals is not None else []
            if not vals:
                return "empty sweep"
            for v in vals:
                try:
                    int(v)
                except (TypeError, ValueError):
                    return f"non-integer sweep value {v!r}"
            if not str(s).isidentifier():
                return f"sweep parameter {s!r} is not a symbol name"
        if cores_axis is not None:
            if not cores_axis:
                return "empty cores axis"
            if any(c < 1 for c in cores_axis):
                return f"core counts must be >= 1, got {cores_axis!r}"
        return None

    def sweep(self, kernel: LoopKernel, param, values=None,
              models=("ecm",), predictor: str | None = None,
              cores=None, sim_kwargs: dict | None = None,
              incore: str | None = None,
              compiled: bool | str = "auto", **opts) -> dict[str, list[Result]]:
        """Evaluate ``models`` over a parameter grid (the batch API).

        ``param`` is either one symbol name (with ``values`` its value
        list — the original 1-D surface) or a ``{symbol: values}`` mapping
        describing an N-dimensional grid (``values`` must then be None).
        ``cores`` is a scalar core count or a sequence — a sequence adds a
        batched *cores axis* (always innermost), every point evaluated at
        its own core count (effective shared-cache sizes and all).

        Returns ``{model_name: [result per grid point]}``, points
        flattened in C order (axes in ``param`` order, cores last).  Each
        point's predictor volumes and in-core analysis are computed once
        and shared by all requested models; repeating the sweep hits the
        result cache.

        ``compiled`` selects the evaluation engine: ``"auto"`` (default)
        routes numeric sweeps under an analytic predictor through a
        :class:`~repro_torch.core.compiled.CompiledSweepPlan` — the whole grid
        is batched through vectorized closed forms, the symbolic path runs
        once per LC *regime cell* (the Cartesian decomposition of the grid
        by identical per-level LC outcome), and results are bit-for-bit
        identical to the per-point path.  ``True`` requires the compiled
        path (raises :class:`~repro_torch.core.compiled.CompileError` when
        inapplicable, e.g. under the SIM predictor); ``False`` forces
        per-point evaluation.
        """
        if not isinstance(kernel, LoopKernel):
            raise TypeError(
                "sweep() varies symbolic loop constants, which only "
                f"LoopKernel sources carry (got {type(kernel).__name__})")
        if compiled not in (True, False, "auto"):
            raise ValueError(f"compiled must be True/False/'auto', "
                             f"got {compiled!r}")
        cores_axis = self._cores_axis(cores)
        if isinstance(param, Mapping):
            if values is not None:
                raise ValueError(
                    "pass axis values inside the {symbol: values} mapping, "
                    "not through values=")
            params = {str(s): list(vs) for s, vs in param.items()}
        else:
            if values is None:
                raise ValueError(f"sweep over {param!r} needs values")
            params = None
        if params is not None or cores_axis is not None:
            return self._sweep_nd(kernel,
                                  params if params is not None
                                  else {str(param): list(values)},
                                  cores_axis, models, predictor, cores,
                                  sim_kwargs, incore, compiled, opts)
        predictor, cores, sim_kwargs = self._defaults(predictor, cores,
                                                      sim_kwargs)
        incore = self.incore_model if incore is None else incore
        values = list(values)
        if compiled is not False:
            blocker = self._compile_blocker(param, values, models, predictor)
            if blocker is None and (compiled is True or len(values) >= 4):
                return self._sweep_compiled(kernel, param, values, models,
                                            predictor, cores, sim_kwargs,
                                            incore, opts)
            if compiled is True:
                raise CompileError(f"compiled sweep requested but {blocker}")
        out: dict[str, list[Result]] = {str(m): [] for m in models}
        for v in values:
            bound = kernel.bind(**{param: int(v)})
            for m in models:
                out[str(m)].append(
                    self.analyze(bound, m, predictor=predictor, cores=cores,
                                 sim_kwargs=sim_kwargs, incore=incore,
                                 **opts))
        return out

    def _sweep_nd(self, kernel, params, cores_axis, models, predictor,
                  cores, sim_kwargs, incore, compiled,
                  opts) -> dict[str, list[Result]]:
        """N-D grid sweep: flattened C-order evaluation over the Cartesian
        product of the ``params`` axes (plus the cores axis when given),
        compiled when eligible, per-point otherwise."""
        predictor, cores_default, sim_kwargs = self._defaults(
            predictor, None if cores_axis is not None else cores, sim_kwargs)
        incore = self.incore_model if incore is None else incore
        cores_spec = cores_axis if cores_axis is not None \
            else int(cores_default)
        blocker = None
        if compiled is not False:
            blocker = self._compile_blocker(params, None, models, predictor,
                                            cores_axis=cores_axis)
        npts_est = 1
        for vs in params.values():
            npts_est *= max(len(list(vs)), 1)
        if cores_axis is not None:
            npts_est *= max(len(cores_axis), 1)
        if compiled is not False and blocker is None \
                and (compiled is True or npts_est >= 4):
            return self._sweep_compiled_nd(kernel, params, cores_spec,
                                           models, predictor, sim_kwargs,
                                           incore, opts)
        if compiled is True:
            raise CompileError(f"compiled sweep requested but {blocker}")
        # per-point path over the full flattened grid (cores innermost)
        axes = [[int(v) for v in vs] for vs in params.values()]
        cl = cores_axis if cores_axis is not None else [int(cores_default)]
        syms = list(params)
        out: dict[str, list[Result]] = {str(m): [] for m in models}
        for point in itertools.product(*axes, cl):
            binding = dict(zip(syms, point[:-1]))
            c = point[-1]
            bound = kernel.bind(**binding)
            for m in models:
                out[str(m)].append(
                    self.analyze(bound, m, predictor=predictor, cores=c,
                                 sim_kwargs=sim_kwargs, incore=incore,
                                 **opts))
        return out

    def _sweep_compiled(self, kernel, param, values, models, predictor,
                        cores, sim_kwargs, incore,
                        opts) -> dict[str, list[Result]]:
        """Batched sweep over a compiled plan.

        The plan groups grid values into LC regimes in one vectorized
        call; each regime's representative runs the ordinary memoized
        symbolic path (:meth:`analyze`) and its frozen result object is
        broadcast — and cached under the per-point keys — for the rest of
        the regime.  A regime whose representative's symbolic volumes
        disagree with the plan's batched prediction, and any value whose
        offset ordering diverges from the compiled template, falls back to
        per-point evaluation, so results are always identical to
        ``compiled=False``.
        """
        plan = self.sweep_plan(kernel, param, cores, incore)
        ints = [int(v) for v in values]
        bound = {v: kernel.bind(**{param: v}) for v in set(ints)}
        keys: dict[tuple, tuple] = {}
        done: dict[tuple, Result] = {}
        missing: set[int] = set()
        model_names = [str(m) for m in models]
        for m, mname in zip(models, model_names):
            rname = resolve_model(m).name
            for v in bound:
                key = self._loop_key(rname, bound[v], predictor, cores,
                                     sim_kwargs, incore, opts)
                keys[(mname, v)] = key
                hit = self._results.get(key)
                if hit is not None:
                    self.stats.result_hits += 1
                    done[(mname, v)] = hit
                else:
                    missing.add(v)

        def _point(v, m):
            return self.analyze(bound[v], m, predictor=predictor,
                                cores=cores, sim_kwargs=sim_kwargs,
                                incore=incore, **opts)

        if missing:
            groups, fallback = plan.regimes(sorted(missing))
            for m, mname in zip(models, model_names):
                for sig, members in groups.items():
                    todo = [v for v in members if (mname, v) not in done]
                    if not todo:
                        continue
                    rep, rest = todo[0], todo[1:]
                    res = done[(mname, rep)] = _point(rep, m)
                    if not rest:
                        continue
                    # exactness guard: the symbolic volumes of the regime
                    # representative must equal the batched prediction
                    vol = self.volumes(bound[rep], predictor, cores,
                                       sim_kwargs)
                    want = plan.signature_volumes(sig)
                    if (set(vol.bytes_per_it) == set(want)
                            and all(vol.bytes_per_it[k] == want[k]
                                    for k in want)):
                        for v in rest:
                            self._results[keys[(mname, v)]] = res
                            done[(mname, v)] = res
                            self.stats.plan_broadcasts += 1
                    else:
                        self.stats.plan_fallback_points += len(rest)
                        for v in rest:
                            done[(mname, v)] = _point(v, m)
                for v in fallback:
                    if (mname, v) not in done:
                        self.stats.plan_fallback_points += 1
                        done[(mname, v)] = _point(v, m)
        return {mname: [done[(mname, v)] for v in ints]
                for mname in model_names}

    def _sweep_compiled_nd(self, kernel, params, cores_spec, models,
                           predictor, sim_kwargs, incore,
                           opts) -> dict[str, list[Result]]:
        """Batched N-D sweep over a compiled plan.

        The grid — the Cartesian product of the ``params`` axes plus the
        cores axis when ``cores_spec`` is a list — is flattened in C order
        and decomposed into *regime cells* of identical per-level LC
        outcome in one vectorized call.  Each cell's representative runs
        the ordinary memoized symbolic path (:meth:`analyze`) and its
        frozen result object is broadcast — and cached under the per-point
        keys — across the cell.  Models whose results bake in the core
        count (``cores_invariant_result`` False, e.g. Roofline) subdivide
        every cell by the point's cores before broadcasting; ECM results
        only *derive* multicore numbers, so one representative serves the
        whole cell across the cores axis.  The same two exactness guards
        as the 1-D path apply (offset-ordering validity per point, regime
        volumes vs the representative's symbolic volumes)."""
        syms = tuple(params)
        plan = self.sweep_plan(kernel, syms, incore=incore)
        coords, cores_arr, _shape = meshgrid_points(params, cores=cores_spec)
        npts = coords[syms[0]].size
        per_point_cores = cores_arr if isinstance(cores_arr, np.ndarray) \
            else None

        def _cores_at(i: int) -> int:
            return int(per_point_cores[i]) if per_point_cores is not None \
                else int(cores_arr)

        bindings = [tuple(int(coords[s][i]) for s in syms)
                    for i in range(npts)]
        bound: dict[tuple, LoopKernel] = {}
        for b in bindings:
            if b not in bound:
                bound[b] = kernel.bind(**dict(zip(syms, b)))
        keys: dict[tuple, tuple] = {}
        done: dict[tuple, Result] = {}
        missing: set[int] = set()
        model_names = [str(m) for m in models]
        for m, mname in zip(models, model_names):
            rname = resolve_model(m).name
            kcache: dict[tuple, tuple] = {}
            for i in range(npts):
                bk = (bindings[i], _cores_at(i))
                key = kcache.get(bk)
                if key is None:
                    key = kcache[bk] = self._loop_key(
                        rname, bound[bindings[i]], predictor, bk[1],
                        sim_kwargs, incore, opts)
                keys[(mname, i)] = key
                hit = self._results.get(key)
                if hit is not None:
                    self.stats.result_hits += 1
                    done[(mname, i)] = hit
                else:
                    missing.add(i)

        def _point(i, m):
            return self.analyze(bound[bindings[i]], m, predictor=predictor,
                                cores=_cores_at(i), sim_kwargs=sim_kwargs,
                                incore=incore, **opts)

        if missing:
            groups, fallback = plan.regimes_grid(coords, cores=cores_arr)
            for m, mname in zip(models, model_names):
                inv = getattr(resolve_model(m), "cores_invariant_result",
                              False)
                for sig, members in groups.items():
                    cells = [members] if inv or per_point_cores is None \
                        else [list(g) for _, g in itertools.groupby(
                            sorted(members, key=_cores_at), key=_cores_at)]
                    for cell in cells:
                        todo = [i for i in cell if (mname, i) not in done]
                        if not todo:
                            continue
                        rep, rest = todo[0], todo[1:]
                        res = done[(mname, rep)] = _point(rep, m)
                        if not rest:
                            continue
                        # exactness guard: the symbolic volumes of the cell
                        # representative must equal the batched prediction
                        vol = self.volumes(bound[bindings[rep]], predictor,
                                           _cores_at(rep), sim_kwargs)
                        want = plan.signature_volumes(sig)
                        if (set(vol.bytes_per_it) == set(want)
                                and all(vol.bytes_per_it[k] == want[k]
                                        for k in want)):
                            for i in rest:
                                self._results[keys[(mname, i)]] = res
                                done[(mname, i)] = res
                                self.stats.plan_broadcasts += 1
                        else:
                            self.stats.plan_fallback_points += len(rest)
                            for i in rest:
                                done[(mname, i)] = _point(i, m)
                for i in fallback:
                    if (mname, i) not in done:
                        self.stats.plan_fallback_points += 1
                        done[(mname, i)] = _point(i, m)
        return {mname: [done[(mname, i)] for i in range(npts)]
                for mname in model_names}
