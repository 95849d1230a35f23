"""AnalysisService: the analysis-as-a-service front (a copy of
``repro.service.service``).

Wraps pooled memoizing :class:`~repro_torch.core.session.AnalysisSession`s with
the three things a long-lived, concurrent model server needs on top of
per-process memoization:

1. a **disk tier** (:class:`~repro_torch.service.store.ResultStore`) so cold
   starts are warm fleet-wide — any process pointed at the same cache
   root serves results computed by any other;
2. **single-flight coalescing** — concurrent *identical* requests share
   one computation (followers block on the leader's future), while
   distinct requests proceed in parallel on their callers' threads or
   the batch pool;
3. batch APIs (:meth:`analyze_many` / :meth:`sweep_many`) and a sweep
   **worker pool** (:mod:`repro_torch.service.workers`) that shards dense
   grids across processes and back-fills the merged result into the
   shared store.

Results are identical on every path — memory hit, disk hit, coalesced
follower, worker-pool shard — because each is either the same object or
an exact ``to_dict``/``from_dict`` round trip of one (pinned by the
tests, which also hold every store key to the JAX package's: a store
either package filled serves the other).

Sessions are pooled per machine **fingerprint** (content hash), not per
name: two identical machine files share sessions and cache entries, and
an edited file gets fresh ones.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

from repro_torch.core import api as _api
from repro_torch.core import reports
from repro_torch.core.identity import freeze, kernel_key, source_key
from repro_torch.core.kernel_ir import LoopKernel
from repro_torch.core.machine import Machine
from repro_torch.core.model_api import Result, resolve_model
from repro_torch.core.session import AnalysisSession, SessionStats

from .store import ResultStore, decode_results, encode_results
from .workers import sweep_sharded


@dataclasses.dataclass
class ServiceStats:
    """Service-level counters; session-tier counters live in each pooled
    session's :class:`SessionStats` (see :meth:`AnalysisService.stats`)."""
    requests: int = 0               # analyze + sweep calls accepted
    memory_hits: int = 0            # served from the in-process result map
    disk_hits: int = 0              # served from the store, no model ran
    computed: int = 0               # leader actually ran the model stack
    coalesced: int = 0              # followers that shared a leader's run
    worker_batches: int = 0         # sweeps dispatched to the process pool

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hits"] = self.memory_hits + self.disk_hits
        return d


class _SingleFlight:
    """Per-key in-flight futures: the first caller becomes the leader and
    computes; concurrent callers with the same key get the same future."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: dict[tuple, Future] = {}

    def begin(self, key: tuple) -> tuple[Future, bool]:
        with self._lock:
            fut = self._inflight.get(key)
            if fut is not None:
                return fut, False
            fut = Future()
            self._inflight[key] = fut
            return fut, True

    def finish(self, key: tuple, fut: Future, result=None,
               exc: BaseException | None = None) -> None:
        with self._lock:
            self._inflight.pop(key, None)
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)


class AnalysisService:
    """Front a fleet of analyze/sweep requests with memory, disk, and
    coalescing tiers.

    ``cache_dir=None`` disables the disk tier (coalescing and pooled
    sessions still apply).  ``threads`` sizes the batch-API thread pool;
    plain :meth:`analyze`/:meth:`sweep` run on the caller's thread.
    """

    def __init__(self, cache_dir: str | None = None, threads: int = 8):
        self.store = ResultStore(cache_dir) if cache_dir else None
        self.stats = ServiceStats()
        self.threads = int(threads)
        self._stats_lock = threading.Lock()
        self._sessions: dict[str, AnalysisSession] = {}
        self._sessions_lock = threading.Lock()
        self._memory: dict[tuple, Any] = {}
        self._flight = _SingleFlight()
        self._pool: ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()

    # -- plumbing ------------------------------------------------------
    def session(self, machine: Machine | str) -> AnalysisSession:
        """The pooled session for ``machine``, keyed by content
        fingerprint (identical descriptions share caches regardless of
        path or name; edited ones never collide)."""
        m = _api.resolve_machine(machine)
        with self._sessions_lock:
            sess = self._sessions.get(m.fingerprint)
            if sess is None:
                sess = self._sessions[m.fingerprint] = AnalysisSession(m)
            return sess

    def session_stats(self) -> SessionStats:
        """Aggregated per-session counters across the machine pool."""
        total = SessionStats()
        with self._sessions_lock:
            sessions = list(self._sessions.values())
        for sess in sessions:
            total = total.add(sess.stats)
        return total

    def stats_dict(self) -> dict:
        """Everything ``--stats`` / ``cache stats`` reports: service,
        aggregated session, and store counters, plus the flat summary
        keys (hits / misses / disk_hits / coalesced)."""
        service = self.stats.to_dict()
        session = self.session_stats().to_dict()
        out = {"service": service, "session": session}
        if self.store is not None:
            out["store"] = self.store.stats.to_dict()
        out["summary"] = {
            "hits": service["memory_hits"] + session["hits"],
            "misses": session["misses"],
            "disk_hits": service["disk_hits"],
            "coalesced": service["coalesced"],
        }
        return out

    def _count(self, **deltas: int) -> None:
        with self._stats_lock:
            for name, d in deltas.items():
                setattr(self.stats, name, getattr(self.stats, name) + d)

    def _load(self, source, frontend, name, constants, element_bytes,
              frontend_opts):
        if isinstance(source, LoopKernel) and not (
                name or frontend_opts or element_bytes is not None):
            # common hot path: an already-built kernel (bind() is cheap)
            return source.bind(**(constants or {}))
        if callable(getattr(source, "cache_key", None)):
            return source                   # non-loop kernel object (HLO)
        return _api.load_kernel(source, constants, element_bytes,
                                frontend=frontend, name=name,
                                **(frontend_opts or {}))

    def _meta(self, kind: str, mach: Machine, kernel, model: str,
              predictor: str, incore: str) -> dict:
        return {"kind": kind, "model": str(model),
                "machine": mach.name, "machine_fingerprint": mach.fingerprint,
                "kernel": getattr(kernel, "name", type(kernel).__name__),
                "predictor": str(predictor).upper(),
                "incore": str(incore).lower()}

    def _analyze_key(self, kernel, mach: Machine, sess: AnalysisSession,
                     model: str, predictor: str, cores: int,
                     sim_kwargs: dict | None, incore: str,
                     opts: dict) -> tuple:
        m = resolve_model(model)
        if m.input_kind != "loop" or not isinstance(kernel, LoopKernel):
            # non-loop models never see predictor/incore/sim switches
            # (mismatched kernel/model pairs key loosely here and raise
            # in the session on the compute path)
            return ("analyze", m.name, source_key(kernel),
                    mach.fingerprint, freeze(opts))
        return ("analyze", m.name, kernel_key(kernel), mach.fingerprint,
                predictor.upper(), int(cores),
                sess.sim_key(predictor, sim_kwargs or {}),
                incore.lower(), freeze(opts))

    def _serve(self, key: tuple, compute, decode, encode_meta):
        """The shared three-tier request path: memory -> single-flight ->
        (disk -> compute).  ``compute`` runs the model stack and returns
        ``(value, payload, meta)``; ``decode`` rebuilds a value from a
        stored payload and returns it (or None to treat the entry as
        unusable and recompute)."""
        hit = self._memory.get(key)
        if hit is not None:
            self._count(memory_hits=1)
            return hit
        fut, leader = self._flight.begin(key)
        if not leader:
            self._count(coalesced=1)
            return fut.result()
        try:
            value = None
            if self.store is not None:
                payload = self.store.get(key)
                if payload is not None:
                    value = decode(payload)
                    if value is not None:
                        self._count(disk_hits=1)
            if value is None:
                value, payload, meta = compute()
                self._count(computed=1)
                if self.store is not None:
                    self.store.put(key, payload, meta=meta)
            self._memory[key] = value
        except BaseException as e:
            self._flight.finish(key, fut, exc=e)
            raise
        self._flight.finish(key, fut, result=value)
        return value

    def serve_custom(self, key: tuple, compute, decode, *,
                     meta: dict | None = None):
        """Serve an extension result kind through the same three tiers as
        ``analyze`` (memory -> single-flight -> disk -> compute).

        ``key`` must be a hashable, JSON-stable tuple whose first element
        names the kind (e.g. ``("fleet", ...)``); ``compute()`` returns
        ``(value, payload)`` where ``payload`` is the JSON-serializable
        form; ``decode(payload)`` rebuilds the value from a stored payload
        (return None to treat the entry as foreign/corrupt and recompute).
        The fleet analyzer serves whole-module reports through it (kind
        ``"fleet"``), so they share the warm disk cache across configs and
        processes, and the tuner stores its reports through it (kind
        ``"tune"``), so a warm replay decodes from disk without measuring
        again."""
        self._count(requests=1)

        def _compute():
            value, payload = compute()
            return value, payload, dict(meta or {})

        return self._serve(key, _compute, decode, None)

    def lint_report(self, kernel, mach: Machine, **request):
        """The store-backed lint pass behind ``analyze(..., lint=...)``:
        reports are cached like results (kind ``"lint"``), so a warm hit
        replays its diagnostics from disk without re-running a single
        rule."""
        from repro_torch.core import lint as lint_mod

        def run():
            return lint_mod.lint_request(
                kernel, mach,
                filename=getattr(kernel, "source_path", "")
                or getattr(kernel, "name", ""),
                **request)

        try:
            key = ("lint", source_key(kernel), mach.fingerprint,
                   freeze(request))
        except (TypeError, ValueError):
            return run()                    # unkeyable source: just run

        def decode(payload):
            try:
                return lint_mod.LintReport.from_dict(payload)
            except (KeyError, TypeError, ValueError):
                return None                 # foreign/corrupt -> recompute

        def compute():
            rep = run()
            meta = {"kind": "lint", "machine": mach.name,
                    "machine_fingerprint": mach.fingerprint,
                    "kernel": getattr(kernel, "name",
                                      type(kernel).__name__),
                    "errors": len(rep.errors),
                    "warnings": len(rep.warnings)}
            return rep, rep.to_dict(), meta

        return self._serve(key, compute, decode, None)

    def _lint_gate(self, kernel, mach: Machine, mode: str, **request):
        """Validate ``mode`` and produce the (possibly replayed) report;
        raises :class:`~repro_torch.core.lint.LintError` in error mode."""
        if mode not in _api.LINT_MODES:
            raise ValueError(
                f"unknown lint mode {mode!r}; expected one of "
                f"{list(_api.LINT_MODES)}")
        if mode == "off":
            return None
        report = self.lint_report(kernel, mach, **request)
        if mode == "error":
            report.raise_if_errors()
        return report

    # -- the request API -----------------------------------------------
    def analyze(self, source: Any, machine: Machine | str,
                model: str = "ecm", predictor: str = "LC", *,
                frontend: str | None = None, name: str | None = None,
                constants: dict | None = None, cores: int = 1,
                sim_kwargs: dict | None = None, incore: str = "simple",
                lint: str = "off", element_bytes: int | None = None,
                frontend_opts: dict | None = None, **opts) -> Result:
        """Serve one analysis request (same surface as
        :func:`repro_torch.core.api.analyze`).  Memory hits return the cached
        object in microseconds; disk hits deserialize the stored payload
        and seed the pooled session; misses compute, then publish.
        ``lint`` behaves as in the core API, except the report itself is
        served through the same three tiers (kind ``"lint"``)."""
        mach = _api.resolve_machine(machine)
        kernel = self._load(source, frontend, name, constants,
                            element_bytes, frontend_opts)
        report = self._lint_gate(kernel, mach, lint, model=model,
                                 predictor=predictor, incore=incore)
        sess = self.session(mach)
        key = self._analyze_key(kernel, mach, sess, model, predictor,
                                cores, sim_kwargs, incore, opts)
        self._count(requests=1)

        def decode(payload):
            res = reports.result_from_dict(payload)
            sess.seed_result(kernel, model, res, predictor=predictor,
                             cores=cores, sim_kwargs=sim_kwargs,
                             incore=incore, **opts)
            return res

        def compute():
            res = sess.analyze(kernel, model, predictor=predictor,
                               cores=cores, sim_kwargs=sim_kwargs,
                               incore=incore, **opts)
            return res, res.to_dict(), self._meta(
                "analyze", mach, kernel, model, predictor, incore)

        res = self._serve(key, compute, decode, None)
        if report is not None:
            from repro_torch.core.lint import LintedResult
            return LintedResult(res, report)
        return res

    def sweep(self, source: Any, machine: Machine | str, param,
              values=None, models=("ecm",), predictor: str = "LC", *,
              frontend: str | None = None, name: str | None = None,
              constants: dict | None = None, cores=1,
              sim_kwargs: dict | None = None, incore: str = "simple",
              lint: str = "off", element_bytes: int | None = None,
              frontend_opts: dict | None = None,
              compiled: bool | str = "auto", workers: int = 0,
              **opts) -> dict[str, list[Result]]:
        """Serve a whole sweep as one cacheable request.

        ``param``/``values``/``cores`` follow
        :func:`repro_torch.core.api.sweep` — a ``{symbol: values}``
        mapping and/or a cores sequence describe
        an N-D grid, keyed by the frozen axis spec (1-D requests keep
        their original key shape, so existing disk entries stay warm).
        The disk entry stores deduplicated per-regime payloads, so a warm
        1000-point sweep costs one file read plus a handful of
        ``from_dict`` calls.  ``workers > 1`` shards a cold sweep across
        the process pool (:func:`~repro_torch.service.workers.sweep_sharded`)
        and back-fills the merged result into the store.  Neither
        ``compiled`` nor ``workers`` enters the cache key: both engines
        are bit-for-bit identical to the per-point path, so all spellings
        share entries.
        """
        mach = _api.resolve_machine(machine)
        kernel = self._load(source, frontend, name, constants,
                            element_bytes, frontend_opts)
        model_names = [str(m) for m in models]
        nd_param = isinstance(param, dict)
        cores_axis = AnalysisSession._cores_axis(cores)
        report = self._lint_gate(kernel, mach, lint, models=model_names,
                                 predictor=predictor, incore=incore,
                                 compiled=compiled,
                                 sweep_params=(list(param) if nd_param
                                               else [str(param)]),
                                 cores_axis=cores_axis is not None)
        sess = self.session(mach)
        if nd_param:
            param = {str(s): list(vs) for s, vs in param.items()}
            npoints = 1
            for vs in param.values():
                npoints *= max(len(vs), 1)
        else:
            values = list(values)
            npoints = len(values)
        if cores_axis is not None:
            cores = cores_axis
            npoints *= max(len(cores_axis), 1)
        key = ("sweep", tuple(resolve_model(m).name for m in model_names),
               source_key(kernel), mach.fingerprint,
               freeze(param) if nd_param else str(param),
               freeze(values), predictor.upper(),
               freeze(tuple(cores_axis)) if cores_axis is not None
               else int(cores),
               sess.sim_key(predictor, sim_kwargs or {}), incore.lower(),
               freeze(opts))
        self._count(requests=1)

        def decode(payload):
            shared: dict[str, Any] = {}
            try:
                return {m: decode_results(payload["models"][m],
                                          shared=shared)
                        for m in model_names}
            except (KeyError, IndexError, TypeError, ValueError):
                return None                 # foreign/corrupt -> recompute

        def compute():
            if workers and workers > 1 and npoints > 1:
                self._count(worker_batches=1)
                out = sweep_sharded(
                    kernel, mach, param, values, models=model_names,
                    predictor=predictor, cores=cores,
                    sim_kwargs=sim_kwargs, incore=incore,
                    compiled=compiled, workers=workers, opts=opts)
            else:
                out = sess.sweep(kernel, param, values, models=model_names,
                                 predictor=predictor, cores=cores,
                                 sim_kwargs=sim_kwargs, incore=incore,
                                 compiled=compiled, **opts)
            payload = {"models": {m: encode_results(rs)
                                  for m, rs in out.items()}}
            meta = self._meta("sweep", mach, kernel,
                              ",".join(model_names), predictor, incore)
            meta["param"] = ("x".join(param) if nd_param else str(param)) \
                + ("xcores" if cores_axis is not None else "")
            meta["points"] = npoints
            return out, payload, meta

        out = self._serve(key, compute, decode, None)
        return _api._attach_report(out, report)

    # -- batch APIs ----------------------------------------------------
    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.threads,
                    thread_name_prefix="repro-service")
            return self._pool

    def _many(self, fn, requests) -> list:
        reqs = [dict(r) for r in requests]
        if len(reqs) <= 1:
            return [fn(**r) for r in reqs]
        pool = self._ensure_pool()
        return [f.result() for f in [pool.submit(fn, **r) for r in reqs]]

    def analyze_many(self, requests) -> list[Result]:
        """Serve many analyze requests concurrently (order-preserving).

        Each request is a kwargs dict for :meth:`analyze`; identical
        in-flight requests coalesce onto one computation, distinct ones
        run in parallel on the service thread pool."""
        return self._many(self.analyze, requests)

    def sweep_many(self, requests) -> list[dict[str, list[Result]]]:
        """Serve many sweep requests concurrently (kwargs dicts for
        :meth:`sweep`, order-preserving)."""
        return self._many(self.sweep, requests)

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def __enter__(self) -> "AnalysisService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ----------------------------------------------------------------------
# Queue facade in the shape of repro_torch.serve.engine.BatchedServer:
# submit/drain over AnalysisRequest records, for drivers that want the
# queued shape instead of the call-through API.
# ----------------------------------------------------------------------

@dataclasses.dataclass
class AnalysisRequest:
    """One queued request: ``kind`` selects analyze/sweep, ``request`` is
    the kwargs dict for the corresponding :class:`AnalysisService`
    method.  Mirrors :class:`repro_torch.serve.engine.Request`."""
    uid: int
    kind: str = "analyze"                   # "analyze" | "sweep"
    request: dict = dataclasses.field(default_factory=dict)
    result: Any = None
    error: str | None = None
    done: bool = False


class AnalysisServer:
    """Request-queue driver over an :class:`AnalysisService` (the
    :class:`~repro_torch.serve.engine.BatchedServer` shape for analysis
    traffic): queued requests drain in batches through the service's
    thread pool, duplicates coalescing onto one computation."""

    def __init__(self, service: AnalysisService, batch_size: int = 32):
        self.service = service
        self.batch_size = int(batch_size)
        self._queue: queue.Queue[AnalysisRequest] = queue.Queue()
        self._served: list[int] = []        # batch sizes actually used

    def submit(self, req: AnalysisRequest) -> None:
        if req.kind not in ("analyze", "sweep"):
            raise ValueError(
                f"unknown request kind {req.kind!r}; "
                "expected 'analyze' or 'sweep'")
        self._queue.put(req)

    def drain(self) -> list[AnalysisRequest]:
        """Serve everything currently queued; returns completed requests
        (failures recorded on ``req.error``, never raised)."""
        done: list[AnalysisRequest] = []
        while not self._queue.empty():
            bucket: list[AnalysisRequest] = []
            while (len(bucket) < self.batch_size
                   and not self._queue.empty()):
                try:
                    bucket.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            if not bucket:
                break
            pool = self.service._ensure_pool()
            futs = [pool.submit(self.service.analyze
                                if r.kind == "analyze"
                                else self.service.sweep, **r.request)
                    for r in bucket]
            self._served.append(len(bucket))
            for req, fut in zip(bucket, futs):
                try:
                    req.result = fut.result()
                except Exception as e:      # noqa: BLE001 - served back
                    req.error = f"{type(e).__name__}: {e}"
                req.done = True
                done.append(req)
        return done
