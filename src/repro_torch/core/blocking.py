"""Blocking-factor prediction — layer conditions inverted (paper §2.3
'Layer Conditions' + §2.4.2) — and the CTA tile advisors for the port's
Hopper kernels.

The analytic half is a copy of ``repro.core.blocking``'s:
:func:`lc_block_size` solves ``C_req <= C`` for the largest inner size at
which the strongest layer condition holds (the paper's "optimal spatial
blocking factor", N = 546 for the long-range stencil in the L3 of the
paper's Ivy Bridge), :func:`blocking_sweep` evaluates models across such
factors, and :func:`grid_search` scores a dense 1-D/2-D grid (optionally
with a cores axis) through one compiled sweep plan; the autotuner's
stencil spaces rank through it.

The advisors are the GPU counterparts of the JAX package's TPU ones: the
2.5-D blocked stencils (``stencil_blocks``) and flash attention
(:func:`attention_cta_tiles`, the counterpart of ``attention_tiles``, at
the end of this module).

On the TPU the advisor sizes a 3-D block whose haloed working set fits
VMEM.  On the H100 a CTA owns a ``(bj, bi)`` tile of a chunk of
``chunk`` output planes and marches k through it, the planes coming in
by asynchronous copies into a ring of ``stages`` planes in shared memory
(``csrc/stencil_ring.cuh``); each thread owns ``c`` consecutive rows of
one column.  So the choice is a launch plan under the kernels' limits
(``repro_<kernel>_limits`` in ``csrc/*.cu`` states the same rule):

* ``stages`` haloed tiles ``(bj + 2r) x (bi + 2r)``, ``stages - r``
  stages of ``own`` bare ``bj x bi`` tiles (the long-range kernel's u and
  roc) and a table of the haloed tile's offsets fit the per-CTA budget
  (227 KiB); ``stages - r - 2`` planes are in flight while a step waits,
  1 to :data:`MAX_AHEAD`;
* ``bi`` is a whole number of 32-thread warps (128 B of fp32, one line);
  ``c`` is one of the instantiated :data:`POINTS` and divides ``bj``;
* ``bj >= r``;
* the CTA has ``bi * bj / c`` threads, at most :data:`THREADS`.

``stages`` comes from Little's law: the fewest stages whose planes in
flight hold :data:`IN_FLIGHT_PER_SM` bytes per SM, counting the CTAs an SM
holds (by shared memory and threads, and no more than the grid gives it).
``chunk`` splits k where the tiles alone leave resident CTA slots empty,
but never below :data:`CHUNK_PER_RADIUS` ``* r`` planes, so the ``2r``
planes each chunk loads again cost at most an eighth more.  Each thread
owns :data:`POINTS_PER_THREAD` rows.  Among tiles it picks the one that
fetches the fewest words per output point (the halo the L2 serves again
and the planes chunks load twice) divided by how evenly the CTAs load the
SMs; ties prefer the wider tile.

The constants are the plan sweeps' (``python -m repro_torch.tune.sweep``
on the H100, PERF.md §6): at both main-path shapes 4 points per
thread beat 1, 2 and 8 (8 halves the warps an SM holds, 1 and 2 repeat
the copy and address work per point), 512-thread CTAs beat 256-thread
ones by 1–2%, and the 7-point grid at 512^3 ran 1.37x faster in chunks of
64 planes (1024 CTAs) than marching all of k (128 CTAs, 16 warps per SM).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import numpy as np

from ..kernels import flash_attention as fa
from . import layer_conditions
from .compiled import CompileError, meshgrid_points
from .kernel_ir import LoopKernel
from .machine import Machine
from .model_api import resolve_model
from .predictors import resolve_predictor
from .session import AnalysisSession


# ----------------------------------------------------------------------
# Layer conditions inverted: blocking factors and dense grid search
# (copies of repro.core.blocking's analytic half)
# ----------------------------------------------------------------------

#: ``blocking_sweep``'s fallback value when no level gives a finite
#: blocking factor and the symbol is unbound (the JAX package's, 128)
_FALLBACK = 128


def lc_block_size(kernel: LoopKernel, cache_bytes: float, symbol: str = "N",
                  safety: float = 0.5) -> float:
    """Largest inner size for which the *strongest* layer condition holds in
    a cache of ``cache_bytes`` (times ``safety``). This is the paper's
    'optimal spatial blocking factor' — e.g. blocking the long-range stencil
    for L3 keeps the 3D condition alive past N = 546.

    When the strongest condition holds for *every* size, no blocking is
    needed: the kernel's bound extent for ``symbol`` is returned when one
    exists, else ``math.inf`` — so downstream searches see a real upper
    bound instead of a sentinel block size.
    """
    trans = layer_conditions.transition_points(kernel, cache_bytes * safety, symbol)
    # strongest condition first (largest reuse-distance threshold); fall back
    # to weaker conditions if the strongest never holds for positive sizes
    for tr in reversed(trans):
        if tr.max_value == math.inf:
            # condition holds unconditionally — the loop's actual extent
            # (when bound) is the honest "block size", else unbounded
            bound = kernel.constants.get(symbol)
            return int(bound) if bound is not None else math.inf
        if tr.max_value > 1:
            return int(tr.max_value)
    return 0


def blocking_sweep(kernel: LoopKernel, machine: Machine, symbol: str = "N",
                   values=None, models=("ecm",),
                   session: AnalysisSession | None = None,
                   safety: float = 0.5, grid=None, **opts):
    """Evaluate registered models across candidate blocking factors.

    Candidates default to the per-level LC blocking factors (and their
    halves) from :func:`lc_block_size`; pass ``grid=(start, stop, step)``
    for a dense inclusive range instead — the session routes it through
    the compiled sweep plan, so dense grids cost a handful of symbolic
    evaluations (one per LC regime) rather than one per point.  All points
    run through one :class:`AnalysisSession`, so the models share predictor
    volumes; pass a ``session`` (bound to the same ``machine``) to make
    repeated sweeps — e.g. while tuning ``safety`` — cache hits across
    calls too.

    Returns ``(values, {model: [result per value]})``.
    """
    if session is not None and session.machine.name != machine.name:
        raise ValueError(
            f"session is bound to machine {session.machine.name!r}, "
            f"but blocking_sweep was given {machine.name!r}")
    sess = session or AnalysisSession(machine)
    if grid is not None:
        if values is not None:
            raise ValueError("pass either values= or grid=, not both")
        start, stop, step = (int(x) for x in grid)
        values = range(start, stop + 1, step)        # STOP inclusive
    if values is None:
        cands: set[int] = set()
        for lv in machine.levels:
            b = lc_block_size(kernel, lv.size_bytes, symbol, safety=safety)
            if 0 < b and math.isfinite(b):
                cands.add(int(b))
                cands.add(max(1, int(b) // 2))
        values = sorted(cands) or [int(kernel.constants.get(symbol,
                                                          _FALLBACK))]
    values = list(values)       # materialize: generators must survive sweep
    results = sess.sweep(kernel, symbol, values, models=models, **opts)
    return values, results


# ----------------------------------------------------------------------
# Dense grid search over the compiled analytic plan
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GridSearchResult:
    """Outcome of a dense 1D/2D blocking-factor search.

    ``scores`` holds the vectorized metric over the full grid — cycles per
    unit of work for ECM (lower is better), flop/s for Roofline variants
    (higher is better) — with shape ``(len(grids[0]),)`` or
    ``(len(grids[0]), len(grids[1]))``.  ``best_result`` is the exact
    symbolic-path result at the winning point.  ``ranking`` lists every
    grid point best-first as ``({symbol: value}, score)`` pairs, with ties
    resolved exactly like ``best`` (largest tied point wins) — the
    autotuner (:mod:`repro_torch.tune`) consumes this to pick its measurement
    shortlist, so ``ranking[0]`` always equals ``(best, best_score)``.

    A search with a **cores axis** (``grid_search(..., cores=[...])``)
    appends that axis (innermost) to ``scores``, maximizes saturated
    performance ``min(single·n, sat)`` per point, and fills the
    multicore fields: ``cores_grid`` (the axis), ``best_cores`` (core
    count of the winning point), ``n_sat`` (the batched saturation-point
    array over the full grid), ``best_per_cores`` (the winning block per
    core count), and ``sweet_spot`` (the fewest cores at which the
    winning block already hits its peak score — the saturation knee n_sat
    clipped to the grid).  All default empty so 1-D/2-D payloads stay
    byte-identical to before.
    """
    model: str
    metric: str   # 'cy_per_unit' (min) | 'flops'/'flops_at_cores' (max)
    symbols: tuple[str, ...]
    grids: tuple[tuple[int, ...], ...]
    scores: np.ndarray
    best: dict[str, int]
    best_score: float
    best_result: object
    ranking: tuple = ()    # ((params, score), ...) best-first
    cores_grid: tuple = ()
    best_cores: int | None = None
    n_sat: object = None   # np.ndarray over the grid, or None
    best_per_cores: tuple = ()   # ({cores, best, score, n_sat}, ...)
    sweet_spot: dict | None = None

    def to_dict(self) -> dict:
        out = {"model": self.model, "metric": self.metric,
               "symbols": list(self.symbols),
               "grids": [list(g) for g in self.grids],
               "scores": self.scores.tolist(),
               "best": dict(self.best), "best_score": self.best_score,
               "best_result": self.best_result.to_dict(),
               "ranking": [[dict(p), s] for p, s in self.ranking]}
        if self.cores_grid:
            out["cores_grid"] = list(self.cores_grid)
            out["best_cores"] = self.best_cores
            out["n_sat"] = (self.n_sat.tolist()
                            if self.n_sat is not None else None)
            out["best_per_cores"] = [dict(e) for e in self.best_per_cores]
            out["sweet_spot"] = (dict(self.sweet_spot)
                                 if self.sweet_spot else None)
        return out


def _resolve_metric(model: str, metric) -> tuple[str, str]:
    """Normalize the ``metric=`` switch into ``(kind, score_model)``:
    ``kind`` picks the vectorized scorer ('ecm' minimizes t_ecm,
    'roofline' maximizes flop/s, 'custom' minimizes a callable's output)
    and ``score_model`` the registered model used for exact-path fallback
    points.  ``metric=None`` keeps the historical behavior: the scorer is
    inferred from ``model``."""
    mname = resolve_model(model).name
    if metric is None:
        kind = "roofline" if mname.startswith("roofline") else "ecm"
    elif callable(metric):
        kind = "custom"
    elif str(metric) in ("ecm", "roofline"):
        kind = str(metric)
    else:
        raise ValueError(
            f"unknown grid_search metric {metric!r}; expected 'ecm', "
            "'roofline', or a callable over the compiled term arrays")
    if kind == "roofline":
        score_model = mname if mname.startswith("roofline") \
            else "roofline-iaca"
    else:
        score_model = "ecm"
    return kind, score_model


def _metric_grid(sess: AnalysisSession, kernel: LoopKernel, specs,
                 predictor: str, cores, cores_axis, opts: dict,
                 metric, kind: str, score_model: str):
    """Vectorized metric over the whole (specs × cores) grid through ONE
    compiled N-D plan; points whose ordering the plan cannot batch are
    scored through the exact path.  Returns ``(scores, n_sat)`` shaped
    ``(*len(grid axes)[, len(cores_axis)])`` — ``n_sat`` is ``None``
    unless a cores axis is present."""
    syms = tuple(s for s, _ in specs)
    axes = {s: vs for s, vs in specs}
    if len(syms) == 1 and cores_axis is None:
        # keep the historical plan-cache key so 1-D searches share plans
        # with equally-shaped AnalysisSession.sweep calls
        plan = sess.sweep_plan(kernel, syms[0], cores, opts.get("incore"))
    else:
        plan = sess.sweep_plan(kernel, syms, None, opts.get("incore"))
    coords, cores_arr, shape = meshgrid_points(
        axes, cores=cores_axis if cores_axis is not None else int(cores))
    npts = coords[syms[0]].size
    n_sat = None
    if kind == "roofline":
        variant = getattr(resolve_model(score_model), "variant", "IACA")
        terms = plan.roofline_terms(coords, variant=variant,
                                    cores=cores_arr)
        scores = np.asarray(terms["performance"], dtype=np.float64)
    else:
        terms = plan.ecm_terms(coords, cores=cores_arr)
        if kind == "custom":
            scores = np.asarray(metric(terms), dtype=np.float64)
            if scores.shape != (npts,):
                raise ValueError(
                    "callable grid_search metric must map the compiled "
                    f"term arrays to one score per point; got shape "
                    f"{scores.shape} for {npts} points")
        elif cores_axis is not None:
            scores = np.asarray(terms["performance_at_cores"],
                                dtype=np.float64)
            n_sat = terms["n_sat"].copy()
        else:
            scores = np.asarray(terms["t_ecm"], dtype=np.float64)
    valid = terms["valid"]
    scores = scores.copy()
    for i in np.flatnonzero(~valid):
        binding = {s: int(coords[s][i]) for s in syms}
        c_i = int(cores_arr[i]) if np.ndim(cores_arr) else int(cores_arr)
        res = sess.analyze(kernel.bind(**binding), score_model,
                           predictor=predictor, cores=c_i, **opts)
        # custom metrics only see compiled term arrays; points outside the
        # plan's validity fall back to the exact t_ecm, like 'ecm'
        if kind == "roofline":
            scores[i] = res.performance
        elif cores_axis is not None:
            scores[i] = res.performance_flops(c_i)
            n_sat[i] = res.saturation_cores
        else:
            scores[i] = res.t_ecm
    return (scores.reshape(shape),
            n_sat.reshape(shape) if n_sat is not None else None)


def grid_search(kernel: LoopKernel, machine: Machine, specs,
                model: str = "ecm", predictor: str = "LC", cores=1,
                session: AnalysisSession | None = None, metric=None,
                **opts) -> GridSearchResult:
    """Ab-initio blocking-factor search over a dense 1D/2D parameter grid.

    ``specs`` is one or two ``(symbol, values)`` pairs, e.g.
    ``[("N", range(64, 1025, 8))]`` or 2D ``[("M", ...), ("N", ...)]``.
    The whole grid is scored through ONE compiled N-D plan's vectorized
    closed forms (ECM cycles per unit, or Roofline flop/s): points are
    grouped by LC regime cell, so the cost is ``O(regime cells)``
    symbolic evaluations instead of ``O(grid points)``.  The winning
    point is re-evaluated through the exact symbolic path and returned
    as ``best_result``.

    ``cores`` is either a scalar (the historical behavior: every point
    scored at that core count) or a sequence — a third, innermost grid
    axis.  A cores axis ranks the chip-level ECM saturation closed form
    ``min(single·n, sat)`` (maximized; metric ``'flops_at_cores'``) and
    fills the multicore report fields: the batched ``n_sat`` array per
    candidate, ``best_per_cores``, and the n_sat-aware ``sweet_spot``
    (the fewest cores at which the winning block already saturates).
    Saturation is an ECM concept, so a cores axis rejects Roofline and
    custom metrics.

    ``metric`` decouples the score from ``model``: ``"ecm"`` minimizes
    t_ecm, ``"roofline"`` maximizes flop/s, and a callable receives the
    compiled ECM term arrays (:meth:`~repro_torch.core.compiled
    .CompiledSweepPlan.ecm_terms` — ``t_ecm``, ``t_data``, per-level
    contributions, all vectorized over the grid) and returns one score
    per point, minimized.  The default ``None`` infers the metric from
    ``model`` (the historical behavior, pinned by tests).  The full
    ranked list is returned as ``GridSearchResult.ranking``.

    Only analytic predictors can be scored this way: a ``predictor``
    without a compiled closed form (SIM) raises
    :class:`~repro_torch.core.compiled.CompileError` rather than silently
    answering with layer conditions.
    """
    specs = [(str(s), [int(v) for v in vs]) for s, vs in specs]
    if not 1 <= len(specs) <= 2:
        raise ValueError("grid_search takes one or two (symbol, values) "
                         f"specs, got {len(specs)}")
    if resolve_model(model).input_kind != "loop":
        raise ValueError(f"grid_search needs a loop model, not {model!r}")
    if not resolve_predictor(predictor).supports_compiled:
        raise CompileError(
            "grid_search scores the grid through the compiled analytic "
            f"plan, but predictor {predictor!r} has no analytic closed "
            "form to compile")
    if opts.get("calibrated"):
        raise ValueError(
            "grid_search scores grids through the uncalibrated compiled "
            "plan; apply machine calibration downstream (repro_torch.tune) "
            "instead of passing calibrated=True here")
    for sym, vs in specs:
        if not vs:
            raise ValueError(f"empty grid for symbol {sym!r}")
    if session is not None and session.machine.name != machine.name:
        raise ValueError(
            f"session is bound to machine {session.machine.name!r}, "
            f"but grid_search was given {machine.name!r}")
    kind, score_model = _resolve_metric(model, metric)
    cores_axis = AnalysisSession._cores_axis(cores)
    if cores_axis is not None:
        if not cores_axis:
            raise ValueError("empty cores axis")
        if any(c < 1 for c in cores_axis):
            raise ValueError(f"core counts must be >= 1, got {cores_axis!r}")
        if kind != "ecm":
            raise ValueError(
                "a cores axis ranks the chip-level ECM saturation closed "
                "form min(single*n, sat); Roofline and custom metrics "
                f"have no saturation model (got metric kind {kind!r})")
    sess = session or AnalysisSession(
        machine, cores=1 if cores_axis is not None else cores)
    maximize = kind == "roofline" or cores_axis is not None

    # LC metrics are piecewise-constant, so whole regimes tie; prefer the
    # *largest* tied grid point — bigger blocks amortize the halo and loop
    # overheads the analytic model does not see.
    def _best_flat(scores: np.ndarray) -> int:
        target = scores.max() if maximize else scores.min()
        return int(np.flatnonzero(scores.ravel() == target).max())

    scores, n_sat = _metric_grid(sess, kernel, specs, predictor, cores,
                                 cores_axis, opts, metric, kind,
                                 score_model)
    idx = np.unravel_index(_best_flat(scores), scores.shape)
    best = {sym: vs[i] for (sym, vs), i in zip(specs, idx)}
    best_cores = cores_axis[idx[-1]] if cores_axis is not None else None
    dims = [vs for _, vs in specs]
    if cores_axis is not None:
        dims.append(cores_axis)
    params = []
    for combo in itertools.product(*dims):
        p = {sym: v for (sym, _), v in zip(specs, combo)}
        if cores_axis is not None:
            p["cores"] = combo[-1]
        params.append(p)
    # full ranking, best-first; within a tied score the larger flat index
    # wins, matching _best_flat — so ranking[0] == (best, best_score)
    flat = scores.ravel()
    sign = -1.0 if maximize else 1.0
    order = np.lexsort((-np.arange(flat.size), sign * flat))
    ranking = tuple((params[int(k)], float(flat[int(k)])) for k in order)
    best_score = float(scores[idx])
    best_result = sess.analyze(
        kernel.bind(**best), model, predictor=predictor,
        cores=best_cores if cores_axis is not None else cores, **opts)
    best_per_cores: tuple = ()
    sweet_spot = None
    if cores_axis is not None:
        bpc = []
        for ci, c in enumerate(cores_axis):
            sub = scores[..., ci]
            k = np.unravel_index(
                int(np.flatnonzero(sub.ravel() == sub.max()).max()),
                sub.shape)
            entry = {"cores": int(c),
                     "best": {sym: vs[i]
                              for (sym, vs), i in zip(specs, k)},
                     "score": float(sub[k]),
                     "n_sat": int(n_sat[k + (ci,)])}
            bpc.append(entry)
        best_per_cores = tuple(bpc)
        # the winning block saturates at its n_sat: the fewest cores on
        # the grid that already reach the block's peak score
        row = scores[idx[:-1]]
        peak = float(row.max())
        ci = int(np.flatnonzero(row == peak).min())
        sweet_spot = {"best": dict(best), "cores": int(cores_axis[ci]),
                      "score": peak,
                      "n_sat": int(n_sat[idx[:-1] + (ci,)])}
    return GridSearchResult(
        model=resolve_model(model).name,
        metric=("custom" if kind == "custom"
                else "flops_at_cores" if cores_axis is not None
                else "flops" if maximize else "cy_per_unit"),
        symbols=tuple(s for s, _ in specs),
        grids=tuple(tuple(vs) for _, vs in specs),
        scores=scores, best=best, best_score=best_score,
        best_result=best_result, ranking=ranking,
        cores_grid=tuple(cores_axis) if cores_axis is not None else (),
        best_cores=best_cores, n_sat=n_sat,
        best_per_cores=best_per_cores, sweet_spot=sweet_spot)


# ----------------------------------------------------------------------
# The Hopper launch plans
# ----------------------------------------------------------------------

WARP = 32
ELEM_BYTES = 4                    # the kernels run float32 only
SMEM_PER_CTA = fa.SMEM_PER_CTA    # 227 KiB, the H100's opt-in maximum
SMEM_PER_SM = fa.SMEM_PER_SM      # 228 KiB, SMEM_RESERVED more per CTA
SMEM_RESERVED = fa.SMEM_RESERVED
THREADS_PER_SM = fa.THREADS_PER_SM
CTAS_PER_SM = fa.CTAS_PER_SM
SM_COUNT = 132
THREADS = 512                     # per CTA, the kernels' __launch_bounds__
POINTS = (1, 2, 4, 8)             # points per thread the kernels instantiate
POINTS_PER_THREAD = 4             # the advisor's
MAX_AHEAD = 8                     # planes in flight, at most
#: bytes in flight per SM that the stages are sized for: ~0.7 us of loaded
#: latency at 3.35 TB/s over 132 SMs is ~18 KB (Little's law); a step's
#: copies land together, so twice that
IN_FLIGHT_PER_SM = 36 * 1024
CHUNK_PER_RADIUS = 16             # output planes per chunk, at least, per r



@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """One launch of a ring stencil kernel."""
    bj: int
    bi: int
    c: int                        # points (rows) per thread
    stages: int
    chunk: int                    # output planes per CTA
    halo: int
    own: int                      # bare tiles per plane
    stage_bytes: int              # one plane: haloed tile and bare tiles
    smem_bytes: int               # per CTA
    ctas: int                     # in the grid
    ctas_per_sm: int              # resident, as the grid fills the card
    words_per_point: float        # words fetched per output point

    @property
    def threads(self) -> int:
        return self.bi * self.bj // self.c

    @property
    def ahead(self) -> int:
        """Planes in flight while a step waits."""
        return self.stages - self.halo - 2

    @property
    def in_flight_per_sm(self) -> int:
        return self.ctas_per_sm * self.ahead * self.stage_bytes

    @property
    def launch(self) -> tuple[int, int, int, int, int]:
        """What the wrappers take as ``tile``: ``(bj, bi, c, stages,
        chunk)``."""
        return self.bj, self.bi, self.c, self.stages, self.chunk


def stage_bytes(radius: int, bj: int, bi: int, own: int = 0) -> int:
    return ELEM_BYTES * ((bj + 2 * radius) * (bi + 2 * radius)
                         + own * bj * bi)


def plan_limits(radius: int, own: int, bj: int, bi: int, c: int,
                stages: int) -> tuple[int, int]:
    """(shared bytes, threads) of one CTA of the plan, as
    ``repro_<kernel>_limits`` states them; raises ``ValueError`` for a
    plan the kernel cannot take."""
    threads = bi * (bj // c) if c > 0 else 0
    ahead = stages - radius - 2
    haloed = (bj + 2 * radius) * (bi + 2 * radius)
    smem = ELEM_BYTES * (stages * haloed + (stages - radius) * own * bj * bi
                         + haloed)
    if (c not in POINTS or bi < WARP or bi % WARP or bj < max(1, radius)
            or bj % c or threads > THREADS or not 1 <= ahead <= MAX_AHEAD
            or smem > SMEM_PER_CTA):
        raise ValueError(
            f"CTA tile (bj={bj}, bi={bi}, c={c}, stages={stages}) needs bi a "
            f"multiple of {WARP}, bj >= {max(1, radius)} and a multiple of c "
            f"in {POINTS}, bi*bj/c <= {THREADS} threads, "
            f"{radius + 3} <= stages <= {radius + 2 + MAX_AHEAD} and "
            f"{smem} B <= {SMEM_PER_CTA} B of shared memory")
    return smem, threads


def check_launch(tile, radius: int, own: int = 0) -> tuple[int, ...]:
    """The numbers ``(bj, bi, c, stages, chunk)`` of a launch plan given as
    numbers or as a :class:`StencilPlan`, once :func:`plan_limits` accepts
    its CTA; raises ``ValueError`` otherwise."""
    tile = tuple(int(x) for x in (tile.launch if isinstance(tile, StencilPlan)
                                  else tile))
    if len(tile) != 5:
        raise ValueError(f"CTA tile {tile}: a launch plan is (bj, bi, c, "
                         "stages, chunk)")
    plan_limits(radius, own, *tile[:4])
    return tile


def _fit(smem: int, threads: int) -> int:
    """CTAs one SM holds by shared memory and threads."""
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED),
               THREADS_PER_SM // threads, CTAS_PER_SM)


def _chunk(radius: int, M: int, tiles: int, fit: int) -> int:
    """Output planes per CTA: the whole of k, unless the tiles leave
    resident slots empty and k is long enough to split."""
    most = max(1, M // (CHUNK_PER_RADIUS * max(1, radius)))
    chunks = min(most, max(1, math.ceil(fit * SM_COUNT / tiles)))
    return math.ceil(M / chunks)


def make_plan(radius: int, shape: tuple[int, int, int], bj: int, bi: int,
              c: int, stages: int, chunk: int | None = None,
              own: int = 0) -> StencilPlan:
    """The plan ``(bj, bi, c, stages, chunk)`` on ``shape`` with its
    derived fields (``chunk`` None: the advisor's); raises ``ValueError``
    when the kernel cannot take it."""
    smem, threads = plan_limits(radius, own, bj, bi, c, stages)
    M, J, I = shape
    tiles = math.ceil(I / bi) * math.ceil(J / bj)
    fit = _fit(smem, threads)
    if chunk is None:
        chunk = _chunk(radius, M, tiles, fit)
    if chunk < 1:
        raise ValueError(f"CTA tile chunk={chunk}: a chunk holds at least "
                         "one output plane")
    chunk = min(chunk, M)
    chunks = math.ceil(M / chunk)
    loaded = sum(min(M, (z + 1) * chunk + radius) - max(0, z * chunk - radius)
                 for z in range(chunks))
    sb = stage_bytes(radius, bj, bi, own)
    ctas = tiles * chunks
    return StencilPlan(bj=bj, bi=bi, c=c, stages=stages, chunk=chunk,
                       halo=radius, own=own, stage_bytes=sb, smem_bytes=smem,
                       ctas=ctas,
                       ctas_per_sm=max(1, min(fit, math.ceil(ctas / SM_COUNT))),
                       words_per_point=sb / ELEM_BYTES / (bj * bi) * loaded / M)


def ring_plan(radius: int, shape: tuple[int, int, int], bj: int, bi: int,
              c: int, own: int = 0, chunk: int | None = None
              ) -> StencilPlan | None:
    """The plan of tile ``(bj, bi)`` at ``c`` points per thread with the
    fewest stages whose planes in flight hold :data:`IN_FLIGHT_PER_SM`
    bytes per SM (else the most in flight that fits); None when no stage
    count fits."""
    plan = None
    for stages in range(radius + 3, radius + 3 + MAX_AHEAD):
        try:
            p = make_plan(radius, shape, bj, bi, c, stages, chunk, own)
        except ValueError:
            break                     # more stages only need more memory
        if plan is None or p.in_flight_per_sm > plan.in_flight_per_sm:
            plan = p
        if p.in_flight_per_sm >= IN_FLIGHT_PER_SM:
            break
    return plan


def _fill(plan: StencilPlan) -> float:
    """How evenly the grid's CTAs load the SMs: their count over the SMs
    times the most any SM runs."""
    return plan.ctas / (SM_COUNT * math.ceil(plan.ctas / SM_COUNT))


@functools.lru_cache(maxsize=256)      # called on every launch; ints only
def stencil_cta_tile(radius: int, shape: tuple[int, int, int],
                     own: int = 0) -> StencilPlan:
    """The launch plan for a radius-``radius`` float32 star stencil over
    an ``(M, N, N)`` grid whose planes carry ``own`` bare tiles besides
    the haloed one.  Raises ``ValueError`` when no plan satisfies the
    limits (a halo whose fewest stages overflow the shared memory)."""
    if radius < 0:
        raise ValueError(f"radius must be non-negative, got {radius}")
    if len(shape) != 3 or min(shape) <= 0:
        raise ValueError(f"shape must be a positive (M, N, N), got {shape}")
    _, J, I = shape
    c = POINTS_PER_THREAD
    best, best_key = None, None
    for bi in range(WARP, min(THREADS, math.ceil(I / WARP) * WARP) + 1, WARP):
        for rows in range(1, THREADS // bi + 1):
            bj = c * rows
            if bj < max(1, radius):
                continue
            if bj > max(J, radius) + c - 1:
                break                 # taller tiles only idle more threads
            plan = ring_plan(radius, shape, bj, bi, c, own)
            if plan is None:
                continue
            key = (plan.words_per_point / _fill(plan), -bi)
            if best_key is None or key < best_key:
                best, best_key = plan, key
    if best is None:
        raise ValueError(
            f"no legal CTA tile for radius {radius} on {shape}: even "
            f"{radius + 3} stages of the smallest haloed tile exceed "
            f"{SMEM_PER_CTA} B of shared memory")
    return best


@dataclasses.dataclass(frozen=True)
class AttentionCTATiles:
    bq: int
    bkv: int
    smem_bytes: int


#: the advisor's first blocks: at head_dim 128 a q tile of 256 fp32 rows
#: alone takes 128 KiB of the 227 KiB, leaving no room for a useful kv
#: tile; 128 is also the tensor-core kernel's largest block_q and block_kv
ATTENTION_START = 128


def attention_cta_tiles(seq_q: int, seq_kv: int, head_dim: int,
                        dtype="bfloat16") -> AttentionCTATiles:
    """Flash-attention block sizes for one CTA of the Hopper kernels — the
    shared-memory counterpart of ``repro.core.blocking.attention_tiles``.

    The q tile is the 'layer' kept resident while the kv stream passes
    (the LC structure of attention), so blocks start as large as the
    lengths allow (at most :data:`ATTENTION_START`, in steps of
    ``GRANULE * 2**k``) and shrink in the JAX advisor's order — ``bkv``
    first, then ``bq``.  They shrink first until
    :func:`repro_torch.kernels.flash_attention.launch_limits` accepts the
    pair on a tensor-core route (wgmma in bfloat16, bf16x3 in float32, at
    a head_dim of their sets; at head_dim 128 in float32 that is
    (128, 64), the hi and lo tiles of (128, 128) being too large), and
    only where no such pair is reached until it launches on any route.
    The result need not divide the lengths;
    :func:`~repro_torch.kernels.flash_attention.fit_blocks` fits it.
    Raises ``ValueError`` when even the smallest pair does not launch."""
    def start(n: int) -> int:
        b = fa.GRANULE
        while 2 * b <= min(n, ATTENTION_START):
            b *= 2
        return b

    def lim(a: int, b: int):
        return fa.launch_limits(a, b, head_dim, dtype)

    def shrink(accept) -> tuple[int, int]:
        bq, bkv = start(seq_q), start(seq_kv)
        while not accept(lim(bq, bkv)) and bkv > fa.GRANULE:
            bkv //= 2
        while not accept(lim(bq, bkv)) and bq > fa.GRANULE:
            bq //= 2
        return bq, bkv

    bq, bkv = shrink(lambda l: l.ok and l.route != "simt")
    if lim(bq, bkv).route == "simt":
        bq, bkv = shrink(lambda l: l.ok)
    last = lim(bq, bkv)
    if not last.ok:
        raise ValueError(f"no flash-attention CTA tile: {last.reason}")
    return AttentionCTATiles(bq=bq, bkv=bkv, smem_bytes=last.smem_bytes)
