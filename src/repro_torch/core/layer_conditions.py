"""Layer-condition analysis (paper §2.4.2), generalized and symbolic.

A copy of ``repro.core.layer_conditions``.

For each array we sort the access offsets (flattened to 1-D element offsets),
take consecutive differences as *backward reuse distances* (the largest
offset per array is the leading first-touch access and gets distance ∞), and
pool all arrays' distances into the list ``L``. For a reuse-distance
threshold ``t``::

    C_req(t)  = sum(L_<=t) + t * count(L_>t)
    hits(t)   = count(L_<=t)
    misses(t) = count(L_>t)          # includes the per-array ∞ entries

The largest ``t`` with ``C_req(t) <= C_cache`` describes the steady state of
an LRU cache of size ``C_cache``. Solving ``C_req(t) = C_cache`` for a size
symbol yields the *transition points* of paper Listing 5 (e.g. the L3 3D→2D
transition of the long-range stencil at N = 546), and solving for loop block
sizes yields spatial blocking factors.

Everything is computed in *bytes* so mixed element sizes work; with uniform
8-byte doubles this reduces exactly to the paper's element formulation.
"""
from __future__ import annotations

import dataclasses
import math

import sympy

from .identity import accesses_key, structure_key
from .kernel_ir import Access, LoopKernel

INF = sympy.oo

_GENERIC_SIZE = 100003  # large prime for symbol ordering when sizes unbound

# The generic-size fallback substitution, cached per free-symbol set: sort
# keys over partially-bound kernels hit the fallback on every comparison,
# and rebuilding the substitution dict (and re-subbing the same expression)
# dominated those sorts.  Numeric results are cached too — `analyze` and
# `c_req` evaluate the same (expr, subs) pairs O(thresholds × entries)
# times per call.  Both caches are bounded; eviction only costs a re-sub.
_GENERIC_SUBS: dict[frozenset, dict] = {}
_NUMERIC_CACHE: dict[tuple, float] = {}
_CACHE_MAX = 1 << 16


def generic_subs(free_symbols) -> dict:
    """The ``{symbol: _GENERIC_SIZE}`` fallback substitution for a set of
    unbound symbols, built once per distinct symbol set."""
    key = frozenset(free_symbols)
    hit = _GENERIC_SUBS.get(key)
    if hit is None:
        if len(_GENERIC_SUBS) >= _CACHE_MAX:
            _GENERIC_SUBS.clear()
        hit = _GENERIC_SUBS[key] = {s: _GENERIC_SIZE for s in key}
    return hit


def _numeric(expr, subs: dict) -> float:
    try:
        key = (expr, tuple(subs.items()))
        hit = _NUMERIC_CACHE.get(key)
    except TypeError:          # unhashable input: evaluate uncached
        key, hit = None, None
    if hit is not None:
        return hit
    v = sympy.sympify(expr).subs(subs)
    try:
        out = float(v)
    except TypeError:
        # unbound symbols left: order with generic large values
        out = float(v.subs(generic_subs(v.free_symbols)))
    if key is not None:
        if len(_NUMERIC_CACHE) >= _CACHE_MAX:
            _NUMERIC_CACHE.clear()
        _NUMERIC_CACHE[key] = out
    return out


@dataclasses.dataclass(frozen=True)
class DistanceEntry:
    """One entry of L: the backward reuse distance of ``access``."""
    access: Access
    distance: sympy.Expr          # bytes; sympy.oo for first-touch
    forward: sympy.Expr           # forward reuse distance (bytes); oo if last


@dataclasses.dataclass(frozen=True)
class LCState:
    """Steady state of one cache level for one kernel."""
    threshold: sympy.Expr            # chosen t (bytes), -1 if nothing fits
    c_req_bytes: float
    hits: int
    misses: int                      # load misses / inner iteration
    writeback_lines: int             # dirty streams evicted / inner iteration
    evict_bytes_per_it: float        # writeback traffic, bytes / iteration
    miss_bytes_per_it: float         # load traffic, bytes / iteration
    per_array_misses: dict[str, int]

    @property
    def total_bytes_per_it(self) -> float:
        return self.miss_bytes_per_it + self.evict_bytes_per_it


# distance_list (and the per-array sorted-offset lists it derives from) is
# pure in (accesses structure, bound constants) — the constants only enter
# through the numeric sort keys — yet the symbolic path recomputed it per
# bound point, O(thresholds) times per `analyze` call.  Memoized here by the
# shared structural key; ``kernel.bind()`` shallow-copies, so bound sweep
# variants share the accesses container and the key is cheap.  Cached lists
# are treated as immutable by every caller.
_SORTED_CACHE: dict[tuple, dict] = {}
_DL_CACHE: dict[tuple, list] = {}
_THRESH_CACHE: dict[tuple, list] = {}
_CREQ_CACHE: dict[tuple, sympy.Expr] = {}
_STRUCT_CACHE_MAX = 2048


def _dl_key(kernel: LoopKernel) -> tuple:
    return (structure_key(kernel.accesses, accesses_key),
            tuple(sorted(kernel.constants.items())))


def _bounded_put(cache: dict, key, value):
    while len(cache) >= _STRUCT_CACHE_MAX:
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value


def sorted_offsets(kernel: LoopKernel) -> dict[str, list[tuple[Access, sympy.Expr]]]:
    """Per-array ``(access, flattened offset)`` lists in LC order: ascending
    numeric offset (unbound symbols at the generic size), writes first among
    equal offsets.  The consecutive differences of each list are the reuse
    distances."""
    key = _dl_key(kernel)
    hit = _SORTED_CACHE.get(key)
    if hit is not None:
        return hit
    subs = kernel.subs()
    by_array: dict[str, list[Access]] = {}
    for acc in kernel.accesses:
        by_array.setdefault(acc.array.name, []).append(acc)
    out: dict[str, list[tuple[Access, sympy.Expr]]] = {}
    for name, accs in by_array.items():
        offs = [(acc, sympy.expand(acc.offset())) for acc in accs]
        offs.sort(key=lambda p: (_numeric(p[1], subs), not p[0].is_write))
        out[name] = offs
    return _bounded_put(_SORTED_CACHE, key, out)


def distance_list(kernel: LoopKernel) -> list[DistanceEntry]:
    """Build L with per-access backward/forward distances (bytes)."""
    key = _dl_key(kernel)
    hit = _DL_CACHE.get(key)
    if hit is not None:
        return hit
    entries: list[DistanceEntry] = []
    for name, offs in sorted_offsets(kernel).items():
        eb = offs[0][0].array.element_bytes
        n = len(offs)
        for i, (acc, off) in enumerate(offs):
            back = INF if i == n - 1 else sympy.expand((offs[i + 1][1] - off) * eb)
            fwd = INF if i == 0 else sympy.expand((off - offs[i - 1][1]) * eb)
            entries.append(DistanceEntry(acc, back, fwd))
    return _bounded_put(_DL_CACHE, key, entries)


def thresholds(kernel: LoopKernel) -> list[sympy.Expr]:
    """Distinct candidate thresholds (finite distances), ascending."""
    key = _dl_key(kernel)
    hit = _THRESH_CACHE.get(key)
    if hit is not None:
        return hit
    subs = kernel.subs()
    seen: dict[str, sympy.Expr] = {}
    for e in distance_list(kernel):
        if e.distance is not INF:
            seen[sympy.srepr(e.distance)] = e.distance
    vals = sorted(seen.values(), key=lambda v: _numeric(v, subs))
    return _bounded_put(_THRESH_CACHE, key, [sympy.Integer(0)] + vals)


def c_req(kernel: LoopKernel, t: sympy.Expr) -> sympy.Expr:
    """Symbolic required cache size (bytes) for threshold ``t``."""
    key = (_dl_key(kernel), t)
    hit = _CREQ_CACHE.get(key)
    if hit is not None:
        return hit
    subs = kernel.subs()
    tn = _numeric(t, subs)
    total: sympy.Expr = sympy.Integer(0)
    for e in distance_list(kernel):
        if e.distance is not INF and _numeric(e.distance, subs) <= tn:
            total = total + e.distance
        else:
            total = total + t
    return _bounded_put(_CREQ_CACHE, key, sympy.expand(total))


def analyze(kernel: LoopKernel, cache_bytes: float) -> LCState:
    """Steady-state hits/misses/traffic for an LRU cache of ``cache_bytes``."""
    subs = kernel.subs()
    entries = distance_list(kernel)
    best_t: sympy.Expr = sympy.Integer(-1)
    for t in thresholds(kernel):
        if _numeric(c_req(kernel, t), subs) <= cache_bytes:
            best_t = t
    tn = _numeric(best_t, subs)

    hits = misses = wb = 0
    miss_bytes = 0.0
    evict_bytes = 0.0
    per_array: dict[str, int] = {}
    step = kernel.inner_loop.step
    for e in entries:
        eb = e.access.array.element_bytes
        is_miss = e.distance is INF or _numeric(e.distance, subs) > tn
        if is_miss:
            misses += 1
            per_array[e.access.array.name] = per_array.get(e.access.array.name, 0) + 1
            miss_bytes += eb * step
        else:
            hits += 1
        if e.access.is_write:
            fwd_miss = e.forward is INF or _numeric(e.forward, subs) > tn
            if fwd_miss:
                wb += 1
                evict_bytes += eb * step
    creq = _numeric(c_req(kernel, best_t), subs) if tn >= 0 else math.inf
    return LCState(threshold=best_t, c_req_bytes=creq, hits=hits, misses=misses,
                   writeback_lines=wb, evict_bytes_per_it=evict_bytes,
                   miss_bytes_per_it=miss_bytes, per_array_misses=per_array)


@dataclasses.dataclass(frozen=True)
class Transition:
    """One LC transition: condition holds while ``symbol`` <= ``max_value``."""
    threshold: sympy.Expr
    c_req: sympy.Expr
    symbol: str
    max_value: float
    hits: int
    misses: int


def transition_points(kernel: LoopKernel, cache_bytes: float,
                      symbol: str = "N") -> list[Transition]:
    """Solve ``C_req(t) <= cache_bytes`` for ``symbol`` at each threshold
    (paper Listing 5). Other symbols are taken from ``kernel.constants``.
    """
    sym = sympy.Symbol(symbol)
    subs = {k: v for k, v in kernel.subs().items() if k != sym}
    out: list[Transition] = []
    entries = distance_list(kernel)
    for t in thresholds(kernel):
        creq = c_req(kernel, t).subs(subs)
        tn_probe = _numeric(t, kernel.subs())
        hits = sum(1 for e in entries if e.distance is not INF
                   and _numeric(e.distance, kernel.subs()) <= tn_probe)
        misses = len(entries) - hits
        if sym not in creq.free_symbols:
            max_val = math.inf if float(creq) <= cache_bytes else 0.0
        else:
            sols = sympy.solve(sympy.Eq(creq, cache_bytes), sym)
            real = [float(s) for s in sols
                    if s.is_real and float(s) > 0]
            max_val = max(real) if real else 0.0
        out.append(Transition(threshold=t, c_req=creq, symbol=symbol,
                              max_value=max_val, hits=hits, misses=misses))
    return out


def effective_level_sizes(machine, cores: int = 1) -> list[tuple[str, float]]:
    """Per-level cache capacity visible to one core: shared caches are
    divided among ``cores`` (the paper's ``--cores`` switch; on the H100
    machine file the L2 is shared by the SMs)."""
    out = []
    for lv in machine.levels:
        size = lv.size_bytes
        if lv.cores_per_group > 1 and cores > 1:
            size = size / min(cores, lv.cores_per_group) * 1.0
        out.append((lv.name, size))
    return out


def volumes_per_level(kernel: LoopKernel, machine,
                      cores: int = 1) -> dict[str, LCState]:
    """Per-level LC states; the traffic between level k and k+1 is
    ``state[k].total_bytes_per_it`` (load misses + write-backs), the paper's
    β_k input to both ECM and Roofline. Shared caches are divided among
    ``cores`` (the paper's ``--cores`` switch).
    """
    return {name: analyze(kernel, size)
            for name, size in effective_level_sizes(machine, cores)}
