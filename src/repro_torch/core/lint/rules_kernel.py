"""Kernel rules (K1xx): is this loop nest inside the models' input language?

(A copy of ``repro.core.lint.rules_kernel``.)

The analytic pipeline assumes the paper's §2.1 contract — a perfect
affine loop nest over declared arrays.  Outside it the failure mode is
rarely an exception: layer conditions and the cache simulator both take
the *linear part* of a subscript and silently model the wrong address
stream, reductions quietly report a throughput bound that real hardware
can never reach, and out-of-bounds accesses cost traffic for memory the
kernel does not own.  These rules turn each of those silent wrongs into
a diagnostic before any model runs.
"""
from __future__ import annotations

from typing import Iterable

import sympy

from ..kernel_ir import LoopKernel
from .diagnostics import Diagnostic
from .engine import LintContext, LintRule, register_rule

#: Generic substitutes for unbound size symbols when testing numeric
#: properties; two coprime values so coincidental zeros don't slip by.
_GENERIC_SIZES = (100003, 10007)


def _loop_vars(kernel: LoopKernel) -> list[sympy.Symbol]:
    return [lp.var for lp in kernel.loops]


def _known_symbols(kernel: LoopKernel) -> set[sympy.Symbol]:
    """Symbols with a defined meaning: loop indices, array-dimension
    sizes, loop-bound sizes, and ``-D``-bound constants."""
    known: set[sympy.Symbol] = set(_loop_vars(kernel))
    for arr in kernel.arrays.values():
        for d in arr.dims:
            known |= getattr(d, "free_symbols", set())
    for lp in kernel.loops:
        known |= lp.start.free_symbols | lp.stop.free_symbols
    known |= {sympy.Symbol(k) for k in kernel.constants}
    return known


def _is_affine(expr: sympy.Expr, lvars: list[sympy.Symbol]) -> bool:
    """Affine in the loop variables: polynomial of total degree <= 1."""
    used = [v for v in lvars if v in expr.free_symbols]
    if not used:
        return True
    try:
        poly = sympy.Poly(expr, *used)
    except (sympy.PolynomialError, sympy.SympifyError):
        return False
    return poly.total_degree() <= 1


def _ref(access) -> str:
    return (f"{access.array.name}"
            + "".join(f"[{i}]" for i in access.index))


@register_rule
class NonAffineSubscript(LintRule):
    """K101 — a subscript that is not affine in the loop indices.

    Neither predictor can model these: layer conditions assume constant
    reuse distances, and the cache simulator's address builder keeps only
    the linear coefficient of each loop variable — ``a[i*i]`` simulates
    the address stream of ``a[0]``, silently."""

    code = "K101"
    family = "kernel"
    title = "non-affine subscript"
    needs = ("kernel",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        kernel = ctx.loop_kernel
        if kernel is None:
            return
        lvars = _loop_vars(kernel)
        for a in kernel.accesses:
            for e in a.index:
                if not _is_affine(e, lvars):
                    yield Diagnostic(
                        code=self.code, severity="error",
                        message=f"subscript {e} of {_ref(a)} is not an "
                                "affine function of the loop indices; "
                                "neither LC nor the cache simulator "
                                "models non-affine address streams",
                        suggestion="rewrite the access as an affine "
                                   "expression of the loop indices",
                        span=a.span, subject=a.array.name)
                    break


@register_rule
class UnknownSubscriptSymbol(LintRule):
    """K102 — a subscript depending on a symbol that is neither a loop
    index nor a declared/bound size (a data-dependent or typo'd index).
    Every analysis would either crash on it or substitute a generic
    placeholder size."""

    code = "K102"
    family = "kernel"
    title = "data-dependent or undeclared subscript symbol"
    needs = ("kernel",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        kernel = ctx.loop_kernel
        if kernel is None:
            return
        known = _known_symbols(kernel)
        for a in kernel.accesses:
            unknown = set()
            for e in a.index:
                unknown |= e.free_symbols - known
            if unknown:
                names = ", ".join(sorted(str(s) for s in unknown))
                yield Diagnostic(
                    code=self.code, severity="error",
                    message=f"subscript of {_ref(a)} depends on "
                            f"symbol(s) {names} that are neither loop "
                            "indices nor declared sizes (data-dependent "
                            "or undeclared)",
                    suggestion=f"bind them with -D (e.g. -D "
                               f"{sorted(str(s) for s in unknown)[0]} "
                               "<value>) or rewrite the subscript",
                    span=a.span, subject=a.array.name)


def _loop_extent(lp, subs: dict):
    """(first, last) value of a loop variable, or None when the last
    value is not derivable (symbolic stop with step > 1)."""
    first = lp.start
    if lp.step == 1:
        return first, lp.stop - 1
    stop = sympy.simplify(lp.stop.subs(subs))
    start = sympy.simplify(lp.start.subs(subs))
    if not (stop.is_number and start.is_number):
        return None
    trips = (int(stop) - int(start) - 1) // lp.step
    return first, sympy.Integer(int(start) + trips * lp.step)


def _coeff_sign(coeff: sympy.Expr, subs: dict) -> int | None:
    """Sign of a subscript coefficient, probing unbound size symbols at
    two generic values; None when inconsistent."""
    signs = set()
    for g in _GENERIC_SIZES:
        val = coeff.subs(subs)
        val = val.subs({s: g for s in val.free_symbols})
        try:
            f = float(val)
        except (TypeError, ValueError):
            return None
        signs.add(0 if f == 0 else (1 if f > 0 else -1))
    return signs.pop() if len(signs) == 1 else None


@register_rule
class OutOfBoundsAccess(LintRule):
    """K103 — an access provably outside its array's declared extent.

    Only *provable* violations are reported: the index extreme is taken
    at the loop bounds, and the margin against the declared dimension
    must simplify to a negative number (so ``a[i+1]`` under ``i < N-1``
    with extent ``N`` passes, while ``i < N`` fails by exactly 1 for
    every ``N``).  Models charge traffic for the out-of-range line and
    the simulator lays arrays back-to-back, so the overrun silently
    reads its neighbor array."""

    code = "K103"
    family = "kernel"
    title = "out-of-bounds access"
    needs = ("kernel",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        kernel = ctx.loop_kernel
        if kernel is None:
            return
        lvars = _loop_vars(kernel)
        subs = kernel.subs()
        extents = {}
        for lp in kernel.loops:
            ext = _loop_extent(lp, subs)
            if ext is not None:
                extents[lp.var] = ext
        for a in kernel.accesses:
            if len(a.index) != len(a.array.dims):
                continue                      # flattened form: checked 1-D
            for axis, (e, dim) in enumerate(zip(a.index, a.array.dims)):
                if not _is_affine(e, lvars):
                    continue                  # K101's problem
                for bound, kind in ((dim - 1, "max"), (sympy.Integer(0),
                                                       "min")):
                    extreme = e
                    ok = True
                    for v in lvars:
                        if v not in extreme.free_symbols:
                            continue
                        if v not in extents:
                            ok = False
                            break
                        sign = _coeff_sign(e.coeff(v, 1), subs)
                        if sign is None:
                            ok = False
                            break
                        first, last = extents[v]
                        pick = last if (sign > 0) == (kind == "max") \
                            else first
                        extreme = extreme.subs(v, pick)
                    if not ok:
                        continue
                    margin = sympy.simplify(
                        (bound - extreme if kind == "max"
                         else extreme - bound).subs(subs))
                    if margin.is_number and float(margin) < 0:
                        lim = "below 0" if kind == "min" else \
                            f"beyond extent {dim}"
                        yield Diagnostic(
                            code=self.code, severity="error",
                            message=f"{_ref(a)} indexes dimension "
                                    f"{axis} of {a.array.name} "
                                    f"{lim} by {int(-float(margin))} "
                                    f"(index {kind} is {extreme})",
                            suggestion="shrink the loop bounds or grow "
                                       "the declared array extent",
                            span=a.span, subject=a.array.name)


@register_rule
class InconsistentArrayTable(LintRule):
    """K104 — an access whose Array metadata disagrees with the kernel's
    declared array table (aliased or hand-edited IR).  The predictors
    read the access's copy while the simulator lays memory out from the
    table, so the two silently model different machines."""

    code = "K104"
    family = "kernel"
    title = "access/array-table mismatch"
    needs = ("kernel",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        kernel = ctx.loop_kernel
        if kernel is None:
            return
        for a in kernel.accesses:
            decl = kernel.arrays.get(a.array.name)
            if decl is None:
                yield Diagnostic(
                    code=self.code, severity="error",
                    message=f"access {_ref(a)} references array "
                            f"{a.array.name!r} missing from the "
                            "kernel's array table",
                    suggestion="declare the array (the simulator "
                               "allocates from the table)",
                    span=a.span, subject=a.array.name)
            elif (tuple(str(d) for d in decl.dims)
                  != tuple(str(d) for d in a.array.dims)
                  or decl.element_bytes != a.array.element_bytes):
                yield Diagnostic(
                    code=self.code, severity="error",
                    message=f"access {_ref(a)} carries shape "
                            f"{tuple(str(d) for d in a.array.dims)} x "
                            f"{a.array.element_bytes}B but the array "
                            "table declares "
                            f"{tuple(str(d) for d in decl.dims)} x "
                            f"{decl.element_bytes}B",
                    suggestion="rebuild the kernel through a frontend "
                               "so accesses share the declared Array",
                    span=a.span, subject=a.array.name)


@register_rule
class InnerInvariantWrite(LintRule):
    """K105 — a store whose address ignores the inner loop index: a
    loop-carried reduction.  Steady state is bound by the dependence
    chain's latency, which the default throughput in-core model does not
    see — its prediction is a bound the loop cannot reach."""

    code = "K105"
    family = "kernel"
    title = "inner-loop-invariant store (reduction)"
    needs = ("kernel",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        kernel = ctx.loop_kernel
        if kernel is None or not kernel.loops:
            return
        inner = kernel.inner_loop.var
        lvars = _loop_vars(kernel)
        for a in kernel.writes():
            if any(not _is_affine(e, lvars) for e in a.index):
                continue
            if all(inner not in e.free_symbols for e in a.index):
                yield Diagnostic(
                    code=self.code, severity="warning",
                    message=f"store {_ref(a)} is invariant in the inner "
                            f"loop ({inner}): a loop-carried reduction "
                            "whose steady state is latency-bound",
                    suggestion="use --incore ports (schedules the "
                               "dependence chain and reports the "
                               "latency bound)",
                    span=a.span, subject=a.array.name)


@register_rule
class LayerConditionHazard(LintRule):
    """K106 — layouts the layer-condition analysis mis-models while the
    cache simulator handles them: inner strides spanning whole cache
    lines (the per-cacheline unit of work collapses) and leading
    dimensions that are an exact multiple of a cache's way size
    (associativity conflict misses, invisible to LC's fully-associative
    reuse-distance argument — the paper's case for SIM, §4)."""

    code = "K106"
    family = "kernel"
    title = "layer conditions inapplicable"
    needs = ("kernel",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        kernel = ctx.loop_kernel
        if kernel is None or not kernel.loops:
            return
        cl = (ctx.machine.cacheline_bytes if ctx.machine is not None
              else 64)
        inner = kernel.inner_loop
        if inner.step * kernel.dtype_bytes >= cl and inner.step > 1:
            yield Diagnostic(
                code=self.code, severity="warning",
                message=f"inner loop steps {inner.step} elements "
                        f"({inner.step * kernel.dtype_bytes} B >= the "
                        f"{cl} B cache line): every iteration opens a "
                        "new line, outside LC's per-cacheline unit of "
                        "work",
                suggestion="use --cache-predictor SIM",
                span=inner.span, subject=str(inner.var))
        if ctx.machine is None:
            return
        subs = kernel.subs()
        for name, arr in kernel.arrays.items():
            if len(arr.dims) < 2:
                continue
            row = sympy.simplify((arr.dims[-1]
                                  * arr.element_bytes).subs(subs))
            if not row.is_number:
                continue                      # unbound: nothing to prove
            row = int(row)
            for lv in ctx.machine.levels:
                if lv.sets <= 0 or lv.ways <= 0:
                    continue
                way = lv.sets * lv.cl_size
                if row and way and row % way == 0:
                    yield Diagnostic(
                        code=self.code, severity="warning",
                        message=f"leading dimension of {name} "
                                f"({row} B) is a multiple of "
                                f"{lv.name}'s way size ({way} B): "
                                "rows map to one set and conflict-miss "
                                f"beyond {lv.ways} ways, which LC "
                                "cannot see",
                        suggestion="use --cache-predictor SIM, or pad "
                                   "the leading dimension",
                        subject=name)
                    break


@register_rule
class CompiledSweepEligibility(LintRule):
    """K107 — why a sweep over this kernel would fall off the compiled
    analytic fast path (informational; the per-point path is always
    available and bit-for-bit identical)."""

    code = "K107"
    family = "kernel"
    title = "compiled-sweep eligibility"
    needs = ("kernel",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        kernel = ctx.loop_kernel
        if kernel is None:
            return
        known = {sympy.Symbol(k) for k in kernel.constants}
        size_syms: set[sympy.Symbol] = set()
        for arr in kernel.arrays.values():
            for d in arr.dims:
                size_syms |= getattr(d, "free_symbols", set())
        for lp in kernel.loops:
            size_syms |= lp.start.free_symbols | lp.stop.free_symbols
        size_syms -= set(_loop_vars(kernel))
        unbound = sorted(str(s) for s in size_syms - known)
        if len(unbound) > 1:
            yield Diagnostic(
                code=self.code, severity="info",
                message=f"{len(unbound)} unbound size symbols "
                        f"({', '.join(unbound)}): a compiled sweep "
                        "batches one symbol and pins the rest, so all "
                        "but the sweep parameter must be bound",
                suggestion="bind the non-swept sizes with -D "
                           "(e.g. -D M 300)",
                subject=",".join(unbound))
        if str(ctx.request.get("predictor", "")).upper() == "SIM" \
                and ctx.request.get("compiled") is not True:
            yield Diagnostic(
                code=self.code, severity="info",
                message="the SIM predictor has no analytic closed "
                        "form: sweeps run per-point (no --dense)",
                suggestion="use --cache-predictor LC for compiled "
                           "sweeps",
                subject="SIM")
