"""The ``trace`` frontend: Python point functions as loop kernels.

A copy of ``repro.core.frontends.trace`` without the frontend registry;
the JAX package's jaxpr flop recount is ``flops="fx"`` here, through
torch's ``make_fx``.  The CUDA kernels in
:mod:`repro_torch.kernels` express a stencil as tiled plane arithmetic —
opaque to the analyses.  This frontend closes that gap: the kernel author
writes the *point function*
(one innermost iteration, the same scalar math the C body holds) and
decorates it with the loop/array geometry; tracing it captures the affine
:class:`~repro_torch.core.kernel_ir.LoopKernel` IR the whole model stack
consumes:

    @kernel_spec(name="3d-7pt",
                 arrays={"a": ("M", "N", "N"), "b": ("M", "N", "N")},
                 loops=[("k", 1, "M-1"), ("j", 1, "N-1"), ("i", 1, "N-1")])
    def point(a, b, w, k, j, i):
        b[k, j, i] = w.wC * a[k, j, i] + w.wW * a[k, j, i-1] + ...

Tracing works by direct closed-form indexing capture: array parameters
become :class:`TracedArray` recorders whose ``__getitem__``/``__setitem__``
log affine accesses (indices are sympy expressions over the loop symbols),
loop-variable parameters are the sympy symbols themselves, and any other
parameter is a :class:`ScalarBag` of register-resident coefficients.
Arithmetic on traced values builds an expression DAG; flops are counted
over that DAG (each shared subexpression once — a Python local like
``lap`` is "computed once, reused", exactly like a scalar temporary in C).
With ``flops="fx"`` the DAG is instead re-evaluated under torch's
``make_fx`` and flops are counted from the aten calls of the graph — same
numbers, but derived from a real operator stream.

Limits (DESIGN.md §7): the point function must be straight-line scalar
code — no data-dependent branches, no slicing, no reductions over loop
dims.  Python control flow that does not depend on traced *values* (e.g.
``for d in range(1, 5)`` generating neighbor terms) is fine: it unrolls at
trace time, exactly like the C body unrolls its textual sum.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import inspect
from typing import Callable, Sequence

import sympy

from .kernel_ir import (Access, Array, FlopCount, Loop, LoopKernel,
                        sympify_ids)


class TraceError(ValueError):
    pass


# ----------------------------------------------------------------------
# Expression capture
# ----------------------------------------------------------------------

_OP_FLOPS = {"+": FlopCount(add=1), "-": FlopCount(add=1),
             "*": FlopCount(mul=1), "/": FlopCount(div=1),
             "neg": FlopCount(), "leaf": FlopCount()}


class TraceValue:
    """A node of the captured scalar expression DAG."""

    __slots__ = ("op", "args")

    def __init__(self, op: str = "leaf", args: tuple = ()):
        self.op = op
        self.args = args

    # -- arithmetic ----------------------------------------------------
    def _bin(self, op, other, swap=False):
        if not isinstance(other, (TraceValue, int, float)):
            return NotImplemented
        args = (other, self) if swap else (self, other)
        return TraceValue(op, args)

    def __add__(self, o): return self._bin("+", o)
    def __radd__(self, o): return self._bin("+", o, swap=True)
    def __sub__(self, o): return self._bin("-", o)
    def __rsub__(self, o): return self._bin("-", o, swap=True)
    def __mul__(self, o): return self._bin("*", o)
    def __rmul__(self, o): return self._bin("*", o, swap=True)
    def __truediv__(self, o): return self._bin("/", o)
    def __rtruediv__(self, o): return self._bin("/", o, swap=True)

    def __neg__(self):
        # unary sign is free, matching the C frontend (folded into add/sub)
        return TraceValue("neg", (self,))

    def __pos__(self):
        return self

    def _unsupported(self, what):
        raise TraceError(
            f"{what} is outside the affine point-function language the "
            "trace frontend captures (straight-line +,-,*,/ scalar code "
            "only; see DESIGN.md §7)")

    def __pow__(self, o): self._unsupported("** (power)")
    def __mod__(self, o): self._unsupported("% (modulo)")
    def __floordiv__(self, o): self._unsupported("// (floor division)")
    def __bool__(self): self._unsupported("branching on a traced value")
    def __lt__(self, o): self._unsupported("comparing traced values")
    __le__ = __gt__ = __ge__ = __lt__


def _dag_flops(roots: Sequence[TraceValue]) -> FlopCount:
    """Count flops over the DAG, visiting each shared node once."""
    total = FlopCount()
    seen: set[int] = set()
    stack = [r for r in roots if isinstance(r, TraceValue)]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        total = total + _OP_FLOPS[node.op]
        stack.extend(a for a in node.args if isinstance(a, TraceValue))
    return total


def _fx_flops(roots: Sequence[TraceValue]) -> FlopCount:
    """Re-derive the flop count from the FX graph of the captured body:
    the port's counterpart of the JAX package's jaxpr recount.

    Evaluates the DAG (memoized, so shared subexpressions stay shared)
    over 0-dim float32 placeholders under ``make_fx`` and counts the aten
    calls as the jaxpr recount maps its primitives: ``add``, ``sub`` and
    ``rsub`` are adds, ``mul`` and ``div`` themselves; ``neg`` counts
    nothing."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves: list[TraceValue] = []
    seen: set[int] = set()
    stack = [r for r in roots if isinstance(r, TraceValue)]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if node.op == "leaf":
            leaves.append(node)
        stack.extend(a for a in node.args if isinstance(a, TraceValue))

    def body(*vals):
        env = {id(l): v for l, v in zip(leaves, vals)}

        def ev(node):
            if not isinstance(node, TraceValue):
                return node
            got = env.get(id(node))
            if got is not None:
                return got
            a = [ev(x) for x in node.args]
            out = {"+": lambda: a[0] + a[1], "-": lambda: a[0] - a[1],
                   "*": lambda: a[0] * a[1], "/": lambda: a[0] / a[1],
                   "neg": lambda: -a[0]}[node.op]()
            env[id(node)] = out
            return out

        return [ev(r) for r in roots]

    placeholders = [torch.zeros((), dtype=torch.float32)
                    for _ in range(max(1, len(leaves)))]
    graph = make_fx(body)(*placeholders).graph
    aten = torch.ops.aten
    kinds = {aten.add: "add", aten.sub: "add", aten.rsub: "add",
             aten.mul: "mul", aten.div: "div"}
    counts = {"add": 0, "mul": 0, "div": 0}
    for node in graph.nodes:
        packet = getattr(node.target, "overloadpacket", None)
        if node.op == "call_function" and packet in kinds:
            counts[kinds[packet]] += 1
    return FlopCount(**counts)


class ScalarBag:
    """Register-resident coefficients: any attribute or item access yields a
    fresh scalar leaf, and (like scalar reads in the C frontend) records no
    memory access."""

    def __getattr__(self, name) -> TraceValue:
        if name.startswith("__"):
            raise AttributeError(name)
        return TraceValue()

    def __getitem__(self, idx) -> TraceValue:
        return TraceValue()


class TracedArray:
    """Records affine reads/writes of one array during the trace."""

    def __init__(self, array: Array, recorder: "_Recorder"):
        self._array = array
        self._rec = recorder

    def _norm(self, idx) -> tuple[sympy.Expr, ...]:
        if not isinstance(idx, tuple):
            idx = (idx,)
        if any(isinstance(i, slice) for i in idx):
            raise TraceError(
                f"slicing {self._array.name!r} is not traceable: write the "
                "point function at scalar level (one innermost iteration)")
        norm = tuple(sympy.expand(sympify_ids(i)) for i in idx)
        if len(norm) != len(self._array.dims):
            raise TraceError(
                f"{self._array.name}: {len(norm)} subscripts for "
                f"{len(self._array.dims)}-D array (flattened access uses "
                "a 1-D declared array with one affine subscript)")
        return norm

    def __getitem__(self, idx) -> TraceValue:
        self._rec.reads.append((self._array.name, self._norm(idx)))
        return TraceValue()

    def __setitem__(self, idx, value) -> None:
        if not isinstance(value, (TraceValue, int, float)):
            raise TraceError(
                f"stored value for {self._array.name!r} must be traced "
                f"scalar arithmetic, got {type(value).__name__}")
        self._rec.writes.append((self._array.name, self._norm(idx)))
        if isinstance(value, TraceValue):
            self._rec.roots.append(value)


@dataclasses.dataclass
class _Recorder:
    reads: list = dataclasses.field(default_factory=list)
    writes: list = dataclasses.field(default_factory=list)
    roots: list = dataclasses.field(default_factory=list)


# ----------------------------------------------------------------------
# Spec + tracer
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Loop/array geometry attached to a point function by
    :func:`kernel_spec`."""
    name: str
    arrays: dict                     # name -> dims (ints or symbol strings)
    loops: tuple                     # ((var, start, stop[, step]), ...)
    element_bytes: int = 8
    constants: dict = dataclasses.field(default_factory=dict)


def kernel_spec(name: str, arrays: dict, loops: Sequence,
                element_bytes: int = 8,
                constants: dict | None = None) -> Callable:
    """Attach a :class:`TraceSpec` to a point function, making it loadable
    by the trace frontend (and by ``analyze(point_fn, machine)``)."""
    spec = TraceSpec(name=name, arrays=dict(arrays),
                     loops=tuple(tuple(l) for l in loops),
                     element_bytes=element_bytes,
                     constants=dict(constants or {}))

    def deco(fn):
        fn.__kernel_spec__ = spec
        return fn
    return deco


def trace_kernel(fn: Callable, spec: TraceSpec | None = None,
                 name: str | None = None, constants: dict | None = None,
                 element_bytes: int | None = None,
                 flops: str = "dag") -> LoopKernel:
    """Trace ``fn`` into a :class:`LoopKernel`.

    ``flops`` selects the counting path: ``"dag"`` (direct capture) or
    ``"fx"`` (the recount through ``make_fx``, the counterpart of the JAX
    package's ``"jaxpr"``, which the port refuses by name).
    """
    spec = spec or getattr(fn, "__kernel_spec__", None)
    if spec is None:
        raise TraceError(
            f"{getattr(fn, '__name__', fn)!r} carries no @kernel_spec and "
            "no spec= was given")

    loop_syms = {l[0]: sympy.Symbol(l[0]) for l in spec.loops}
    arrays = {a: Array(a, tuple(sympify_ids(d) for d in dims),
                       element_bytes or spec.element_bytes)
              for a, dims in spec.arrays.items()}
    rec = _Recorder()

    params = list(inspect.signature(fn).parameters)
    missing = sorted(set(arrays) - set(params))
    if missing:
        # a typo'd parameter would silently become a ScalarBag and drop
        # every access of that array from the model — fail loudly instead
        raise TraceError(
            f"point function {getattr(fn, '__name__', fn)!r} has no "
            f"parameter for spec array(s) {missing}; its signature "
            f"{params} must name every array in the spec")
    kwargs = {}
    for pname in params:
        if pname in arrays:
            kwargs[pname] = TracedArray(arrays[pname], rec)
        elif pname in loop_syms:
            kwargs[pname] = loop_syms[pname]
        else:
            kwargs[pname] = ScalarBag()
    fn(**kwargs)

    if not rec.writes:
        raise TraceError(
            f"point function {getattr(fn, '__name__', fn)!r} recorded no "
            "array write: assign through an array parameter, e.g. "
            "b[k, j, i] = ...")

    if flops == "jaxpr":
        raise ValueError(
            "flops='jaxpr' (the jax.make_jaxpr recount) is the JAX "
            "package's; the port's recount of the same body is flops='fx' "
            "(torch's make_fx), and flops='dag' yields the same counts")
    if flops not in ("dag", "fx"):
        raise ValueError(f"flops must be 'dag' or 'fx', got {flops!r}")
    fc = _fx_flops(rec.roots) if flops == "fx" else _dag_flops(rec.roots)

    # dedupe identical refs (register reuse within one iteration), reads
    # first then writes — byte-compatible with the C frontend
    accesses: list[Access] = []
    seen: set[tuple] = set()
    for group, is_write in ((rec.reads, False), (rec.writes, True)):
        for aname, idx in group:
            key = (aname, idx, is_write)
            if key in seen:
                continue
            seen.add(key)
            accesses.append(Access(arrays[aname], idx, is_write=is_write))

    loops = []
    for l in spec.loops:
        var, start, stop = l[0], l[1], l[2]
        step = int(l[3]) if len(l) > 3 else 1
        loops.append(Loop(loop_syms[var], sympy.expand(sympify_ids(start)),
                          sympy.expand(sympify_ids(stop)), step))

    merged = dict(spec.constants)
    merged.update(constants or {})
    return LoopKernel(loops=loops, accesses=accesses, flops=fc,
                      arrays=arrays, constants=merged,
                      dtype_bytes=element_bytes or spec.element_bytes,
                      name=name or spec.name,
                      source=f"trace:{getattr(fn, '__module__', '?')}."
                             f"{getattr(fn, '__qualname__', '?')}")


def _import_point(ref: str) -> Callable:
    """Resolve ``module:attr`` (attr defaults to ``point``); a bare name
    that is no importable top-level module resolves to
    ``repro_torch.kernels.<name>``.  Modules of the JAX package are
    refused: the port imports nothing under ``repro.``."""
    mod_name, _, attr = ref.partition(":")
    attr = attr or "point"
    if mod_name == "repro" or mod_name.startswith("repro."):
        raise TraceError(
            f"trace source {ref!r} names the JAX package; the port traces "
            "its own point functions (e.g. 'trace:stencil3d7pt' or "
            "'trace:repro_torch.kernels.stencil3d7pt')")
    if "." not in mod_name and importlib.util.find_spec(mod_name) is None:
        mod_name = f"repro_torch.kernels.{mod_name}"
    fn = getattr(importlib.import_module(mod_name), attr, None)
    if fn is None:
        raise TraceError(f"module {mod_name!r} has no attribute {attr!r}")
    return fn
