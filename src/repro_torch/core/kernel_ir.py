"""Affine loop-kernel IR (the object Kerncraft's analyses operate on).

A copy of ``repro.core.kernel_ir``: the port carries its own IR so that it
imports nothing of the JAX package.  A :class:`LoopKernel` is a perfect loop
nest (one loop per level, paper §2.1) whose innermost body contains
assignments built from constants, scalars, and affine array references. The
trace frontend (:mod:`repro_torch.core.trace`) and the Python builder API
produce this IR; layer conditions, the in-core model, ECM and Roofline
consume it.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Iterable, Sequence

import sympy


@functools.lru_cache(maxsize=8192)
def _sympify_str(s: str) -> sympy.Expr:
    names = set(re.findall(r"[A-Za-z_]\w*", s))
    return sympy.sympify(s, locals={n: sympy.Symbol(n) for n in names})


def sympify_ids(s) -> sympy.Expr:
    """sympify treating every identifier as a plain Symbol (names like ``N``
    otherwise resolve to sympy built-ins).

    String inputs are memoized: sweeps rebuild kernels from the same index
    strings at every parameter point, and sympy parsing dominates that
    construction.  sympy expressions are immutable, so sharing is safe.
    """
    if not isinstance(s, str):
        return sympy.sympify(s)
    return _sympify_str(s)


@dataclasses.dataclass(frozen=True)
class SourceSpan:
    """Where an IR node came from in its source text (1-based line/col).

    Builder/trace kernels carry no spans; the type is kept so the IR
    matches the JAX package's field for field.  Spans are metadata: they
    never enter structural identity (:mod:`repro_torch.core.identity`) or
    dataclass equality.
    """
    line: int
    col: int
    path: str = ""

    def label(self, fallback: str = "<kernel>") -> str:
        return f"{self.path or fallback}:{self.line}:{self.col}"

    def to_dict(self) -> dict:
        return {"line": self.line, "col": self.col, "path": self.path}

    @classmethod
    def from_dict(cls, d: dict) -> "SourceSpan":
        return cls(line=int(d["line"]), col=int(d["col"]),
                   path=str(d.get("path", "")))


@dataclasses.dataclass(frozen=True)
class Array:
    name: str
    dims: tuple[sympy.Expr, ...]        # e.g. (M, N, N); may contain symbols
    element_bytes: int = 8              # double by default, as in the paper

    def strides(self) -> tuple[sympy.Expr, ...]:
        """Row-major strides in *elements*."""
        out = []
        acc: sympy.Expr = sympy.Integer(1)
        for d in reversed(self.dims):
            out.append(acc)
            acc = acc * d
        return tuple(reversed(out))

    @property
    def size_elements(self) -> sympy.Expr:
        s: sympy.Expr = sympy.Integer(1)
        for d in self.dims:
            s = s * d
        return s


@dataclasses.dataclass(frozen=True)
class Access:
    array: Array
    index: tuple[sympy.Expr, ...]       # affine exprs over loop vars
    is_write: bool = False
    # source location metadata; excluded from equality/hash so spans never
    # perturb structural identity or the memoizing caches keyed on it
    span: SourceSpan | None = dataclasses.field(default=None, compare=False)

    def offset(self) -> sympy.Expr:
        """Flattened 1-D offset in elements (paper §2.4.2 uses these)."""
        off: sympy.Expr = sympy.Integer(0)
        for idx, stride in zip(self.index, self.array.strides()):
            off = off + idx * stride
        return sympy.expand(off)


@dataclasses.dataclass(frozen=True)
class Loop:
    var: sympy.Symbol
    start: sympy.Expr
    stop: sympy.Expr                    # exclusive upper bound
    step: int = 1
    span: SourceSpan | None = dataclasses.field(default=None, compare=False)

    @property
    def trip_count(self) -> sympy.Expr:
        return sympy.ceiling((self.stop - self.start) / self.step)


@dataclasses.dataclass(frozen=True)
class FlopCount:
    add: int = 0
    mul: int = 0
    div: int = 0
    fma: int = 0

    @property
    def total(self) -> int:
        return self.add + self.mul + self.div + 2 * self.fma

    def __add__(self, other: "FlopCount") -> "FlopCount":
        return FlopCount(self.add + other.add, self.mul + other.mul,
                         self.div + other.div, self.fma + other.fma)


@dataclasses.dataclass
class LoopKernel:
    """A perfect affine loop nest with its body's accesses and flops.

    ``accesses`` lists every array reference of one iteration of the
    *innermost* loop, reads and writes, in program order. ``flops`` counts
    floating-point work per innermost iteration. ``constants`` maps symbol
    names to concrete sizes (the ``-D N 1015`` CLI mechanism of the paper).
    """
    loops: list[Loop]
    accesses: list[Access]
    flops: FlopCount
    arrays: dict[str, Array]
    constants: dict[str, int] = dataclasses.field(default_factory=dict)
    dtype_bytes: int = 8
    name: str = "kernel"
    source: str = ""
    source_path: str = ""               # where `source` was read from, if known

    # ------------------------------------------------------------------
    @property
    def inner_loop(self) -> Loop:
        return self.loops[-1]

    def subs(self) -> dict[sympy.Symbol, int]:
        return {sympy.Symbol(k): v for k, v in self.constants.items()}

    def bind(self, **consts: int) -> "LoopKernel":
        new = dict(self.constants)
        new.update(consts)
        return dataclasses.replace(self, constants=new)

    def reads(self) -> list[Access]:
        return [a for a in self.accesses if not a.is_write]

    def writes(self) -> list[Access]:
        return [a for a in self.accesses if a.is_write]

    # --- stream classification (for benchmark-kernel matching, §2.2) ----
    def stream_counts(self) -> tuple[int, int, int]:
        """(read, write, read+write) distinct array streams."""
        read_arrays = {a.array.name for a in self.reads()}
        write_arrays = {a.array.name for a in self.writes()}
        rw = read_arrays & write_arrays
        return (len(read_arrays - rw), len(write_arrays - rw), len(rw))

    def iterations_per_cacheline(self, cacheline_bytes: int = 64) -> int:
        """The paper's unit of work: iterations that span one cache line."""
        return max(1, int(cacheline_bytes // self.dtype_bytes) // max(1, self.inner_loop.step))

    def total_iterations(self) -> int:
        n = 1
        for lp in self.loops:
            tc = sympy.simplify(lp.trip_count.subs(self.subs()))
            n *= int(tc)
        return n


# ----------------------------------------------------------------------
# Python builder API (alternative to the C front end)
# ----------------------------------------------------------------------

def make_stencil(name: str, arrays: dict[str, tuple], loop_spec: Sequence[tuple],
                 reads: Iterable[tuple], writes: Iterable[tuple],
                 flops: FlopCount, constants: dict[str, int] | None = None,
                 element_bytes: int = 8) -> LoopKernel:
    """Convenience builder.

    ``arrays``: name -> dims (ints or symbol names)
    ``loop_spec``: [(var, start, stop_expr_str), ...] outermost first
    ``reads``/``writes``: (array_name, idx_expr_str, ...) tuples
    """
    sym_arrays = {}
    for aname, dims in arrays.items():
        sym_dims = tuple(sympify_ids(d) for d in dims)
        sym_arrays[aname] = Array(aname, sym_dims, element_bytes)
    loops = [Loop(sympy.Symbol(v), sympify_ids(s0), sympify_ids(s1))
             for (v, s0, s1) in loop_spec]
    accesses = []
    for spec, is_write in [(reads, False), (writes, True)]:
        for ref in spec:
            aname, *idx = ref
            accesses.append(Access(sym_arrays[aname],
                                   tuple(sympify_ids(i) for i in idx), is_write))
    return LoopKernel(loops=loops, accesses=accesses, flops=flops,
                      arrays=sym_arrays, constants=dict(constants or {}),
                      dtype_bytes=element_bytes, name=name)
