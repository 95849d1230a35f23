"""ISA-neutral op-stream IR — the input language of the port scheduler
(a copy of ``repro.core.incore.ir``).

Both loop frontends land here: C-parsed :class:`LoopKernel` bodies and
traced ``@kernel_spec`` point functions lower through the *same*
:func:`lower_kernel` (the trace frontend already captures the body into
LoopKernel IR), so identical kernels produce identical op streams no
matter how they were written.

One *op* is one scalar-element operation of one innermost iteration:

* kind — ``ADD``/``MUL``/``DIV``/``FMA`` arithmetic, ``LOAD``/``STORE``
  memory traffic, plus ``MXU``/``VPU`` for TPU streams built directly
  (contraction vs elementwise work);
* width — operand width in bytes (memory ops scale port occupation by it);
* dependence edges — the canonical sum-of-products skeleton: loads feed
  multiplies, multiplies feed the accumulation chain, the chain feeds the
  store.  The affine IR stores flop *counts*, not the expression tree, so
  the skeleton is a canonical reconstruction: every product is independent
  (they may issue in parallel), the accumulation is a serial chain (the
  worst case a compiler emits without reassociation), divides serialize at
  the chain end.  The scheduler's critical path is measured over these
  edges.

Loop-*carried* dependences — the one case where latency, not throughput,
bounds steady-state execution — are detected from the access functions:
a write whose flattened offset leads a read of the same array by a
constant number of elements is carried at that distance (e.g.
``a[i] = a[i-1] ...`` at distance 1).  Symbolic leads (outer-loop
carries, distance ~N iterations) are ignored: they never bind, and
keeping the stream free of bound constants is what lets the session
memoize one lowering per kernel *structure* across a whole sweep.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import sympy

from ..kernel_ir import LoopKernel
from ..machine import PORT_OP_KINDS

#: Canonical op kinds, in code order (the scheduler's kind axis).  The
#: tuple lives in :mod:`repro_torch.core.machine` so YAML port-table
#: validation and the IR share one source of truth.
KINDS = PORT_OP_KINDS
KIND_CODE = {k: i for i, k in enumerate(KINDS)}


@dataclasses.dataclass(frozen=True)
class CarriedDep:
    """A loop-carried dependence: iteration ``i`` consumes a value produced
    ``distance`` inner iterations earlier through ``array``."""
    array: str
    distance: int


@dataclasses.dataclass
class OpStream:
    """One innermost iteration's ops in topological order, as arrays.

    ``levels[i]`` is op ``i``'s dependence depth; edges always point from a
    shallower level to a deeper one, which is what lets the scheduler
    relax the whole DAG level-by-level with vectorized ``np.maximum.at``
    instead of a per-op Python walk.
    """
    kinds: np.ndarray            # int8 kind codes, program order
    widths: np.ndarray           # int32 operand width, bytes
    edge_src: np.ndarray         # int64, dependence edges src -> dst
    edge_dst: np.ndarray
    levels: np.ndarray           # int32 dependence depth per op
    carried: tuple[CarriedDep, ...] = ()
    name: str = "stream"

    def __post_init__(self):
        self.kinds = np.asarray(self.kinds, dtype=np.int8)
        self.widths = np.asarray(self.widths, dtype=np.int32)
        self.edge_src = np.asarray(self.edge_src, dtype=np.int64)
        self.edge_dst = np.asarray(self.edge_dst, dtype=np.int64)
        self.levels = np.asarray(self.levels, dtype=np.int32)
        if self.edge_src.size:
            if not (self.levels[self.edge_src]
                    < self.levels[self.edge_dst]).all():
                raise ValueError(
                    "op-stream edges must point to a deeper dependence "
                    "level (src level < dst level)")

    def __len__(self) -> int:
        return int(self.kinds.size)

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.size)

    def counts(self) -> dict[str, int]:
        """Op count per kind name (zero-count kinds omitted)."""
        binc = np.bincount(self.kinds, minlength=len(KINDS))
        return {k: int(binc[c]) for k, c in KIND_CODE.items() if binc[c]}

    def key(self) -> tuple:
        """Hashable structural identity (frontend-parity comparisons)."""
        return (tuple(self.kinds.tolist()), tuple(self.widths.tolist()),
                tuple(self.edge_src.tolist()), tuple(self.edge_dst.tolist()),
                tuple((c.array, c.distance) for c in self.carried))


# ----------------------------------------------------------------------
# Lowering from the affine loop IR
# ----------------------------------------------------------------------

def _carried_deps(kernel: LoopKernel) -> tuple[CarriedDep, ...]:
    inner = kernel.inner_loop
    step = max(1, inner.step)
    deps: dict[tuple[str, int], CarriedDep] = {}
    for w in kernel.writes():
        for r in kernel.reads():
            if r.array.name != w.array.name:
                continue
            delta = sympy.expand(w.offset() - r.offset())
            if delta.free_symbols or not delta.is_number:
                continue                      # outer-loop carry: never binds
            stride = sympy.expand(w.offset()).coeff(inner.var, 1)
            if stride.free_symbols or not stride.is_number:
                continue
            stride = int(stride) * step
            if int(delta) == 0:
                # same element every iteration: stride 0 is a scalar
                # accumulator (s[0] += ...), carried at distance 1; a
                # moving address is a same-iteration read/write pair
                if stride == 0:
                    deps.setdefault((w.array.name, 1),
                                    CarriedDep(w.array.name, 1))
                continue
            if stride <= 0:
                continue
            dist, rem = divmod(int(delta), stride)
            if rem == 0 and dist >= 1:
                key = (w.array.name, dist)
                deps.setdefault(key, CarriedDep(w.array.name, dist))
    return tuple(sorted(deps.values(), key=lambda d: (d.array, d.distance)))


def lower_kernel(kernel: LoopKernel) -> OpStream:
    """Lower one innermost iteration of ``kernel`` into an :class:`OpStream`.

    Reads only the kernel's structure (accesses, flop counts, dtype, inner
    step) — bound constants never appear, so one lowering serves every
    point of a sweep.
    """
    reads, writes = kernel.reads(), kernel.writes()
    fc = kernel.flops
    kinds: list[int] = []
    widths: list[int] = []
    levels: list[int] = []
    esrc: list[int] = []
    edst: list[int] = []

    def emit(kind: str, width: int, level: int, deps=()) -> int:
        idx = len(kinds)
        kinds.append(KIND_CODE[kind])
        widths.append(width)
        levels.append(level)
        for d in deps:
            esrc.append(d)
            edst.append(idx)
        return idx

    loads = [emit("LOAD", a.array.element_bytes, 0) for a in reads]

    def load_dep(i: int) -> tuple:
        return (loads[i % len(loads)],) if loads else ()

    eb = kernel.dtype_bytes
    muls = [emit("MUL", eb, 1, load_dep(2 * i) + load_dep(2 * i + 1))
            for i in range(fc.mul)]

    # accumulation chain: ADDs then FMAs then DIVs, each on the previous
    # chain element plus one product (FMAs also consume a load directly)
    chain = None
    level = 2
    for i in range(fc.add):
        deps = () if chain is None else (chain,)
        deps += (muls[i % len(muls)],) if muls else load_dep(i)
        chain = emit("ADD", eb, level, deps)
        level += 1
    for i in range(fc.fma):
        deps = () if chain is None else (chain,)
        deps += load_dep(i)
        chain = emit("FMA", eb, level, deps)
        level += 1
    for i in range(fc.div):
        deps = () if chain is None else (chain,)
        chain = emit("DIV", eb, level, deps)
        level += 1

    tail = (chain,) if chain is not None else \
        ((muls[-1],) if muls else (load_dep(0) or ()))
    for a in writes:
        emit("STORE", a.array.element_bytes, level, tail)

    return OpStream(kinds=np.array(kinds), widths=np.array(widths),
                    edge_src=np.array(esrc), edge_dst=np.array(edst),
                    levels=np.array(levels), carried=_carried_deps(kernel),
                    name=kernel.name)


# ----------------------------------------------------------------------
# Synthetic streams (benchmarks, scale tests)
# ----------------------------------------------------------------------

def synthetic_stream(n_products: int, n_iters: int = 1,
                     element_bytes: int = 8,
                     name: str = "synthetic") -> OpStream:
    """``n_iters`` independent sum-of-``n_products`` iterations, built
    directly as arrays — the large-scale input of scheduler benchmarks
    (a radius-R star stencil body unrolled
    ``n_iters`` times has exactly this shape: wide, with the dependence
    depth of one iteration)."""
    n, iters = int(n_products), int(n_iters)
    if n < 1 or iters < 1:
        raise ValueError("n_products and n_iters must be >= 1")
    # per iteration: 2n loads, n muls, n-1 chained adds, 1 store
    n_loads, n_adds = 2 * n, n - 1
    block = n_loads + n + n_adds + 1
    kinds = np.empty(block, dtype=np.int8)
    kinds[:n_loads] = KIND_CODE["LOAD"]
    kinds[n_loads:n_loads + n] = KIND_CODE["MUL"]
    kinds[n_loads + n:n_loads + n + n_adds] = KIND_CODE["ADD"]
    kinds[-1] = KIND_CODE["STORE"]

    mul0, add0 = n_loads, n_loads + n
    mul_idx = np.arange(n, dtype=np.int64) + mul0
    add_idx = np.arange(n_adds, dtype=np.int64) + add0
    # muls consume two loads each; adds chain and consume one mul each
    esrc = np.concatenate([
        np.arange(n_loads, dtype=np.int64),
        (np.concatenate([[mul0], add_idx[:-1]]) if n_adds
         else np.empty(0, dtype=np.int64)),
        mul_idx[1:1 + n_adds],
        np.array([add_idx[-1] if n_adds else mul0], dtype=np.int64)])
    edst = np.concatenate([
        np.repeat(mul_idx, 2), add_idx, add_idx,
        np.array([block - 1], dtype=np.int64)])
    levels = np.empty(block, dtype=np.int32)
    levels[:n_loads] = 0
    levels[mul_idx] = 1
    levels[add_idx] = 2 + np.arange(n_adds)
    levels[-1] = 2 + n_adds

    # tile the block: iterations are independent (no cross-block edges)
    off = np.arange(iters, dtype=np.int64) * block
    return OpStream(
        kinds=np.tile(kinds, iters),
        widths=np.full(block * iters, element_bytes, dtype=np.int32),
        edge_src=(esrc[None, :] + off[:, None]).ravel(),
        edge_dst=(edst[None, :] + off[:, None]).ravel(),
        levels=np.tile(levels, iters), name=name)
