"""Spans at the layer boundaries of the port's training step, forward and
backward, kept in memory.

A span records its name, its parent (the innermost span open on the
same thread, else the step open on any thread: autograd runs a CUDA
backward on a thread of its own), its phase, and two intervals in ms
from its step's start: the host's (``time.perf_counter``) and the
device's (a pair of CUDA timing events on the current stream, resolved
when the store is read; on a CPU, where work runs as the host issues
it, the host's).  Phases:

- ``"fwd"``, the first forward;
- ``"recompute"``, a forward run again by ``torch.utils.checkpoint``
  inside the backward (``torch._C._current_graph_task_id() != -1``);
- ``"bwd"``, a span's own backward: :func:`layer` puts an identity
  ``autograd.Function`` at the layer's inputs and one at each output;
  the first output's backward opens the span, the inputs' closes it;
- ``None``, for the step and the optimizer, which autograd never sees.

A span without a parent is a root: ``train.step`` is one, and every
span opened during a step joins its tree.  The store keeps the last
:data:`KEEP` whole trees and counts the spans opened by (name, phase).

Spans are on exactly while a ``torch.profiler`` profile records
(``torch.autograd.profiler._is_profiler_enabled``); each then also
enters a profiler range of its own name (``_RecordFunctionFast``,
``record_function``'s light twin), which puts it on the profiler's
timeline.  Off, :func:`span` and :func:`layer` cost one
check, no boundary enters the autograd graph, and the program computes
what it computes without them, bit for bit.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable

import torch
import torch.autograd.profiler as _prof
from torch.utils._pytree import tree_flatten, tree_unflatten

#: whole trees kept, oldest dropped first
KEEP = 16
#: the phase a span takes from where it opens: "fwd", or "recompute"
#: inside a backward
AUTO = "auto"

_OFF = contextlib.nullcontext()
#: the profiler range a span enters: ``record_function``'s light twin
_RANGE = torch._C._profiler._RecordFunctionFast


class Span:
    """One span; ``host`` and ``device`` are (start, end) in ms from the
    root's start, ``device`` None until the store is read."""
    __slots__ = ("name", "phase", "parent", "children", "root", "host",
                 "device", "_t", "_ev", "_rf", "open")

    def __init__(self, name: str, phase: str | None, parent: Span | None):
        self.name, self.phase, self.parent = name, phase, parent
        self.children: list[Span] = []
        self.root = self if parent is None else parent.root
        self.host = self.device = None
        self._ev = None
        self.open = True

    def walk(self):
        """This span and every span below it, parents first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def interval(self, clock: str = "device") -> tuple[float, float]:
        return self.device if clock == "device" else self.host

    def self_ms(self, clock: str = "device") -> float:
        """The span's interval less the union of its children's."""
        a, b = self.interval(clock)
        return (b - a) - covered([c.interval(clock) for c in self.children],
                                 (a, b))


def covered(intervals, within: tuple[float, float]) -> float:
    """The length of the union of ``intervals`` inside ``within``."""
    lo, hi = within
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


class Store:
    """The spans of the last :data:`KEEP` steps, and the count of spans
    opened by (name, phase)."""

    def __init__(self, keep: int = KEEP):
        self.trees: collections.deque[Span] = collections.deque(maxlen=keep)
        self.counts: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._root: Span | None = None
        self._pool: list = []            # timing events free for reuse
        self._streams: dict = {}

    def _stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        while st and not st[-1].open:    # closed by its root's end
            st.pop()
        return st

    def _event(self):
        """A timing event recorded on the current stream.  The stream's
        Python object is kept by its key: making one costs more than the
        record itself."""
        ev = self._pool.pop() if self._pool else \
            torch.cuda.Event(enable_timing=True)
        key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.current_stream()
        ev.record(stream)
        return ev

    def open(self, name: str, phase: str | None) -> Span:
        if phase == AUTO:
            phase = "recompute" if torch._C._current_graph_task_id() != -1 \
                else "fwd"
        st = self._stack()
        parent = st[-1] if st else self._root
        sp = Span(name, phase, parent)
        with self._lock:
            self.counts[(name, phase)] += 1
            if parent is None:
                self._root = sp
                sp._t = time.perf_counter()
            else:
                parent.children.append(sp)
        if parent is None:
            sp._ev = None
            if torch.cuda.is_initialized():
                self._recycle()
                sp._ev = [self._event()]
        elif sp.root._ev is not None:
            sp._ev = [self._event()]
        sp.host = ((time.perf_counter() - sp.root._t) * 1e3, None)
        sp._rf = _RANGE(name)
        sp._rf.__enter__()
        st.append(sp)
        return sp

    def close(self, sp: Span) -> None:
        if not sp.open:
            return
        sp._rf.__exit__(None, None, None)
        if sp._ev is not None:
            sp._ev.append(self._event())
        sp.host = (sp.host[0], (time.perf_counter() - sp.root._t) * 1e3)
        sp.open = False
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        if sp.parent is not None:
            return
        whole = True
        for s in sp.walk():              # left open: the tree is cut
            if s.open:
                whole = False
                self.close(s)
        with self._lock:
            if self._root is sp:
                self._root = None
            if whole:
                self.trees.append(sp)

    def _resolve(self, tree: Span) -> None:
        """Each span's device interval from its events (the host's where
        the step recorded none), and the events back to the pool."""
        start = None if tree._ev is None else tree._ev[0]
        done = []
        for s in tree.walk():
            if start is None:
                s.device = s.host
                continue
            s.device = tuple(start.elapsed_time(e) for e in s._ev)
            done.append(s)
        for s in done:
            self._pool.extend(s._ev)
            s._ev = None

    def _recycle(self) -> None:
        """Resolve the kept trees the card has finished (their root's end
        event has passed), so that a new step reuses their events: making
        an event costs more than resolving one."""
        for t in list(self.trees):
            if t.device is None and t._ev is not None and t._ev[1].query():
                self._resolve(t)

    def steps(self, name: str = "train.step") -> list[Span]:
        """The whole trees kept whose root is ``name``, oldest first,
        with their device intervals resolved (after a synchronize)."""
        trees = [t for t in self.trees if t.name == name]
        todo = [t for t in trees if t.device is None]
        if any(t._ev is not None for t in todo):
            torch.cuda.synchronize()
        for t in todo:
            self._resolve(t)
        return trees

    def clear(self) -> None:
        self.trees.clear()
        self.counts.clear()


STORE = Store()


class _Open:
    __slots__ = ("name", "phase", "sp")

    def __init__(self, name: str, phase: str | None):
        self.name, self.phase = name, phase

    def __enter__(self):
        self.sp = STORE.open(self.name, self.phase)
        return self.sp

    def __exit__(self, *exc):
        STORE.close(self.sp)
        return False


def span(name: str, phase: str | None = AUTO):
    """A context manager: span ``name`` around its body, closed however
    the body ends.  ``phase`` as in the module docstring; by default
    ``"fwd"`` or ``"recompute"`` from where it opens."""
    if not _prof._is_profiler_enabled:
        return _OFF
    return _Open(name, phase)


class _Twin:
    """A layer's backward span, shared by its boundaries: opened by the
    first output's backward, closed by the inputs'."""
    __slots__ = ("name", "sp", "opened")

    def __init__(self, name: str):
        self.name, self.sp, self.opened = name, None, False


class _Into(torch.autograd.Function):
    """Identity at a layer's inputs; its backward, the last of the
    layer's, closes the layer's backward span."""

    @staticmethod
    def forward(ctx, twin, *xs):
        ctx.twin = twin
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.twin.sp is not None:
            STORE.close(ctx.twin.sp)
            ctx.twin.sp = None
        return (None,) + gs


class _Out(torch.autograd.Function):
    """Identity at one of a layer's outputs; the first such backward of
    the layer's opens the layer's backward span.  One node an output: an
    output nothing uses (a scan's final state) then keeps its producers
    out of the backward, as it does without the boundary."""

    @staticmethod
    def forward(ctx, twin, y):
        ctx.twin = twin
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        twin = ctx.twin
        if not twin.opened:
            twin.opened = True
            twin.sp = STORE.open(twin.name, "bwd")
        return None, g


def _needs_grad(t) -> bool:
    return isinstance(t, torch.Tensor) and t.requires_grad


def layer(name: str, fn: Callable, *xs):
    """``fn(*xs)`` inside span ``name``, with its backward as the span's
    ``"bwd"`` twin: ``xs`` are the activations entering the layer, the
    tensors ``fn`` returns those leaving it; only those that need a
    gradient pass the boundaries.  Every use of an input must lie inside
    ``fn``, a residual's too: the gradients that meet at the input
    boundary are summed there, in the order autograd would sum them
    without it, so the numbers stay the same to the bit."""
    if not _prof._is_profiler_enabled:
        return fn(*xs)
    # a re-forward's graph is dropped once its saved tensors are taken:
    # boundaries there would never see a backward
    idx = [] if torch._C._current_graph_task_id() != -1 else \
        [i for i, x in enumerate(xs) if _needs_grad(x)]
    twin = None
    if idx and torch.is_grad_enabled():
        twin = _Twin(name)
        xs = list(xs)
        for i, x in zip(idx, _Into.apply(twin, *(xs[i] for i in idx))):
            xs[i] = x
    with _Open(name, AUTO):
        out = fn(*xs)
    if twin is None:
        return out
    flat, spec = tree_flatten(out)
    return tree_unflatten([_Out.apply(twin, y) if _needs_grad(y) else y
                           for y in flat], spec)


def steps(name: str = "train.step") -> list[Span]:
    """:meth:`Store.steps` of the process's store."""
    return STORE.steps(name)


def counts() -> dict:
    """Spans opened by (name, phase) since the store was last cleared."""
    with STORE._lock:
        return dict(STORE.counts)


def clear() -> None:
    STORE.clear()
