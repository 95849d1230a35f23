"""The device trace of a window: ``torch.profiler`` over a few steps, the
named ranges the metric readers ask for, and what the readers read.

The program is not instrumented; the benchmark wraps the program
functions a reader names (``RANGES`` in its file, ``{range: "module:
attribute"}``) in ``record_function`` ranges of their own name while the
profiler runs, as ``chip_smoke.py``'s training profile does.  A kernel
belongs to a range when it starts within the range's span on the card's
timeline (the profiler's GPU user annotation).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import time

import torch


@dataclasses.dataclass
class Kernel:
    name: str
    start_us: float
    end_us: float
    range: str | None

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Trace:
    """What a traced run read, in two passes of ``steps`` steps each.
    The plain pass, after one step that warms the profiler up, records
    the device alone (its window: the host seconds of its steps, and the
    seconds in which some device operation ran); the ranged pass also
    records the host's operations and the named ranges, whose cost on
    the host would stretch the plain pass's idle time (device times are
    what it is read for)."""
    kernels: list[Kernel]                     # the ranged pass
    spans: dict[str, list[tuple[float, float]]]
    host: list[tuple[float, float, str]]
    steps: int
    window_s: float                           # the plain pass
    busy_s: float
    ops: list[list]                           # the plain pass's top ops

    def in_range(self, name: str) -> list[Kernel]:
        return [k for k in self.kernels if k.range == name]


def _merged(kernels) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for k in sorted(kernels, key=lambda k: k.start_us):
        if out and k.start_us <= out[-1][1]:
            out[-1][1] = max(out[-1][1], k.end_us)
        else:
            out.append([k.start_us, k.end_us])
    return [(a, b) for a, b in out]


def _resolve(target: str):
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


@contextlib.contextmanager
def ranges(wanted: dict[str, str]):
    """Wrap each ``module:attribute`` of ``wanted`` in a
    ``record_function`` range named by its key, and restore it after."""
    from torch.profiler import record_function
    saved = []
    for name, target in wanted.items():
        mod, attr = _resolve(target)
        real = getattr(mod, attr)

        def wrapped(*a, _real=real, _name=name, **kw):
            with record_function(_name):
                return _real(*a, **kw)
        saved.append((mod, attr, real))
        setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, real in reversed(saved):
            setattr(mod, attr, real)


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _profiled(run_steps, n: int, activities, warmup: int) -> tuple:
    """``run_steps(1)`` ``warmup`` times to warm the profiler up, then
    ``n`` steps recorded; returns the profile's events and the recorded
    steps' host seconds."""
    from torch.profiler import profile, schedule
    torch.cuda.synchronize()
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=warmup, active=n,
                                   repeat=1)) as p:
        for _ in range(warmup):
            run_steps(1)
            torch.cuda.synchronize()
            p.step()
        t0 = time.perf_counter()
        for i in range(n):
            run_steps(1)
            if i < n - 1:
                p.step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        p.step()
    return p.events(), window_s


def record(run_steps, n: int, wanted: dict[str, str]) -> Trace:
    """Trace ``run_steps`` (each call ends when its steps' results are on
    the host): a plain pass of ``n`` steps, then a ranged pass of ``n``
    steps under the ranges ``wanted``."""
    from torch.profiler import ProfilerActivity
    events, window_s = _profiled(run_steps, n, [ProfilerActivity.CUDA], 1)
    plain = [Kernel(e.name, e.time_range.start, e.time_range.end, None)
             for e in events if _is_device(e) and not e.is_user_annotation]
    busy_s = sum(b - a for a, b in _merged(plain)) / 1e6
    ops = device_ops(plain)
    del events, plain
    with ranges(wanted):
        events, _ = _profiled(run_steps, n, [ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA], 0)
    dev = [e for e in events if _is_device(e)]
    spans: dict[str, list[tuple[float, float]]] = {k: [] for k in wanted}
    for e in dev:
        if e.is_user_annotation and e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
    flat = sorted((a, b, name) for name, s in spans.items() for a, b in s)
    starts = [a for a, _, _ in flat]
    kernels = []
    for e in dev:
        if e.is_user_annotation:
            continue
        t0_us = e.time_range.start
        i = bisect.bisect_right(starts, t0_us)
        # the latest-starting span that holds the kernel's start
        rng = next((name for a, b, name in reversed(flat[max(0, i - 8):i])
                    if a <= t0_us < b), None)
        kernels.append(Kernel(e.name, t0_us, e.time_range.end, rng))
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if not _is_device(e))
    return Trace(kernels, spans, host, n, window_s, busy_s, ops)


def device_ops(kernels: list[Kernel], top: int = 10) -> list[list]:
    """The device operations that took most time: [name, seconds]."""
    by: dict[str, float] = {}
    for k in kernels:
        by[k.name] = by.get(k.name, 0.0) + k.us
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[n, us / 1e6] for n, us in rows]


def idle_gaps(trace: Trace, top: int = 10, longest: int = 400) -> list[list]:
    """The device's idle time between operations in the ranged pass, by
    what the host was doing at the middle of each gap (its innermost
    operation there): the ``longest`` gaps, summed by that name, as
    [name, seconds]."""
    busy = _merged(trace.kernels)
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])
                   if a1 > b0), key=lambda g: g[0] - g[1])[:longest]
    starts = [h[0] for h in trace.host]
    by: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "host between operations"
        for j in range(i, max(-1, i - 4000), -1):
            s, e, n = trace.host[j]
            if s <= mid < e:
                name = n
                break
        by[name] = by.get(name, 0.0) + (b - a)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[n, us / 1e6] for n, us in rows]
