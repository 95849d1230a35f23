"""Timing on the card: the measure half of predict → measure → calibrate.

``robust_median`` is a copy of ``repro.tune.measure``'s, ``TimedRun`` a
copy without the subprocess harness's fields.
:func:`time_cuda` replaces the JAX timer's ``jax.block_until_ready``: it
warms up, then records ``torch.cuda.Event`` pairs around runs of many
launches, synchronizes, and divides each ``elapsed_time`` by the launch
count.  It refuses a CPU device — a time taken on the CPU is never
reported as the card's.  Subprocess isolation and fault injection are not
ported.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class TimedRun:
    """One measurement outcome.

    ``wall_s`` is the IQR-robust median over ``samples`` (``inf`` when
    ``ok`` is False); ``rejected`` counts samples discarded as outliers.
    The JAX class's subprocess fields (error, timed_out, retries) wait for
    the port of its isolated harness.
    """
    ok: bool
    wall_s: float
    samples: tuple[float, ...] = ()
    rejected: int = 0
    warmup: int = 1
    reps: int = 5


def robust_median(samples) -> tuple[float, int]:
    """Median after Tukey-fence outlier rejection (1.5×IQR); returns
    ``(median, n_rejected)``.  With < 4 samples the plain median stands —
    quartiles of a triple are too noisy to reject on."""
    xs = sorted(float(s) for s in samples)
    n = len(xs)
    if n == 0:
        return math.inf, 0
    if n >= 4:
        def _q(p: float) -> float:
            k = p * (n - 1)
            lo = int(k)
            hi = min(lo + 1, n - 1)
            return xs[lo] + (k - lo) * (xs[hi] - xs[lo])
        q1, q3 = _q(0.25), _q(0.75)
        iqr = q3 - q1
        kept = [x for x in xs if q1 - 1.5 * iqr <= x <= q3 + 1.5 * iqr]
        if kept:
            rejected = n - len(kept)
            xs, n = kept, len(kept)
            mid = n // 2
            med = xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])
            return med, rejected
    mid = n // 2
    return (xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])), 0


def time_cuda(fn, device: torch.device | str = "cuda", warmup: int = 3,
              iters: int = 10, reps: int = 5) -> TimedRun:
    """Time ``fn()`` on the card: ``warmup`` untimed calls, then ``reps``
    samples of ``iters`` back-to-back calls each, bracketed by CUDA events
    on the current stream.  ``wall_s`` is the robust median of the
    per-call seconds."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"time_cuda times the card, got device {device}")
    with torch.cuda.device(device):
        for _ in range(max(0, warmup)):
            fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(max(1, reps))]
        for start, end in events:
            start.record()
            for _ in range(max(1, iters)):
                fn()
            end.record()
        torch.cuda.synchronize()
    samples = [s.elapsed_time(e) / 1e3 / max(1, iters) for s, e in events]
    med, rejected = robust_median(samples)
    return TimedRun(ok=True, wall_s=med, samples=tuple(samples),
                    rejected=rejected, warmup=warmup, reps=len(samples))
