"""Timing on the card: the measure half of predict → measure → calibrate.

Counterpart of ``repro.tune.measure``.  ``TimedRun``, ``robust_median``,
the fault hook and the subprocess harness are copies of the JAX
package's.  :func:`time_cuda` replaces the JAX timer's
``jax.block_until_ready``: it warms up, then records ``torch.cuda.Event``
pairs around runs of launches, synchronizes, and divides each
``elapsed_time`` by the launch count.  :func:`time_closure` uses it on a
CUDA device and a host clock only on a device the caller named ``cpu``:
a time taken on the CPU is never reported as the card's.

By default every candidate runs in its own spawned subprocess with a hard
timeout: a candidate that faults on the card, runs out of memory or hangs
is recorded as a failed :class:`TimedRun` and the tune run continues.
Children are spawned, never forked (the parent has initialised CUDA),
and import ``repro_torch`` from the ``PYTHONPATH`` this module sets; they
load the kernel libraries the parent built (``kernels/_build.py`` reuses
a library whose source hash matches).

Fault injection for tests: ``REPRO_TUNE_FAULT`` ∈ {``raise``, ``exit``,
``hang``} fires inside the measurement path, optionally gated by
``REPRO_TUNE_FAULT_MATCH`` (substring of the candidate's ``k=v,k=v``
parameter tag).
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing as mp
import os
import pathlib
import time

import torch

from ..core.machine import Machine

_SENTINEL = "repro_torch.tune"      # marker for error payloads


@dataclasses.dataclass(frozen=True)
class TimedRun:
    """One measurement outcome.

    ``wall_s`` is the IQR-robust median over ``samples`` (``inf`` when
    ``ok`` is False); ``rejected`` counts samples discarded as outliers;
    ``retries`` how many extra subprocess attempts the harness spent.
    """
    ok: bool
    wall_s: float
    samples: tuple[float, ...] = ()
    rejected: int = 0
    warmup: int = 1
    reps: int = 5
    error: str = ""
    timed_out: bool = False
    retries: int = 0

    def to_dict(self) -> dict:
        return {"ok": self.ok, "wall_s": self.wall_s,
                "samples": list(self.samples), "rejected": self.rejected,
                "warmup": self.warmup, "reps": self.reps,
                "error": self.error, "timed_out": self.timed_out,
                "retries": self.retries}

    @classmethod
    def from_dict(cls, d: dict) -> "TimedRun":
        return cls(ok=bool(d["ok"]), wall_s=float(d["wall_s"]),
                   samples=tuple(float(s) for s in d.get("samples", [])),
                   rejected=int(d.get("rejected", 0)),
                   warmup=int(d.get("warmup", 1)),
                   reps=int(d.get("reps", 5)),
                   error=str(d.get("error", "")),
                   timed_out=bool(d.get("timed_out", False)),
                   retries=int(d.get("retries", 0)))


@dataclasses.dataclass(frozen=True)
class Bound:
    """The least time the card could take for one call: the bytes that
    must move (each input read once, the output written once) at the HBM
    rate, and the operations at the peak rate for their type."""
    bytes: int
    bytes_s: float
    ops_s: float

    @property
    def seconds(self) -> float:
        return max(self.bytes_s, self.ops_s)

    @property
    def by(self) -> str:
        return "bytes" if self.bytes_s >= self.ops_s else "operations"


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


def time_closure(fn, device: torch.device | str, warmup: int = 1,
                 reps: int = 5) -> TimedRun:
    """Time ``fn()``: ``warmup`` untimed calls and ``reps`` timed samples
    of one call each, IQR-robust median.  On a CUDA device through
    :func:`time_cuda`; on the CPU with ``time.perf_counter``, which is
    taken only when ``device`` names the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return time_cuda(fn, device, warmup=warmup, iters=1, reps=reps)
    if device.type != "cpu":
        raise ValueError(f"cannot time on device {device}")
    for _ in range(max(0, warmup)):
        fn()
    samples = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    med, rejected = robust_median(samples)
    return TimedRun(ok=True, wall_s=med, samples=tuple(samples),
                    rejected=rejected, warmup=warmup, reps=reps)


def _params_tag(params: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(params.items()))


def _maybe_fault(params: dict) -> None:
    """Test hook: crash/raise/hang inside the measurement path on demand."""
    fault = os.environ.get("REPRO_TUNE_FAULT")
    if not fault:
        return
    match = os.environ.get("REPRO_TUNE_FAULT_MATCH", "")
    if match and match not in _params_tag(params):
        return
    if fault == "exit":
        os._exit(3)
    if fault == "hang":
        time.sleep(3600)
    raise RuntimeError(
        f"injected tune fault (REPRO_TUNE_FAULT={fault}) for "
        f"[{_params_tag(params)}]")


def _run_inproc(family: str, config: dict, params: dict, machine: Machine,
                device: str, warmup: int, reps: int) -> TimedRun:
    from .space import resolve_space
    _maybe_fault(params)
    space = resolve_space(family, machine, **config)
    fn = space.runner(params, device)
    return time_closure(fn, device, warmup=warmup, reps=reps)


def _child_entry(conn, family: str, config: dict, params: dict,
                 machine: Machine, device: str, warmup: int,
                 reps: int) -> None:
    """Subprocess entry point (module-level for spawn picklability)."""
    try:
        tr = _run_inproc(family, config, params, machine, device, warmup,
                         reps)
        conn.send({_SENTINEL: "ok", "run": tr.to_dict()})
    except BaseException as exc:  # noqa: BLE001 — report, don't die silently
        try:
            conn.send({_SENTINEL: "error",
                       "error": f"{type(exc).__name__}: {exc}"})
        except Exception:  # noqa: BLE001 — the parent records the death
            pass
    finally:
        conn.close()


def _ensure_importable_env() -> tuple[str, str | None]:
    """Make sure spawned children can ``import repro_torch``; returns
    (key, previous) to restore."""
    src = str(pathlib.Path(__file__).resolve().parents[2])
    old = os.environ.get("PYTHONPATH")
    parts = (old.split(os.pathsep) if old else [])
    if src not in parts:
        os.environ["PYTHONPATH"] = os.pathsep.join([src] + parts)
    return "PYTHONPATH", old


def measure_candidate(family: str, config: dict, params: dict,
                      machine: Machine, *, device: torch.device | str,
                      warmup: int = 1, reps: int = 3,
                      timeout_s: float = 120.0, isolate: bool = True,
                      retries: int = 1) -> TimedRun:
    """Measure one candidate on ``device``; never raises for
    candidate-side failures.

    ``isolate=True`` (default) runs the measurement in a spawned
    subprocess with a ``timeout_s`` wall clock and up to ``retries``
    extra attempts after a crash — a launch fault, an out-of-memory kill
    or a hang becomes a ``TimedRun(ok=False, ...)`` record.  Timeouts are
    not retried: a config that hangs once will hang again.
    """
    device = str(torch.device(device))
    if not isolate:
        try:
            return _run_inproc(family, dict(config), dict(params), machine,
                               device, warmup, reps)
        except Exception as exc:  # noqa: BLE001
            return TimedRun(ok=False, wall_s=math.inf, warmup=warmup,
                            reps=reps, error=f"{type(exc).__name__}: {exc}")

    ctx = mp.get_context("spawn")
    key, old = _ensure_importable_env()
    last_err, timed_out = "no attempt ran", False
    try:
        for attempt in range(max(0, retries) + 1):
            parent, child = ctx.Pipe(duplex=False)
            proc = ctx.Process(
                target=_child_entry,
                args=(child, family, dict(config), dict(params), machine,
                      device, warmup, reps))
            proc.start()
            child.close()
            payload = None
            try:
                if parent.poll(timeout_s):
                    payload = parent.recv()
                else:
                    timed_out = True
            except (EOFError, OSError):
                pass          # child died before sending
            finally:
                parent.close()
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
            if payload is not None and payload.get(_SENTINEL) == "ok":
                tr = TimedRun.from_dict(payload["run"])
                return dataclasses.replace(tr, retries=attempt)
            if timed_out:
                last_err = (f"timed out after {timeout_s:g}s "
                            f"[{_params_tag(params)}]")
                break         # hangs are deterministic; don't retry
            if payload is not None:
                last_err = str(payload.get("error", "unknown child error"))
            else:
                last_err = (f"measurement child died (exit code "
                            f"{proc.exitcode}) [{_params_tag(params)}]")
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old
    return TimedRun(ok=False, wall_s=math.inf, warmup=warmup, reps=reps,
                    error=last_err, timed_out=timed_out,
                    retries=max(0, retries) if not timed_out else 0)
