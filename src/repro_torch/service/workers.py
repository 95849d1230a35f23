"""Sweep worker pool: shard dense grids across processes (a copy of
``repro.service.workers``).

A sweep over a large parameter grid is embarrassingly parallel across
values — the compiled plan (:mod:`repro_torch.core.compiled`) batches the
whole grid on one core, but plan compilation, regime representatives,
and the SIM predictor's per-point simulations still serialize.  The pool
chunks the grid into contiguous shards, runs each shard through a fresh
:class:`~repro_torch.core.session.AnalysisSession` in its own process
(``sweep(compiled=...)`` — each worker compiles the plan once for its
chunk), ships the deduplicated ``to_dict`` payloads back, and merges them
in value order.  The merged lists are bit-for-bit ``to_dict``-identical
to a sequential sweep, which the service layer relies on to back-fill
the shared disk store.

Workers are spawned, never forked: the parent may hold a CUDA context
(``chip_smoke.py`` calls the pool from the process that drives the card),
and a forked child would inherit it.  Each child imports this module and
the analytic core behind it, which import no torch, plus whatever the
parent's main module imports: spawn re-runs a main *script* in every
child (``python3 chip_smoke.py`` brings torch along), while ``python -m
repro_torch`` and ``python -c`` add nothing.  The children locate
:mod:`repro_torch` through ``PYTHONPATH``, which :func:`sweep_sharded`
extends with the package root when needed.

Fault injection for tests: ``REPRO_TORCH_WORKER_FAULT`` ∈ {``exit``,
``raise``} fires in every worker before its shard runs.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pathlib
from concurrent.futures import ProcessPoolExecutor

from repro_torch.core.kernel_ir import LoopKernel
from repro_torch.core.machine import Machine
from repro_torch.core.session import AnalysisSession

from .store import decode_results, encode_results


def chunk_values(values: list, workers: int) -> list[list]:
    """Split ``values`` into at most ``workers`` contiguous chunks whose
    sizes differ by at most one (order preserved)."""
    workers = max(1, int(workers))
    base, extra = divmod(len(values), workers)
    out, i = [], 0
    for j in range(workers):
        size = base + (1 if j < extra else 0)
        if size:
            out.append(values[i:i + size])
            i += size
    return out


def _run_chunk(machine: Machine, kernel: LoopKernel, param,
               values, models: tuple, predictor: str, cores,
               sim_kwargs: dict | None, incore: str, compiled,
               opts: dict) -> dict:
    """Worker entry: one shard through a fresh session, results wire-
    encoded (unique payloads + index) to keep IPC proportional to the
    number of LC regimes, not grid points."""
    fault = os.environ.get("REPRO_TORCH_WORKER_FAULT")
    if fault == "exit":        # test hook: hard-kill mid-shard (no cleanup)
        os._exit(3)
    elif fault == "raise":     # test hook: ordinary in-worker exception
        raise RuntimeError(
            "injected worker fault (REPRO_TORCH_WORKER_FAULT)")
    sess = AnalysisSession(machine)
    out = sess.sweep(kernel, param, values, models=models,
                     predictor=predictor, cores=cores,
                     sim_kwargs=sim_kwargs, incore=incore,
                     compiled=compiled, **opts)
    return {m: encode_results(rs) for m, rs in out.items()}


def _ensure_importable_env() -> tuple[str, str | None]:
    """Point spawned children's ``PYTHONPATH`` at the directory holding
    ``repro_torch``; returns (key, previous value) so the caller can
    restore it."""
    src_root = str(pathlib.Path(__file__).resolve().parents[2])
    old = os.environ.get("PYTHONPATH")
    if src_root not in (old or "").split(os.pathsep):
        os.environ["PYTHONPATH"] = (src_root + os.pathsep + old
                                    if old else src_root)
    return "PYTHONPATH", old


def sweep_sharded(kernel: LoopKernel, machine: Machine, param,
                  values=None, models=("ecm",), predictor: str = "LC",
                  cores=1, sim_kwargs: dict | None = None,
                  incore: str = "simple", compiled: bool | str = "auto",
                  workers: int = 2, opts: dict | None = None) -> dict:
    """Evaluate a sweep across a pool of worker processes.

    ``param``/``values``/``cores`` follow :meth:`AnalysisSession.sweep`:
    a ``{symbol: values}`` mapping and/or a cores sequence describe an
    N-D grid.  Sharding is by contiguous tiles of the **outermost** axis
    (the first ``param`` symbol, or the value list for 1-D sweeps) —
    C-order flattening makes the merged chunks exactly the sequential
    point order, and each worker still batches its whole tile through
    one compiled plan.

    Returns the same ``{model: [Result per point]}`` mapping as
    :meth:`AnalysisSession.sweep`, with results that serialize
    identically (``to_dict`` parity is pinned by the tests).
    Regime-shared results stay shared objects even across shard
    boundaries.  With one chunk (or one value)
    the pool is skipped entirely.
    """
    if not isinstance(kernel, LoopKernel):
        raise TypeError(
            "worker-pool sweeps vary symbolic loop constants, which only "
            f"LoopKernel sources carry (got {type(kernel).__name__})")
    nd = isinstance(param, dict)
    if nd:
        if values is not None:
            raise ValueError(
                "pass axis values inside the {symbol: values} mapping, "
                "not through values=")
        axes = {str(s): list(vs) for s, vs in param.items()}
        outer = next(iter(axes))
        outer_vals = axes[outer]
    else:
        values = list(values)
        outer_vals = values
    model_names = [str(m) for m in models]
    chunks = chunk_values(outer_vals, workers)
    if len(chunks) <= 1:
        sess = AnalysisSession(machine)
        return sess.sweep(kernel, dict(axes) if nd else param, values,
                          models=model_names,
                          predictor=predictor, cores=cores,
                          sim_kwargs=sim_kwargs, incore=incore,
                          compiled=compiled, **(opts or {}))
    ctx = mp.get_context("spawn")
    env_key, env_old = _ensure_importable_env()

    def _shard(chunk):
        if nd:
            return {**{outer: chunk},
                    **{s: vs for s, vs in axes.items() if s != outer}}, None
        return param, chunk

    try:
        with ProcessPoolExecutor(max_workers=len(chunks),
                                 mp_context=ctx) as ex:
            futs = []
            for c in chunks:
                param_c, values_c = _shard(c)
                futs.append(ex.submit(
                    _run_chunk, machine, kernel, param_c, values_c,
                    tuple(model_names), predictor, cores,
                    sim_kwargs, incore, compiled, opts or {}))
            parts = [f.result() for f in futs]
    finally:
        if env_old is None:
            os.environ.pop(env_key, None)
        else:
            os.environ[env_key] = env_old
    out: dict[str, list] = {m: [] for m in model_names}
    shared: dict[str, object] = {}
    for part in parts:
        for m in model_names:
            out[m].extend(decode_results(part[m], shared=shared))
    return out
