"""The tune loop: rank analytically, measure a shortlist, derive factors.

Counterpart of ``repro.tune.tuner``.  ``tune()`` is the one entry point
(``python -m repro_torch tune`` and ``repro_torch.core.api.tune`` both
land here): resolve the family's
:class:`~repro_torch.tune.space.CandidateSpace`, predict every candidate
in one call, measure the top-k plus the shipped default on the device,
pick the fastest measured candidate, and derive calibration factors from
the measured/predicted ratios.  With a
:class:`~repro_torch.service.AnalysisService` attached, whole reports
persist in the result store under kind ``"tune"``, keyed by the device
they were measured on: a warm replay decodes from disk and touches no
device.
"""
from __future__ import annotations

import torch

from .. import device as _device
from ..core import api
from ..core.machine import Machine
from ..kernels import _build
from . import calibrate as _calibrate
from .measure import measure_candidate
from .report import (STATUS_FAILED, STATUS_INFEASIBLE, STATUS_OK,
                     STATUS_PREDICTED, CandidateOutcome, TuneReport)
from .space import resolve_space

#: predicted (non-measured) candidates kept in the report
KEEP_PREDICTED = 32


def device_key(device, measure: bool) -> str | None:
    """The device part of a tune report's store key, where the JAX
    package keys its ``interpret`` flag: ``"cpu"``, or the card's name as
    ``torch.cuda.get_device_name`` gives it, so that a report measured on
    the CPU (or by the JAX package) is never replayed as a card's.  A
    request that measures nothing touches no device and keys ``None``."""
    if not measure:
        return None
    dev = _device.resolve(device)
    return "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)


def store_key(family: str, mach: Machine, config: dict, top_k: int,
              measure: bool, warmup: int, reps: int,
              device: str | None) -> tuple:
    """The result-store key of one tune request (``device`` as
    :func:`device_key` gives it)."""
    return ("tune", family, mach.fingerprint, tuple(sorted(config.items())),
            int(top_k), bool(measure), int(warmup), int(reps), device)


def tune(family: str, machine: Machine | str, *, config: dict | None = None,
         top_k: int = 4, measure: bool = True, warmup: int = 1,
         reps: int = 3, timeout_s: float = 120.0, isolate: bool = True,
         retries: int = 1, device=None, session=None, service=None,
         keep_predicted: int = KEEP_PREDICTED) -> TuneReport:
    """Autotune ``family`` on ``machine``; returns a :class:`TuneReport`.

    ``config`` overrides the family's problem shape (see the space's
    ``DEFAULTS``).  ``top_k`` candidates (by analytic prediction) plus the
    shipped default are measured with ``warmup``+``reps`` timed
    invocations each on ``device`` (resolved by
    :func:`repro_torch.device.resolve`: the card unless ``"cpu"`` is
    named), in isolated subprocesses with a ``timeout_s`` cap unless
    ``isolate=False``.  ``measure=False`` stops after the analytic ranking
    and touches no device (the chosen candidate is then the predicted
    best).  A machine carrying ``calibration.time[family]`` has that
    factor folded into the predictions.  ``session`` (an
    :class:`~repro_torch.core.session.AnalysisSession` bound to
    ``machine``) shares compiled plans across repeated rankings.
    ``service`` (an :class:`~repro_torch.service.AnalysisService`) serves
    the whole report through its memory, coalescing and disk tiers under
    :func:`store_key`.
    """
    mach = api.resolve_machine(machine)
    config = dict(config or {})
    if service is not None:
        key = store_key(family, mach, config, top_k, measure, warmup, reps,
                        device_key(device, measure))
        meta = {"kind": "tune", "family": family, "machine": mach.name,
                "machine_fingerprint": mach.fingerprint,
                "measured": bool(measure)}

        def compute():
            rep = tune(family, mach, config=config, top_k=top_k,
                       measure=measure, warmup=warmup, reps=reps,
                       timeout_s=timeout_s, isolate=isolate,
                       retries=retries, device=device, session=session,
                       keep_predicted=keep_predicted)
            return rep, rep.to_dict()

        def decode(payload):
            try:
                return TuneReport.from_dict(payload)
            except (KeyError, TypeError, ValueError):
                return None
        return service.serve_custom(key, compute, decode, meta=meta)
    space = resolve_space(family, mach, **config)
    cands = space.candidates()
    preds = space.predict(cands, session=session)
    time_factor = mach.calibration_factor("time", family)

    default = space.default()
    by_cand = dict(zip(cands, preds))

    feasible = [(c, p) for c, p in zip(cands, preds) if p.feasible]
    infeasible = [(c, p) for c, p in zip(cands, preds) if not p.feasible]
    feasible.sort(key=lambda cp: cp[1].seconds)

    def _pred_s(p) -> float:
        return p.seconds * time_factor

    shortlist = [c for c, _ in feasible[:max(1, top_k)]]
    if by_cand[default].feasible and default not in shortlist:
        shortlist.append(default)

    outcomes: dict = {}
    dev = None
    if measure:
        dev = _device.resolve(device)
        if dev.type == "cuda" and space.sources:
            _build.build_all(space.sources)   # children load, never build
        for cand in shortlist:
            tr = measure_candidate(family, space.config, cand.config, mach,
                                   device=dev, warmup=warmup, reps=reps,
                                   timeout_s=timeout_s, isolate=isolate,
                                   retries=retries)
            p = by_cand[cand]
            outcomes[cand] = CandidateOutcome(
                params=cand.config,
                status=STATUS_OK if tr.ok else STATUS_FAILED,
                predicted_s=_pred_s(p), bound=p.bound, measured=tr)

    # chosen: fastest measured candidate, else the predicted best
    measured_ok = [(c, o) for c, o in outcomes.items()
                   if o.status == STATUS_OK]
    if measured_ok:
        chosen, _ = min(measured_ok, key=lambda co: co[1].measured.wall_s)
    else:
        chosen = feasible[0][0] if feasible else default

    def _meas_s(cand) -> float | None:
        o = outcomes.get(cand)
        return o.measured_s if o is not None else None

    meas_chosen = _meas_s(chosen)
    meas_default = _meas_s(default)
    speedup = None
    if meas_chosen and meas_default and meas_chosen > 0:
        speedup = meas_default / meas_chosen

    # calibration from every successful measurement (analytic predictions,
    # not time_factor-scaled: derived factors are absolute)
    samples = [(by_cand[c].seconds, o.measured.wall_s, o.bound)
               for c, o in measured_ok]
    calibration: dict = {}
    error: dict = {"n": 0}
    if samples:
        error = _calibrate.prediction_error(
            [(_pred_s(by_cand[c]), o.measured.wall_s)
             for c, o in measured_ok])
        calibration = _calibrate.derive_calibration(
            family, samples, mach, meta={f"{family}.device": _name(dev)})

    # candidate list: measured outcomes first (ranked by prediction), then
    # the best predicted tail, then a few infeasible examples
    records: list[CandidateOutcome] = []
    for c, _ in feasible:
        if c in outcomes:
            records.append(outcomes[c])
    n_pred = 0
    for c, p in feasible:
        if c in outcomes or n_pred >= max(0, keep_predicted):
            continue
        records.append(CandidateOutcome(
            params=c.config, status=STATUS_PREDICTED,
            predicted_s=_pred_s(p), bound=p.bound))
        n_pred += 1
    for c, p in infeasible[:8]:     # a few examples of why points died
        records.append(CandidateOutcome(
            params=c.config, status=STATUS_INFEASIBLE, reason=p.reason))

    dflt_p = by_cand[default]
    return TuneReport(
        family=family, machine=mach.name,
        machine_fingerprint=mach.fingerprint,
        config=dict(space.config),
        options={"top_k": top_k, "measure": measure, "warmup": warmup,
                 "reps": reps, "isolate": isolate,
                 "device": _name(dev) if measure else None,
                 "time_factor": time_factor},
        candidates=tuple(records),
        n_enumerated=len(cands), n_feasible=len(feasible),
        default_params=default.config, chosen_params=chosen.config,
        predicted_chosen_s=_pred_s(by_cand[chosen]),
        predicted_default_s=(_pred_s(dflt_p) if dflt_p.feasible else None),
        measured_chosen_s=meas_chosen, measured_default_s=meas_default,
        speedup_vs_default=speedup, error=error, calibration=calibration)


def _name(dev: torch.device | None) -> str:
    """The device a measurement ran on, by name: the card's own name for
    CUDA, ``cpu`` for the host."""
    if dev is None or dev.type == "cpu":
        return "cpu"
    return f"{dev} ({torch.cuda.get_device_name(dev)})"
