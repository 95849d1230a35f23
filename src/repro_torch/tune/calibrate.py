"""Calibration: fold measured/predicted ratios back into the machine model.

The calibrate half of predict → measure → calibrate; a copy of
``repro.tune.calibrate``.  Each measured candidate yields a ratio
``measured / predicted``; grouping the log-ratios by the prediction's
binding term class gives multiplicative factors:

* ``compute`` — geometric-mean ratio over compute-bound candidates;
  scales the in-core terms of ECM and derates the peak in Roofline
  (``calibrated=True``, :mod:`repro_torch.core.ecm` /
  :mod:`repro_torch.core.roofline`).
* ``levels[L]`` — the same over candidates bound by memory level ``L``.
* ``time[family]`` — the overall geometric-mean ratio for this kernel
  family; the tuner multiplies it into its own predictions on the next
  run.

Factors land in a ``calibration:`` section of the machine YAML through
:func:`apply_calibration`, parsed and validated by
:meth:`repro_torch.core.machine.Machine.from_dict`.  On the H100 the
measurements come from CUDA events on the card, so a factor says how far
the closed-form model is from the card's kernel.
"""
from __future__ import annotations

import math
import pathlib
import re

import yaml

from ..core import machine as machine_mod
from ..core.machine import Machine


def prediction_error(pairs) -> dict:
    """Error summary over ``(predicted_s, measured_s)`` pairs:
    ``rms_log`` (RMS of log measured/predicted — 0 means perfect),
    ``geomean_ratio`` (bias direction), ``n``."""
    logs = [math.log(m / p) for p, m in pairs
            if p and m and p > 0 and m > 0 and math.isfinite(p)
            and math.isfinite(m)]
    if not logs:
        return {"n": 0}
    n = len(logs)
    return {"n": n,
            "rms_log": math.sqrt(sum(v * v for v in logs) / n),
            "geomean_ratio": math.exp(sum(logs) / n)}


def _geomean_ratio(samples) -> float | None:
    logs = [math.log(m / p) for p, m in samples
            if p and m and p > 0 and m > 0 and math.isfinite(p)
            and math.isfinite(m)]
    if not logs:
        return None
    return math.exp(sum(logs) / len(logs))


def derive_calibration(family: str, samples, machine: Machine,
                       meta: dict | None = None) -> dict:
    """Derive a full ``calibration`` mapping from measured candidates.

    ``samples`` is an iterable of ``(predicted_s, measured_s, bound)``
    triples where ``predicted_s`` is the *analytic* prediction (no
    calibration applied) and ``bound`` names the binding term class
    ('compute' or a level name).  Existing factors on ``machine`` for
    *other* levels/families are preserved; this family's groups are
    replaced.  Returns the new mapping (does not mutate the machine).
    """
    samples = list(samples)
    prev = machine.calibration or {}
    out: dict = {}
    # compute / per-level factors, grouped by binding term
    groups: dict[str, list] = {}
    for p, m, bound in samples:
        groups.setdefault(bound or "compute", []).append((p, m))
    levels = dict(prev.get("levels", {}))
    compute = prev.get("compute")
    for bound, pairs in groups.items():
        f = _geomean_ratio(pairs)
        if f is None:
            continue
        if bound == "compute":
            compute = f
        else:
            levels[bound] = f
    if compute is not None:
        out["compute"] = float(compute)
    if levels:
        out["levels"] = {k: float(v) for k, v in sorted(levels.items())}
    # whole-family wall-time factor (what the tuner re-applies)
    times = dict(prev.get("time", {}))
    f_time = _geomean_ratio([(p, m) for p, m, _ in samples])
    if f_time is not None:
        times[family] = float(f_time)
    if times:
        out["time"] = {k: float(v) for k, v in sorted(times.items())}
    err = prediction_error([(p, m) for p, m, _ in samples])
    out["meta"] = {**dict(prev.get("meta", {})),
                   f"{family}.n_samples": err.get("n", 0),
                   f"{family}.rms_log_before": err.get("rms_log"),
                   **(meta or {})}
    return out


_CAL_BLOCK = re.compile(r"(?ms)^calibration:[ \t]*\n(?:(?:[ \t].*)?\n?)*")


def machine_yaml_path(ref) -> pathlib.Path:
    """Resolve a ``-m`` style machine reference (path, bundled name, or
    alias) to the concrete YAML file calibration should be written to."""
    p = pathlib.Path(str(ref))
    if p.is_file():
        return p
    name = machine_mod.ALIASES.get(str(ref).upper(), str(ref))
    cand = machine_mod._MACHINE_DIR / name
    if not cand.is_file() and cand.suffix != ".yaml":
        cand = cand.with_suffix(".yaml")
    if cand.is_file():
        return cand
    raise ValueError(
        f"cannot resolve {ref!r} to a machine YAML file to calibrate "
        f"(pass an explicit path to --apply-calibration)")


def apply_calibration(path, calibration: dict) -> Machine:
    """Rewrite ``path``'s ``calibration:`` section (preserving every other
    line, including comments), validate the result through
    :meth:`Machine.from_dict`, and atomically replace the file.  Returns
    the re-parsed Machine."""
    path = pathlib.Path(path)
    text = path.read_text()
    body = _CAL_BLOCK.sub("", text)
    if not body.endswith("\n"):
        body += "\n"
    block = yaml.safe_dump({"calibration": calibration},
                           default_flow_style=False, sort_keys=True)
    new_text = body + "\n" + block
    # validate before touching the file: a bad mapping must not brick
    # the machine description
    mach = Machine.from_dict(yaml.safe_load(new_text))
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(new_text)
    tmp.replace(path)
    # the loader caches by name/path; drop stale entries so the next
    # load sees the calibrated file
    for attr in ("load", "from_yaml"):
        fn = getattr(machine_mod, attr, None)
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    return mach
