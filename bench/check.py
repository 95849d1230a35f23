"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's, by three numbers.

- ``loss_gap``: the largest relative gap of a step's loss,
  |L_program - L_reference| / |L_reference|, over the checked steps.
- ``grad_gap``: the step-0 gradient as the optimizer takes it (after
  clipping), read from the program's first moment after one step
  (m = (1 - b1)·g): for each layer slice of each weight, the gap between
  the program's norm and the reference's, over the reference's norm of
  that slice or of the median slice, whichever is larger; the worst
  slice.
- ``change_gap``: the same for each slice's change over the checked
  steps (the program's float32 master weights, which the next step
  keeps), leaving out slices whose reference gradient is under a
  thousandth of the median slice's (they move by round-off alone).
"""
from __future__ import annotations

import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def _num(x: float) -> float:
    """nan (a non-finite side) reads as infinitely far."""
    return float("inf") if x != x else x


def worst(prog: dict[str, float], ref: dict[str, float],
          keep=None) -> tuple[float, str]:
    names = [n for n in ref if keep is None or n in keep]
    floor = statistics.median(ref[n] for n in names)
    gaps = {n: _num(abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30))
            for n in names}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def readings(prog: dict, ref: dict) -> dict:
    """The three numbers (and the slice each worst one is at) of a
    program's record ``prog`` against the reference's ``ref``, each
    ``{"loss": [..], "grad": {slice: norm}, "change": {slice: norm}}``."""
    if set(prog["grad"]) != set(ref["grad"]):
        raise ValueError("the program's weights and the reference's differ "
                         "in their slices")
    loss = max(_num(abs(p - r) / abs(r)) for p, r in zip(prog["loss"],
                                                         ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = float("inf")
    floor = statistics.median(ref["grad"].values())
    moving = {n for n, g in ref["grad"].items() if g >= 1e-3 * floor}
    grad, gat = worst(prog["grad"], ref["grad"])
    change, cat = worst(prog["change"], ref["change"], moving)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "grad_at": gat, "change_at": cat,
            "left_out": sorted(set(ref["grad"]) - moving)}


def verdict(values: dict, limits: dict) -> dict:
    """``{number: {"value", "limit"}}`` for every number; a missing limit
    fails (nan never passes)."""
    return {n: {"value": values[n], "limit": limits.get(n, float("nan"))}
            for n in NUMBERS}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
