"""The check against the faults a training cell can have: a run with
the timed path broken underneath (``bench/faults.py``) comes out not
correct, a sound one correct, and the control (the reference with its
products in float8, in the program's place) reads well above the
program.  Tiny cells on the CPU, the look for a card skipped; each
cell's limits here are set from three sound tiny runs, as the committed
ones are from the chip's."""
from __future__ import annotations

import time

import pytest

from bench import check, faults, harness
from bench.tests import _tiny

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.fixture(scope="module")
def sound():
    """Per cell, the sound tiny runs over SEEDS: (readings, cell, seed,
    pool, reference record), computed once."""
    found: dict = {}

    def rows(name: str) -> list:
        if name not in found:
            cell = _tiny.cell(name)
            found[name] = []
            for seed in SEEDS:
                prog = harness.Program(cell, seed, "cpu")
                rec = prog.checked_steps(cell.workload["checked_steps"])
                ref = harness.reference_record(cell, seed, prog.pool, "cpu")
                found[name].append((check.readings(rec, ref), cell, seed,
                                    prog.pool, ref))
        return found[name]
    return rows


def run(name: str, seed: int, rows: list) -> dict:
    """A tiny run of ``name`` whose limits are four times the largest
    sound readings."""
    limits = {n: 4 * max(r[0][n] for r in rows) for n in check.NUMBERS}
    cell = _tiny.cell(name, **limits)
    out, _ = harness.run_cell(cell, seed, 0.2, False, "cpu",
                              time.perf_counter())
    return out


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_a_sound_run_is_correct(name, sound):
    out = run(name, 2 ** 31 + 21, sound(name))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", _tiny.CELLS)
def test_a_fault_comes_out_not_correct(name, fault, sound):
    rows = sound(name)
    with faults.FAULTS[fault]():
        out = run(name, 2 ** 31 + 22, rows)
    assert not out["correct"], out["checks"]


def test_an_unchanged_state_reads_one(sound):
    name = _tiny.CELLS[0]
    rows = sound(name)
    with faults.unchanged_state():
        out = run(name, 2 ** 31 + 23, rows)
    assert out["checks"]["grad_gap"]["value"] == pytest.approx(1.0)
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_the_control_reads_three_times_the_program(name, sound):
    """On each seed the float8 control reads at least three times the
    largest sound reading on one of the numbers."""
    top = {n: max(r[0][n] for r in sound(name)) for n in check.NUMBERS}
    for _, cell, seed, pool, ref in sound(name):
        ctl = harness.reference_record(cell, seed, pool, "cpu", "fp8")
        got = check.readings(ctl, ref)
        assert max(got[n] / top[n] for n in check.NUMBERS) >= 3.0, got
