"""The readers of the program's spans on tiny CPU steps: each new
reader gives a finite number from a store a tiny step filled, and none
from an empty store; and the ranges ``bench/trace.py`` wraps around
program functions for the older readers still wrap them and still show
in a profile, so those readers cannot silently fall silent."""
from __future__ import annotations

import json
import math
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from bench import harness
from bench import trace as trace_mod
from bench.tests import _tiny

from repro_torch import obs

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in MANIFEST["per_layer"]
                if m["source"] == "program_span"]
CASES = [(m["name"], cell) for m in SPAN_METRICS for cell in m["workloads"]]
#: the program functions the older readers wrap, by range name
WRAPPED = {"adamw_update": "repro_torch.train.step:adamw_update",
           "flash_attention_backward":
           "repro_torch.kernels.flash_attention:flash_attention_backward",
           "ssd": "repro_torch.models.mamba2:_ssd"}


def _ctx(steps: int = 1):
    return types.SimpleNamespace(trace=types.SimpleNamespace(steps=steps))


def _program(cell_name: str):
    return harness.Program(_tiny.cell(cell_name), 2 ** 31 + 11, "cpu")


@pytest.fixture(autouse=True)
def _empty_store():
    obs.clear()
    yield
    obs.clear()


def test_the_span_metrics_are_the_six_new_ones():
    assert [m["name"] for m in SPAN_METRICS] == [
        "attention_ms.train", "mlp_ms.train", "ssd_ms.train",
        "loss_ms.train", "recompute_ms.train", "step_untraced_ms.train"]
    for m in SPAN_METRICS:
        assert (m["unit"], m["better"], m["moves"]) == (
            "ms", "lower", "train_tokens_s")
        assert not hasattr(harness.reader(m["name"]), "RANGES")


@pytest.mark.parametrize("metric,cell", CASES)
def test_reader_reads_a_tiny_step(metric, cell):
    prog = _program(cell)
    with profile(activities=[ProfilerActivity.CPU]):
        prog.step()
    prog.step()                          # outside the profiler: no spans
    assert len(obs.steps()) == 1
    v = harness.reader(metric).read(_ctx())
    assert v is not None and math.isfinite(v) and v >= 0.0, v


@pytest.mark.parametrize("metric", [m["name"] for m in SPAN_METRICS])
def test_reader_gives_none_from_an_empty_store(metric):
    assert harness.reader(metric).read(_ctx()) is None


def test_readers_take_the_first_steps_the_store_holds():
    """Two passes of two steps: the readers read the first two."""
    prog = _program("granite-8b-9L.train_4k")
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            prog.step()
            prog.step()
    trees = obs.steps()
    assert len(trees) == 4
    untraced = harness.reader("step_untraced_ms.train").read(_ctx(2))
    assert untraced == pytest.approx(
        sum(t.self_ms("device") for t in trees[:2]) / 2)


def test_older_readers_still_wrap_their_three_functions():
    wanted = {}
    for m in MANIFEST["per_layer"]:
        wanted.update(getattr(harness.reader(m["name"]), "RANGES", {}))
    assert wanted == WRAPPED


@pytest.mark.parametrize("cell,names", [
    ("granite-8b-9L.train_4k", ("adamw_update", "flash_attention_backward")),
    ("mamba2-2.7b-32L.train_4k", ("adamw_update", "ssd"))])
def test_wrapped_ranges_show_in_a_tiny_profile(cell, names):
    prog = _program(cell)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        prog.step()
    seen = {e.name for e in p.events()}
    # the program's spans are there, none under a wrapped range's name,
    # which would add to that range's count of calls
    assert {"train.step", "optim.adamw", "lm.layer"} <= seen
    assert not seen & set(WRAPPED)
    with trace_mod.ranges(WRAPPED):
        with profile(activities=[ProfilerActivity.CPU]) as p:
            prog.step()
    seen = {e.name for e in p.events()}
    for name in names:
        assert name in seen, name
    for target in WRAPPED.values():      # restored after
        mod, attr = trace_mod._resolve(target)
        assert getattr(mod, attr).__name__ == attr, target
