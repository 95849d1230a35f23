"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell needs found by its name."""
from __future__ import annotations

import json
import re

import pytest

from bench import harness

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "bench/run.py"]
    assert MANIFEST["paths"] == ["bench"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in MANIFEST["configs"]] + CELLS + \
        [m["name"] for m in METRICS]
    for n in names:
        assert NAME.match(n), n
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in MANIFEST["workloads"] + MANIFEST["configs"]:
        assert LINE.match(w["why"]), w["name"]
    for m in MANIFEST["per_layer"]:
        assert LINE.match(m["layer"])


def test_entries_have_just_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    for cell in CELLS:
        c = harness.load_cell(cell)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in names


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = harness.load_cell(cell)
    conf = next(x for x in MANIFEST["configs"]
                if x["name"] == c.config["name"])
    assert (ROOT / conf["file"]).is_file()
    assert (ROOT / "bench" / "reference"
            / f"{c.model['family']}.py").is_file()
    assert set(c.config["reduced"]) == set(conf["reduced"])
    assert c.workload["config"] == c.config["name"]
    assert c.workload["traffic"] == next(
        w["traffic"] for w in MANIFEST["workloads"] if w["name"] == cell)
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]).read)
    assert set(c.workload["limits"]) >= {"loss_gap", "grad_gap",
                                         "change_gap"}


def test_configuration_files_agree_with_their_model_blocks():
    g = json.loads((ROOT / "bench/configs/granite-8b-9L.json").read_text())
    m = g["model"]
    assert (m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"],
            m["d_ff"], m["vocab"], m["rope_theta"]) == (
        g["num_hidden_layers"], g["hidden_size"], g["num_attention_heads"],
        g["num_key_value_heads"], g["intermediate_size"], g["vocab_size"],
        g["rope_theta"])
    s = json.loads((ROOT / "bench/configs/mamba2-2.7b-32L.json").read_text())
    m = s["model"]
    assert (m["n_layers"], m["d_model"], m["vocab"]) == (
        s["n_layer"], s["d_model"], s["vocab_size"])
    assert m["n_heads"] == m["ssm"]["expand"] * m["d_model"] \
        // m["ssm"]["headdim"]


def test_run_refuses_without_a_card(tmp_path):
    """Where no CUDA card is visible the run exits non-zero and prints
    no result."""
    import subprocess
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         CELLS[0], "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
