"""The port's dry run (``repro_torch.launch.dryrun``): one production
cell on the host as rank 0 of a fake 256-rank process group, priced on
the H100; the cell list against ``configs.cells()``; and the argument
bytes of a sharded cell against JAX's compiled ``memory_analysis`` (a
JAX oracle on an Auto mesh of 4 forced host devices).  Each capture runs
in a child process under its own timeout."""
from __future__ import annotations

import concurrent.futures
import json
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

from conftest import run_with_devices  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def test_granite_train_cell_on_pod16x16(tmp_path):
    out = run_with_devices(
        "from repro_torch.launch import dryrun\n"
        f"dryrun.run_cell('granite-8b', 'train_4k', False, "
        f"out_dir={str(tmp_path)!r})\n", n_devices=1, timeout=240)
    assert "granite-8b x train_4k x pod16x16" in out
    rep = json.loads((tmp_path / "granite-8b__train_4k__pod16x16.json")
                     .read_text())
    assert rep["dominant"] in ("compute", "memory", "collective")
    assert rep["memory"]["total_per_device"] > 0
    assert rep["chips"] == 256 and rep["machine"].startswith("NVIDIA H100")
    assert rep["t_compute"] > 0 and rep["t_memory"] > 0
    # the FSDP step gathers weights and reduce-scatters gradients
    assert {"all-gather", "reduce-scatter"} <= set(rep["collective_by_kind"])
    assert rep["n_collectives"] >= len(rep["schedule_head"]) > 0
    # the model flops of one rank: 6·N·D over 256 chips
    cfg = configs.get_config("granite-8b")
    shape = configs.SHAPES["train_4k"]
    assert rep["model_flops"] == 6.0 * cfg.active_param_count() * \
        shape.batch * shape.seq / 256
    # the step fits an 80 GB card, and the loss reduces over vocab shards:
    # no op among the costliest spans the whole vocab
    assert rep["memory"]["total_per_device"] < 80 * 2 ** 30
    whole_vocab = [t for t in rep["top_traffic"]
                   if t["op"].endswith(f",{cfg.vocab}]")]
    assert whole_vocab == [], whole_vocab


def test_list_equals_the_cells(capsys):
    assert dryrun.main(["--list"]) == 0
    rows = [line.split() for line in capsys.readouterr().out.splitlines()]
    assert [tuple(r) for r in rows] == list(configs.cells())


ARGS_PORT = """
import dataclasses, json
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.cell import build_cell
from repro_torch.launch.mesh import make_local_mesh
cfg = dataclasses.replace(configs.reduced(configs.get_config("granite-8b")),
                          tp=2)
shape = configs.ShapeSpec("train_small", "train", seq=128, batch=4)
cell = build_cell("granite-8b", shape, cfg=cfg)
with dryrun.fake_world(4):
    cap = dryrun.capture_cell(cell, make_local_mesh(2, 2, device="cpu"))
    try:                                  # a second default group
        with dryrun.fake_world(4):
            refused = ""
    except RuntimeError as e:
        refused = str(e)
print("RESULT " + json.dumps(dict(cap.memory(), refused=refused)))
"""

ARGS_JAX = """
import dataclasses, json
import jax
from repro import configs
from repro.launch.cell import build_cell, shard
from repro.launch.mesh import make_local_mesh
cfg = dataclasses.replace(configs.reduced(configs.get_config("granite-8b")),
                          tp=2)
shape = configs.ShapeSpec("train_small", "train", seq=128, batch=4)
cell = build_cell("granite-8b", shape, cfg=cfg)
mesh = make_local_mesh(2, 2)
with mesh:
    compiled = jax.jit(cell.fn, in_shardings=shard(mesh, cell.in_specs),
                       out_shardings=shard(mesh, cell.out_specs)).lower(
        *cell.abstract_args).compile()
print("RESULT " + json.dumps(
    {"argument_bytes": compiled.memory_analysis().argument_size_in_bytes}))
"""


@pytest.fixture(scope="module")
def sharded_cell() -> dict:
    """The port's capture and JAX's compile of the same cell, in two
    child processes at once."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        port = pool.submit(run_with_devices, ARGS_PORT, 1, 240)
        jax_ = pool.submit(run_with_devices, ARGS_JAX, 4, 240)
        return {name: json.loads(f.result().split("RESULT ", 1)[1])
                for name, f in (("port", port), ("jax", jax_))}


def test_argument_bytes_equal_jax_compiled_cell(sharded_cell):
    """The reduced granite train step (tp=2) on a (2, 2) mesh: the local
    shards of its parameters, optimizer state, batch and step number are
    the per-device arguments JAX's compiled cell takes."""
    port, jax_ = sharded_cell["port"], sharded_cell["jax"]
    assert port["argument_bytes"] == jax_["argument_bytes"] > 0
    assert port["peak_bytes"] > port["argument_bytes"]


def test_a_second_default_group_is_refused(sharded_cell):
    assert "fresh process" in sharded_cell["port"]["refused"]
