"""The port's dry run of whisper-small ``train_4k`` on ``pod16x16`` (a
fake 256-rank group, ``repro_torch.launch.dryrun``) held at or under the
JAX package's own figure for the same cell: ``repro.launch.dryrun.
run_cell`` on 256 forced host devices, its ``total_per_device``.  The
two count differently (the port rank 0's peak of live bytes, JAX the
compiled arguments, outputs and temporaries less the aliased bytes), so
the check is one-sided: the port holds no more than the reference.

Each side runs in its own child process under its own timeout, the two
at once.  The port's figure on this cell fell from 14.20 GiB when the
grouped attention's query chunks took JAX's per-chunk remat
(``models/attention.py:attend``)."""
from __future__ import annotations

import concurrent.futures
import json

import pytest

pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402

CELL = ("whisper-small", "train_4k")

PORT = f"""
import json, tempfile
from repro_torch.launch import dryrun
rec = dryrun.run_cell({CELL[0]!r}, {CELL[1]!r}, False,
                      out_dir=tempfile.mkdtemp(), verbose=False)
print("RESULT " + json.dumps({{"total": rec["memory"]["total_per_device"],
                              "top": rec["top_traffic"][:3]}}))
"""

JAX = f"""
import json, pathlib, tempfile
from repro.launch import dryrun
rec = dryrun.run_cell({CELL[0]!r}, {CELL[1]!r}, False,
                      out_dir=pathlib.Path(tempfile.mkdtemp()),
                      verbose=False)
print("RESULT " + json.dumps({{"total": rec["memory"]["total_per_device"],
                              "top": rec["top_traffic"][:3]}}))
"""


@pytest.fixture(scope="module")
def whisper_cell() -> dict:
    """Both packages' figures for the cell, from two children at once."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        port = pool.submit(run_with_devices, PORT, 1, 300)
        jax_ = pool.submit(run_with_devices, JAX, 256, 300)
        return {name: json.loads(f.result().split("RESULT ", 1)[1])
                for name, f in (("port", port), ("jax", jax_))}


def test_whisper_train_cell_within_jax_s_footprint(whisper_cell):
    """At or under JAX's figure and under an 80 GB card; the costliest op
    is one query chunk's (b, heads, g, 512, 1500) cross-attention tile."""
    port, jax_ = whisper_cell["port"], whisper_cell["jax"]
    assert 0 < port["total"] <= jax_["total"], (port, jax_)
    assert port["total"] < 80 * 2 ** 30
    assert any(",512,1500]" in t["op"] for t in port["top"]), port["top"]

