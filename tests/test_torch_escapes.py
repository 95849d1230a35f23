"""The port's dry run of two ``train_4k`` cells on ``pod16x16`` (a fake
256-rank group, ``repro_torch.launch.dryrun``) held at or under the JAX
package's own figure for the same cell: ``repro.launch.dryrun.run_cell``
on 256 forced host devices, its ``total_per_device``.  The two count
differently (the port rank 0's peak of live bytes, JAX the compiled
arguments, outputs and temporaries less the aliased bytes), so the check
is one-sided: the port holds no more than the reference.

Each side of each cell runs in its own child process under its own
timeout, the four at once (JAX's gemma-7b child takes about 11 s, the
port's about 30).  whisper-small's figure fell from 14.20 GiB when the
grouped attention's query chunks took JAX's per-chunk remat
(``models/attention.py:attend``); gemma-7b's from 18.30 GiB (JAX: 14.76)
when the loss stopped holding four float32 copies of a rank's
(16, 4095, 16000) logits shard (``train/xent.py``)."""
from __future__ import annotations

import concurrent.futures
import json

import pytest

pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402

from repro_torch.train import xent  # noqa: E402

ARCHS = ["whisper-small", "gemma-7b"]

PORT = """
import json, tempfile
from repro_torch.launch import dryrun
rec = dryrun.run_cell({arch!r}, "train_4k", False,
                      out_dir=tempfile.mkdtemp(), verbose=False)
print("RESULT " + json.dumps({{"total": rec["memory"]["total_per_device"],
                              "top": rec["top_traffic"][:3],
                              "at_peak": rec["live_at_peak"]}}))
"""

JAX = """
import json, pathlib, tempfile
from repro.launch import dryrun
rec = dryrun.run_cell({arch!r}, "train_4k", False,
                      out_dir=pathlib.Path(tempfile.mkdtemp()),
                      verbose=False)
print("RESULT " + json.dumps({{"total": rec["memory"]["total_per_device"],
                              "top": rec["top_traffic"][:3]}}))
"""


@pytest.fixture(scope="module")
def train_cells() -> dict:
    """Both packages' figures for each cell, from four children at once."""
    with concurrent.futures.ThreadPoolExecutor(2 * len(ARCHS)) as pool:
        runs = {(arch, side): pool.submit(run_with_devices,
                                          code.format(arch=arch), n, 300)
                for arch in ARCHS
                for side, code, n in (("port", PORT, 1), ("jax", JAX, 256))}
        return {key: json.loads(f.result().split("RESULT ", 1)[1])
                for key, f in runs.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_within_jax_s_footprint(train_cells, arch):
    """At or under JAX's figure and under an 80 GB card.  whisper's
    costliest op is one query chunk's (b, heads, g, 512, 1500)
    cross-attention tile; at gemma's peak no float32 tensor is larger than
    one chunk of the loss (the parent held four of the logits shard's
    size, 3.9 GiB each)."""
    port, jax_ = train_cells[arch, "port"], train_cells[arch, "jax"]
    assert 0 < port["total"] <= jax_["total"], (port, jax_)
    assert port["total"] < 80 * 2 ** 30
    if arch == "whisper-small":
        assert any(",512,1500]" in t["op"] for t in port["top"]), port["top"]
    else:
        f32 = [t for t in port["at_peak"] if " f32[" in t["op"]]
        assert all(t["bytes"] <= xent.CHUNK_BYTES for t in f32), f32
