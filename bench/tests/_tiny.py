"""Tiny versions of the benchmark's cells for CPU tests: the committed
cell with its widths, depth, vocabulary and sequence cut down, its
traffic, training settings and step structure kept."""
from __future__ import annotations

from bench import harness

CELLS = ("granite-8b-9L.train_4k", "mamba2-2.7b-32L.train_4k",
         "granite-8b-9L.train_16k")


def cell(name: str, **limits) -> harness.Cell:
    c = harness.load_cell(name)
    m = c.config["model"]
    if m["family"] == "dense":
        m.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                 head_dim=16, d_ff=96, vocab=300)
    else:
        m.update(n_layers=2, d_model=64, vocab=300)
        m["ssm"].update(d_state=16, headdim=16, chunk=16)
    c.workload.update(seq=64, pool=8, limits=dict(limits))
    return c
