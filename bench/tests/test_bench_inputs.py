"""The benchmark's inputs: the vectorised traffic rule against the
pipeline's rule one position at a time, and both inputs the same for
the same seed and different for another."""
from __future__ import annotations

import torch

from bench import traffic, weights
from bench.reference import dense, ssm
from bench.tests import _tiny

WORK = {"pool": 3, "global_batch": 2, "seq": 300, "noise": 0.1}


def test_vectorised_rule_equals_the_sequential_one():
    g = torch.Generator().manual_seed(weights.stream(2 ** 31 + 9, 1))
    rows, s, v = 6, 300, 49152
    first = torch.randint(0, v, (rows, 1), generator=g)
    noise = torch.rand((rows, s - 1), generator=g) < 0.1
    fresh = torch.randint(0, v, (rows, s - 1), generator=g)
    got = traffic.pool(WORK, v, 2 ** 31 + 9, "cpu")["tokens"].reshape(rows, s)
    assert torch.equal(got, traffic.sequential(first, noise, fresh, v))


def test_labels_are_the_next_tokens():
    p = traffic.pool(WORK, 50277, 7, "cpu")
    assert torch.equal(p["labels"][..., :-1], p["tokens"][..., 1:])
    assert int(p["tokens"].max()) < 50277


def test_same_seed_same_inputs_other_seed_other_inputs():
    seed = 2 ** 33 + 1
    a, b = traffic.pool(WORK, 300, seed, "cpu"), \
        traffic.pool(WORK, 300, seed, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"],
                           traffic.pool(WORK, 300, seed + 1, "cpu")["tokens"])
    for mod, name in ((dense, _tiny.CELLS[0]), (ssm, _tiny.CELLS[1])):
        layout = mod.layout(_tiny.cell(name).model)
        w1, w2 = weights.draw(layout, seed, "cpu"), \
            weights.draw(layout, seed, "cpu")
        w3 = weights.draw(layout, seed + 1, "cpu")
        assert torch.equal(w1["embed"], w2["embed"])
        assert not torch.equal(w1["embed"], w3["embed"])
        assert weights.shapes(w1) == {p: s for p, s, _, _ in layout}


def test_mamba_scan_initial_values():
    layout = ssm.layout(_tiny.cell(_tiny.CELLS[1]).model)
    p = weights.draw(layout, 3, "cpu", dtype=torch.float32)
    blk = p["stages"][0]["blocks"][0]
    a = torch.exp(blk["A_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    dt = torch.nn.functional.softplus(blk["dt_bias"])
    assert float(dt.min()) >= 0.999e-3 and float(dt.max()) <= 0.1001
    assert torch.equal(blk["D"], torch.ones_like(blk["D"]))
