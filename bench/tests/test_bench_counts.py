"""The yardstick's counts against numbers worked by hand at granite-8b's
and mamba2-2.7b's shapes, and the readers on a made-up trace."""
from __future__ import annotations

import json

import pytest

from bench import harness
from bench.counts import adamw, flash_bwd, flash_fwd, train_model
from bench.trace import Kernel, Trace

PEAK = {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12}


def model(name: str) -> dict:
    return json.loads((harness.BENCH / "configs" / f"{name}.json")
                      .read_text())["model"]


def test_flash_forward_bound_at_granite_shape():
    ops, moved = flash_fwd.cost(1, 32, 4096, 4096, 128)
    # 4·128 per pair, 4096·4097/2 pairs, 32 heads
    assert ops == 4 * 128 * (4096 * 4097 // 2) * 32
    assert max(ops / PEAK["bf16_flops"], moved / PEAK["hbm_bytes_s"]) \
        * 1e3 == pytest.approx(0.1390, abs=5e-5)
    assert moved == 2 * 32 * 128 * 4 * 4096


def test_flash_backward_counts_eight_d_a_pair():
    f, _ = flash_fwd.cost(1, 32, 4096, 4096, 128)
    b, moved = flash_bwd.cost(1, 32, 4096, 4096, 128)
    assert b == 2 * f
    assert b / PEAK["bf16_flops"] * 1e3 == pytest.approx(0.2780, abs=5e-5)
    assert moved == 2 * 32 * 128 * 7 * 4096


def test_pairs_with_an_offset():
    assert flash_fwd.pairs(4, 4) == 10
    assert flash_fwd.pairs(2, 5) == 4 + 5


def test_adamw_bytes_a_parameter():
    assert adamw.cost(1)[1] == 30
    assert adamw.cost(1, grad_bytes=2)[1] == 28
    assert adamw.cost(2_164_338_688)[1] == 30 * 2_164_338_688


def test_step_flops_of_each_cell():
    g, s = model("granite-8b-9L"), model("mamba2-2.7b-32L")
    assert train_model.product_params(g) == 2_164_260_864
    w4 = {"global_batch": 4, "seq": 4096}
    assert train_model.step_flops(g, w4) == pytest.approx(2.276e14,
                                                          rel=5e-4)
    w16 = {"global_batch": 1, "seq": 16384}
    assert train_model.step_flops(g, w16) == pytest.approx(2.721e14,
                                                           rel=5e-4)
    # the scan: 12·64·128 a token, head (80) and layer (32)
    scan = 12 * 64 * 128 * 80 * 32 * 4 * 4096
    assert train_model.step_flops(s, w4) == pytest.approx(
        6 * train_model.product_params(s) * 4 * 4096 + scan)
    assert train_model.step_flops(s, w4) == pytest.approx(1.43e14,
                                                          rel=5e-3)


def ctx(kernels, spans, busy_s=0.5, cell="granite-8b-9L.train_4k"):
    c = harness.load_cell(cell)
    return harness.Context(Trace(kernels, spans, [], 1, 1.0, busy_s, []), c,
                           PEAK, 2_164_338_688, 4)


def test_readers_on_a_made_up_trace():
    fwd = [Kernel("void flash_attention_wgmma_kernel<128, 128, 2>(...)",
                  i * 1000.0, i * 1000.0 + 278.0, None) for i in range(4)]
    bwd = [Kernel("void flash_attention_bwd_fused_kernel<128>(...)",
                  10_000.0, 10_556.0, "flash_attention_backward")]
    opt = [Kernel("elementwise", 20_000.0, 20_000.0 + 1e5, "adamw_update")]
    c = ctx(fwd + bwd + opt, {"flash_attention_backward": [(9e3, 2e4)],
                              "adamw_update": [(2e4, 2e5)]})
    read = {m: harness.reader(m).read(c) for m in (
        "flash_fwd_roofline.train", "flash_bwd_roofline.train",
        "adamw_roofline.train", "device_idle.train", "train_mfu")}
    assert read["flash_fwd_roofline.train"] == pytest.approx(50.0, rel=1e-3)
    assert read["flash_bwd_roofline.train"] == pytest.approx(50.0, rel=1e-3)
    assert read["adamw_roofline.train"] == pytest.approx(
        100 * 30 * 2_164_338_688 / 3.35e12 / 0.1)
    assert read["device_idle.train"] == pytest.approx(50.0)
    assert read["train_mfu"] == pytest.approx(100 * 2.276e14 / 989e12,
                                              rel=5e-4)


def test_a_reader_with_nothing_to_read_returns_nothing():
    c = ctx([Kernel("gemm", 0.0, 10.0, None)], {})
    for m in ("flash_fwd_roofline.train", "flash_bwd_roofline.train",
              "adamw_roofline.train", "ssd_fwd_ms.train"):
        assert harness.reader(m).read(c) is None
