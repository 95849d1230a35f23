"""The zamba2-7b-27L configuration and what reads it: its layout against
the program's parameters at a tiny size, its counts against hand counts,
its readers on a made-up trace, its reference importing nothing of the
program, and a tiny run of its cell on the CPU."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from bench import harness, weights
from bench.counts import flash_bwd, ssd_scan, train_hybrid
from bench.reference import hybrid
from bench.trace import Kernel, Trace

CELL = "zamba2-7b-27L.train_4k"
PEAK = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_s": 3.35e12}


def config() -> dict:
    return json.loads((harness.BENCH / "configs" / "zamba2-7b-27L.json")
                      .read_text())


def tiny_cell(**limits) -> harness.Cell:
    """The committed cell with its widths, depth, vocabulary and sequence
    cut down; invocations ahead of layers 0, 1, 3 and 4 (blocks 0, 1, 0,
    1), two groups, its traffic and training settings kept."""
    c = harness.load_cell(CELL)
    c.config["model"].update(
        n_layers=5, d_model=32, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=48, vocab=300, adapter_rank=8, hybrid_layer_ids=[0, 1, 3, 4])
    c.config["model"]["ssm"].update(d_state=8, headdim=8, chunk=16)
    c.workload.update(seq=64, pool=8, limits=dict(limits))
    return c


def test_the_model_block_is_the_published_config():
    c = config()
    m = c["model"]
    assert (m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"],
            m["head_dim"], m["d_ff"], m["vocab"], m["adapter_rank"],
            m["n_mem_blocks"], m["norm_eps"], m["rope_theta"]) == (
        c["num_hidden_layers"], c["hidden_size"], c["num_attention_heads"],
        c["num_key_value_heads"], c["attention_head_dim"],
        c["intermediate_size"], c["vocab_size"], c["adapter_rank"],
        c["num_mem_blocks"], c["rms_norm_eps"], c["rope_theta"])
    assert m["head_dim"] * m["n_heads"] == c["attention_hidden_size"] \
        == 2 * m["d_model"]
    s = m["ssm"]
    assert (s["d_state"], s["headdim"], s["expand"], s["chunk"],
            s["conv_width"], s["n_groups"]) == (
        c["mamba_d_state"], c["mamba_headdim"], c["mamba_expand"],
        c["chunk_size"], c["mamba_d_conv"], c["mamba_ngroups"])
    assert s["expand"] * m["d_model"] // s["headdim"] == c["n_mamba_heads"]
    assert m["hybrid_layer_ids"] == c["hybrid_layer_ids"] == [
        i for i, t in enumerate(c["layers_block_type"]) if t == "hybrid"]
    assert len(c["layers_block_type"]) == m["n_layers"]
    assert set(c["reduced"]) == {"num_hidden_layers", "layers_block_type",
                                 "hybrid_layer_ids"}


def test_layout_is_the_programs_parameter_tree_at_a_tiny_size():
    from repro_torch.models.common import tmap
    from repro_torch.models.lm import LM
    m = tiny_cell().model
    recs = LM(harness.arch_config(m)).param_recs()
    want = weights.shapes(tmap(lambda r: torch.empty(r.shape, device="meta"),
                               recs))
    assert {p: s for p, s, _, _ in hybrid.layout(m)} == want


def test_the_stage_holds_2_97_billion_parameters():
    m = config()["model"]
    n = sum(torch.Size(s).numel() for _, s, _, _ in hybrid.layout(m))
    assert n == 2_968_362_608
    # the Mamba layers stacked from each invocation to the next
    assert hybrid.stages(m) == [(0, 6), (6, 5), (11, 6), (17, 6), (23, 4)]


def test_ssd_counts_by_hand():
    # one row of one chunk of 4, 2 heads of P 3, N 5, 1 group:
    # C·Bᵀ 10 pairs · 5, per head 10 pairs · 3 + 2 · 4 · 3 · 5
    fwd, bwd = ssd_scan.cost(1, 4, 2, 3, 5, 4)
    assert fwd == 2 * (10 * 5 + 2 * (10 * 3 + 2 * 4 * 3 * 5))
    assert bwd == 2 * fwd
    # a second group adds one more C·Bᵀ; rows and chunks multiply
    assert ssd_scan.cost(3, 8, 2, 3, 5, 4, 2)[0] == \
        2 * 3 * 2 * (2 * 10 * 5 + 2 * (10 * 3 + 2 * 4 * 3 * 5))


def test_step_flops_by_hand():
    m = config()["model"]
    d, ff, r = 3584, 14336, 128
    mamba = d * 2 * 7168 + d * 2 * 128 + d * 112 + 4 * (7168 + 256) \
        + 7168 * d
    inv = 2 * d * 224 * 96 + 32 * 224 * d + 3 * d * ff + r * (d + 2 * ff) \
        + d * d
    assert train_hybrid.mamba_params(m) == mamba
    assert train_hybrid.invocation_params(m) == inv
    assert train_hybrid.product_params(m) == 27 * mamba + 4 * inv \
        + 32000 * d
    w = {"global_batch": 4, "seq": 4096}
    attn = 12 * 224 * (4096 * 4097 // 2) * 32 * 4 * 4
    scan = 12 * 64 * 64 * 112 * 27 * 4 * 4096
    assert train_hybrid.step_flops(m, w) == pytest.approx(
        6 * train_hybrid.product_params(m) * 4 * 4096 + attn + scan)
    assert train_hybrid.step_flops(m, w) == pytest.approx(3.714e14, rel=5e-4)


def ctx(kernels, spans, cell=CELL):
    c = harness.load_cell(cell)
    return harness.Context(Trace(kernels, spans, [], 1, 2.0, 1.5, []), c,
                           PEAK, 2_968_362_608, 2)


def test_readers_on_a_made_up_trace():
    m = config()["model"]
    fwd, bwd = ssd_scan.cost(4, 4096, 112, 64, 64, 256, 2)
    f_us = fwd / PEAK["fp32_flops"] * 1e6
    b_us = bwd / PEAK["fp32_flops"] * 1e6
    ssd = [Kernel("void (anonymous namespace)::cb_kernel<__nv_bfloat16>"
                  "(...)", 0.0, f_us, None) for _ in range(2)]
    ssd += [Kernel("void (anonymous namespace)::dx_kernel<__nv_bfloat16>"
                   "(...)", 0.0, b_us, None)]
    ops, _ = flash_bwd.cost(4, 32, 4096, 4096, 224)
    attn = [Kernel("gemm", 0.0, 4 * ops / PEAK["bf16_flops"] * 1e6,
                   "flash_attention_backward")]
    other = [Kernel("void at::native::vectorized_elementwise_kernel<4>",
                    0.0, 1e6, None)]
    c = ctx(ssd + attn + other,
            {"flash_attention_backward": [(0.0, 1.0)] * 2})
    read = {n: harness.reader(n).read(c) for n in (
        "hybrid_mfu.train", "ssd_roofline.train",
        "shared_attn_bwd_roofline.train")}
    assert read["ssd_roofline.train"] == pytest.approx(100.0)
    assert read["shared_attn_bwd_roofline.train"] == pytest.approx(50.0)
    assert read["hybrid_mfu.train"] == pytest.approx(
        100 * train_hybrid.step_flops(m, c.workload) / (2.0 * 989e12))


def test_readers_with_nothing_to_read_return_nothing():
    c = ctx([Kernel("gemm", 0.0, 10.0, None)], {})
    for n in ("ssd_roofline.train", "shared_attn_bwd_roofline.train"):
        assert harness.reader(n).read(c) is None
    # the dense cell has no layer ids to count a hybrid step by
    g = ctx([], {}, "granite-8b-9L.train_4k")
    assert harness.reader("hybrid_mfu.train").read(g) is None


SCRIPT = """
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
import bench.reference.hybrid
before = sorted({{m.split(".")[0] for m in sys.modules}})
from bench import harness
from bench.tests import test_bench_hybrid as t
cell = t.tiny_cell(loss_gap=1.0, grad_gap=1.0, change_gap=1.0)
out, rec = harness.run_cell(cell, 2 ** 31 + 3, 0.2, False, "cpu",
                            time.perf_counter())
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(out["correct"], rec["values"]["loss_gap"], rec["values"]["grad_gap"],
      " ".join(before), "|", " ".join(tops))
"""


def test_a_tiny_run_of_the_cell_is_correct_and_loads_no_jax():
    """The harness end to end on the CPU: the program's first steps
    against the reference (in bfloat16 against float32, so the gaps are
    bfloat16's), and the reference's import alone loading nothing of the
    program."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = SCRIPT.format(root=str(harness.ROOT), src=str(harness.ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok, loss_gap, grad_gap, rest = proc.stdout.split("\n")[-2].split(" ", 3)
    before, tops = (set(p.split()) for p in rest.split("|"))
    assert ok == "True"
    assert float(loss_gap) < 0.05 and float(grad_gap) < 0.5
    assert not before & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    assert "repro_torch" in tops
    assert not tops & set(harness.FORBIDDEN)
