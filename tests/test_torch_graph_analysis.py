"""The port's graph-level analysis of its own programs
(``repro_torch.core.graph_analysis``, the ``graph`` frontend): the
counting rules op by op, conservation, the flash operator and its fake,
collectives on a fake 4-rank mesh, and the ten reduced configs' captured
prefills against the JAX package's bundled HLO dumps.

The captures that need a process group run in child processes (a
process holds one default group), each under its own timeout."""
from __future__ import annotations

import gzip
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

from conftest import run_with_devices  # noqa: E402
from repro.core import hlo_analysis as j_hlo  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import graph_analysis as ga  # noqa: E402
from repro_torch.core import hlo_analysis  # noqa: E402
from repro_torch.core.frontends import GraphProgram, HLOProgram  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

J_DUMPS = HERE.parent / "src" / "repro" / "configs" / "hlo"
# the configs whose captured prefill is the JAX lowering's arithmetic op
# for op; the rest differ for the reasons PERF.md lists
DENSE = ("granite-8b", "qwen1.5-110b", "phi3-mini-3.8b", "gemma-7b",
         "pixtral-12b")


def _rand(shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _record(fn, *args, tf32=False):
    _, cap = ga.capture(fn, *args, tf32=tf32)
    return cap


def _conserves(ana) -> bool:
    pairs = [("mxu_flops", "mxu_flops"), ("vpu_flops", "vpu_flops"),
             ("hbm_bytes", "hbm_bytes"),
             ("wire_bytes", "collective_wire_bytes")]
    return all(math.isclose(sum(getattr(o, f) for o in ana.ops),
                            getattr(ana, t), rel_tol=1e-12, abs_tol=1e-6)
               for f, t in pairs)


# ----------------------------------------------------------------------
# the rules, op by op
# ----------------------------------------------------------------------

@pytest.mark.parametrize("op,shapes,flops", [
    ("mm", [(8, 16), (16, 12)], 2 * 8 * 12 * 16),
    ("bmm", [(3, 8, 16), (3, 16, 12)], 2 * 3 * 8 * 12 * 16),
    ("addmm", [(8, 12), (8, 16), (16, 12)], 2 * 8 * 12 * 16),
])
def test_gemms_count_2mnk(op, shapes, flops):
    args = [_rand(s, torch.bfloat16, i) for i, s in enumerate(shapes)]
    cap = _record(getattr(torch, op), *args)
    (rec,) = cap.analysis.ops
    assert rec.opcode == op and rec.mxu_flops == flops
    # addmm's bias add is one CUDA-core flop per output element
    assert rec.vpu_flops == (8 * 12 if op == "addmm" else 0)
    want_bytes = sum(a.numel() * 2 for a in args) + flops // (
        2 * shapes[-2][-1]) * 2
    assert rec.hbm_bytes == want_bytes


def test_composite_ops_under_inference_mode_count_their_parts():
    """Under inference mode a composite op (einsum, linear) reaches the
    recorder whole; it records the GEMM the op is made of."""
    a, b = _rand((4, 8, 16), torch.bfloat16), _rand((16, 32), torch.bfloat16)
    with torch.inference_mode():
        out, cap = ga.capture(lambda x, y: torch.einsum("bsd,df->bsf", x, y),
                              a, b)
        lin = _record(lambda x, y: torch.nn.functional.linear(x, y.t()), a,
                      b, tf32=False)
    torch.testing.assert_close(out, torch.einsum("bsd,df->bsf", a, b),
                               rtol=0, atol=0)
    for c in (cap, lin):
        gemms = [r for r in c.analysis.ops if r.mxu_flops]
        assert len(gemms) == 1 and gemms[0].mxu_flops == 2 * 4 * 8 * 32 * 16


def test_views_cost_nothing_and_count_no_bytes():
    x = _rand((4, 6, 8))

    def views(t):
        a = t.view(24, 8).transpose(0, 1)
        b = t[:, 1:3].expand(2, 4, 2, 8)
        c, d = torch.split(t, 3, dim=1)
        return a, b, c, d, t.unsqueeze(0).permute(1, 0, 2, 3)
    cap = _record(views, x)
    assert cap.analysis.ops == []
    assert cap.analysis.hbm_bytes == 0 and cap.n_dispatched >= 5
    assert cap.output_bytes == 0          # every result aliases x


def test_expanded_operand_counts_its_distinct_elements():
    x, row = _rand((64, 32)), _rand((1, 32), seed=1)
    cap = _record(lambda a, b: a * b.expand(64, 32), x, row)
    (rec,) = cap.analysis.ops
    assert rec.vpu_flops == 64 * 32
    assert rec.hbm_bytes == 4 * (64 * 32 + 32 + 64 * 32)


def test_bf16_gemm_is_tensor_core_f32_without_tf32_is_cuda_core():
    a, b = _rand((32, 64)), _rand((64, 16), seed=1)
    f = 2.0 * 32 * 16 * 64
    bf = _record(torch.mm, a.bfloat16(), b.bfloat16()).analysis
    assert (bf.mxu_flops, bf.vpu_flops) == (f, 0.0)
    off = _record(torch.mm, a, b, tf32=False).analysis
    assert (off.mxu_flops, off.vpu_flops) == (0.0, f)
    on = _record(torch.mm, a, b, tf32=True).analysis
    assert (on.mxu_flops, on.vpu_flops) == (f, 0.0)
    # the default follows the backend's flag
    assert ga.Recorder().tf32 == torch.backends.cuda.matmul.allow_tf32


def test_elementwise_reductions_softmax():
    x = _rand((16, 32))
    cap = _record(lambda t: (t.exp() + 1.0, t.sum(-1), torch.softmax(t, -1),
                             t.to(torch.bfloat16)), x)
    by = {r.opcode: r for r in cap.analysis.ops}
    assert by["exp"].vpu_flops == by["add"].vpu_flops == 16 * 32
    assert by["sum"].vpu_flops == 16 * 32           # per input element
    assert by["_softmax"].vpu_flops == 5 * 16 * 32
    # a cast moves bytes and does no arithmetic (HLO's convert)
    assert by["_to_copy"].vpu_flops == 0
    assert by["_to_copy"].hbm_bytes == 16 * 32 * (4 + 2)


def test_in_place_ops_allocate_nothing():
    x, y = _rand((128, 128)), _rand((128, 128), seed=1)
    cap = _record(lambda a, b: (a.mul_(2.0), a.copy_(b)), x, y)
    mul, copy = cap.analysis.ops
    assert mul.hbm_bytes == 2 * x.nbytes            # read and write a
    assert copy.hbm_bytes == 2 * x.nbytes           # read b, write a
    assert cap.argument_bytes == 2 * x.nbytes
    assert cap.peak_bytes == cap.argument_bytes and cap.output_bytes == 0
    fresh = _record(lambda a: a * 2.0, x)
    assert fresh.peak_bytes == 2 * x.nbytes and fresh.output_bytes == x.nbytes


@pytest.mark.parametrize("dtype,passes,unit", [
    (torch.bfloat16, 1, "mxu"), (torch.float32, 3, "mxu")])
def test_flash_op_counts_its_formula_and_its_fake_runs_no_kernel(
        dtype, passes, unit, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, h, s, d = 2, 4, 128, 64
    calls = []
    monkeypatch.setattr(fa, "plain", lambda *a, **k: calls.append(1))
    before = fa.flash_attention.launches
    with FakeTensorMode():
        q, k, v = (torch.empty(b, h, s, d, dtype=dtype) for _ in range(3))
        out, cap = ga.capture(fa.flash_op, q, k, v, True, 64, 64, 0)
    assert out.shape == q.shape and out.dtype == dtype
    assert calls == [] and fa.flash_attention.launches == before
    (rec,) = cap.analysis.ops
    assert rec.opcode == "flash_attention"
    pairs = s * (s + 1) // 2                     # causal, q_offset 0
    formula = 4.0 * d * pairs * b * h
    assert fa.launch_limits(64, 64, d, dtype).route == (
        "wgmma" if dtype == torch.bfloat16 else "bf16x3")
    assert getattr(rec, f"{unit}_flops") == passes * formula
    assert rec.hbm_bytes == 4 * b * h * s * d * q.element_size()


def test_backward_op_counts_its_formula_and_its_fake_runs_no_kernel():
    """The backward operator (``repro_torch::flash_attention_backward``)
    on fake tensors runs its fake, which launches nothing, and is recorded
    as one op of 10·d flops per visible (query, key) pair (S recomputed,
    dP, dV, dQ, dK) on the tensor cores, its bytes q, k, v and dO read,
    dq, dk and dv written, and the rows' fp32 LSE and D."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, h, s, d = 2, 4, 128, 64
    calls = dict(fa.flash_attention.backward_calls_by_route)
    with FakeTensorMode():
        q, k, v, do = (torch.empty(b, h, s, d, dtype=torch.bfloat16)
                       for _ in range(4))
        out, cap = ga.capture(fa.backward_op, q, k, v, do, True, 0)
    assert [t.shape for t in out] == [q.shape] * 3
    assert fa.flash_attention.backward_calls_by_route == calls
    (rec,) = cap.analysis.ops
    assert rec.opcode == "flash_attention_backward"
    pairs = s * (s + 1) // 2                     # causal, q_offset 0
    assert fa.backward_route(q, k, 0) == "kernel"
    assert rec.mxu_flops == 2.5 * ga.flash_flops(q, k, True, 0) \
        == 10.0 * d * pairs * b * h
    assert rec.vpu_flops == 0
    assert rec.hbm_bytes == 7 * b * h * s * d * 2 + 8 * b * h * s


def test_flash_op_on_the_cpu_is_the_plain_version():
    q, k, v = (_rand((1, 2, 64, 32), seed=i) for i in range(3))
    got = fa.flash_op(q, k, v, True, 64, 64, 0)
    torch.testing.assert_close(got, fa.plain(q, k, v, causal=True,
                                             q_offset=0), rtol=0, atol=0)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_op(q, k, v, True, 64, 64, -1)


def test_a_model_forward_conserves():
    import dataclasses
    from repro_torch.models import common
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(configs.reduced(configs.get_config(
        "granite-8b")), act_dtype="float32")
    model = LM(cfg)
    params = common.materialize(model.param_recs(),
                                torch.Generator().manual_seed(0),
                                default_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)))
    with torch.no_grad():
        cap = _record(lambda p, t: model.forward(p, {"tokens": t}), params,
                      tokens)
    ana = cap.analysis
    assert _conserves(ana) and len(ana.ops) > 20
    assert {"flash_attention", "mm"} <= {r.opcode for r in ana.ops} or \
        {"flash_attention", "bmm"} <= {r.opcode for r in ana.ops}
    assert cap.argument_bytes == common.nbytes(params) + tokens.nbytes
    assert cap.peak_bytes > cap.argument_bytes


# ----------------------------------------------------------------------
# collectives on a fake 4-rank mesh (a child process)
# ----------------------------------------------------------------------

COLLECTIVES = """
import json, torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.core import graph_analysis as ga
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
with dryrun.fake_world(4):
    mesh = make_local_mesh(2, 2, device="cpu")
    with FakeTensorMode():
        x = torch.empty(8, 16, 32)
        sh = DTensor.from_local(x, mesh, [Shard(0), Shard(1)],
                                run_check=False)
        part = DTensor.from_local(x, mesh, [Partial(), Replicate()],
                                  run_check=False)
        def moves():
            a = sh.redistribute(mesh, [Replicate(), Shard(1)])   # gather
            b = part.redistribute(mesh, [Replicate(), Replicate()])  # reduce
            c = part.redistribute(mesh, [Shard(0), Replicate()])  # scatter
            d = sh.redistribute(mesh, [Shard(0), Shard(2)])   # all-to-all
            return a, b, c, d
        with dryrun.device_collectives():
            _, cap = ga.capture(moves)
        # ops DTensor has not run before: each runs once on global-shape
        # fake tensors, for its result's metadata, then on the local shard
        _, meta = ga.capture(lambda: torch.exp(sh) * sh)
ana = cap.analysis
collectives = {
    "ops": [r.to_dict() for r in ana.ops],
    "schedule": [[r.kind, r.result_bytes, r.wire_bytes, r.group_size]
                 for r in ana.schedule],
    "by_kind": dict(ana.collective_by_kind),
    "wire": ana.collective_wire_bytes, "dispatched": cap.n_dispatched,
    "meta": {"shapes": sorted({r.shape for r in meta.analysis.ops}),
             "ops": [r.opcode for r in meta.analysis.ops],
             "temp": meta.peak_bytes - meta.argument_bytes}}
"""


def _child(code: str, timeout: int = 120) -> dict:
    out = run_with_devices(code, n_devices=1, timeout=timeout)
    return json.loads(out.split("RESULT ", 1)[1])


@pytest.fixture(scope="module")
def children() -> dict:
    """The collectives and the ten captures, in one child process (each
    capture starts and ends its own fake group)."""
    return _child(COLLECTIVES + CAPTURES, timeout=300)


@pytest.fixture(scope="module")
def collectives(children):
    return children["collectives"]


def test_collective_wire_bytes_follow_the_wire_models(collectives):
    sched = collectives["schedule"]
    kinds = [k for k, *_ in sched]
    assert kinds == ["all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all"]
    for kind, rbytes, wire, n in sched:
        assert n == 2                      # one mesh dim of a (2, 2) mesh
        assert wire == hlo_analysis._collective_wire_bytes(kind, rbytes, n)
        assert wire == j_hlo._collective_wire_bytes(kind, rbytes, n)
    # result bytes (each rank's local (8, 16, 32) of a (16, 32, 32)
    # tensor): the gathered (16, 16, 32), the reduced whole, the scattered
    # half, and the all-to-all's (8, 32, 16), split on the other dim
    assert [r for _, r, _, _ in sched] == [4 * 16 * 16 * 32,
                                            4 * 8 * 16 * 32,
                                            4 * 4 * 16 * 32,
                                            4 * 8 * 32 * 16]
    assert collectives["wire"] == sum(w for _, _, w, _ in sched)
    assert collectives["by_kind"] == {k: w for k, _, w, _ in sched}


def test_wait_tensor_costs_nothing(collectives):
    ops = collectives["ops"]
    assert not any(r["opcode"] == "wait_tensor" for r in ops)
    assert collectives["dispatched"] > len(ops)
    coll = [r for r in ops if r["collective"]]
    assert len(coll) == 4
    assert all(r["hbm_bytes"] > 0 and r["group_size"] == 2 for r in coll)


def test_dtensor_metadata_runs_are_not_recorded(collectives):
    """DTensor runs an op it has not seen once on fake tensors of the
    global (16, 32, 32) shape to learn its result's metadata; no rank runs
    that, so the recorder counts the local (8, 16, 32) ops alone: their
    bytes, and as live memory the two local results."""
    meta = collectives["meta"]
    assert meta["ops"] == ["exp", "mul"]
    assert meta["shapes"] == ["f32[8,16,32]"]
    assert meta["temp"] == 2 * 4 * 8 * 16 * 32


# ----------------------------------------------------------------------
# graph:<arch> for the ten reduced configs against JAX's bundled dumps
# ----------------------------------------------------------------------

CAPTURES = """
import json
from repro_torch import configs, fleet
from repro_torch.core import api
from repro_torch.core.frontends import graph, load_kernel
out = {}
for arch in configs.ARCH_IDS:
    prog = load_kernel("graph:" + arch)
    ana = prog.analysis
    out[arch] = {
        "ops": [r.to_dict() for r in ana.ops],
        "totals": [ana.mxu_flops, ana.vpu_flops, ana.hbm_bytes,
                   ana.collective_wire_bytes],
        "gemm": sum(ana.flops_by_shape.values()),
        "kinds": sorted(ana.collective_by_kind),
        "key": list(prog.cache_key()), "name": prog.name}
decode = load_kernel("graph:granite-8b:decode_32k")
out["decode"] = {"shape": decode.shape, "key": list(decode.cache_key()),
                 "kinds": sorted(decode.analysis.collective_by_kind),
                 "flash": sum(r.opcode == "flash_attention"
                              for r in decode.analysis.ops)}
rep = fleet.FleetAnalyzer().analyze("graph:granite-8b", "H100").to_dict()
res = api.analyze("graph:granite-8b", "H100", model="hlo-roofline")
out["fleet"] = {"conserved": rep["conserved"], "config": rep["config"],
                "module": rep["module"], "roofline": res.to_dict()}
print("RESULT " + json.dumps({"collectives": collectives, "captured": out}))
"""


@pytest.fixture(scope="module")
def captured(children):
    return children["captured"]


def _jax(arch: str):
    text = gzip.decompress((J_DUMPS / f"{arch}.hlo.gz").read_bytes()
                           ).decode()
    return j_hlo.analyze_hlo_text(text)


def _masked(rec: dict) -> float:
    """The flash op's masked half: JAX's reduced prefill scores every
    (query, key) pair, ``4·d·b·h·sq·skv`` (two dots of ``2·d`` per pair),
    where the flash formula counts the causal ones, ``sq·(sq+1)/2`` at
    ``q_offset`` 0 with ``skv = sq`` (a prefill from an empty cache)."""
    dims = [int(x) for x in rec["shape"].split("[")[1].rstrip("]")
            .split(",")]
    b, h, sq, d = dims
    return 4.0 * d * b * h * (sq * sq - sq * (sq + 1) // 2)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_captured_records_sum_to_the_totals(captured, arch):
    got = captured[arch]
    sums = [sum(r[f] for r in got["ops"]) for f in
            ("mxu_flops", "vpu_flops", "hbm_bytes", "wire_bytes")]
    for s, t in zip(sums, got["totals"]):
        assert math.isclose(s, t, rel_tol=1e-12, abs_tol=1e-6)
    assert got["totals"][0] + got["totals"][1] > 0
    assert got["key"][0] == "graph" and got["name"] == f"graph:{arch}"


@pytest.mark.parametrize("arch", DENSE)
def test_dense_mxu_flops_agree_with_the_jax_dump(captured, arch):
    got = captured[arch]
    masked = sum(_masked(r) for r in got["ops"]
                 if r["opcode"] == "flash_attention")
    assert masked > 0
    want = _jax(arch).mxu_flops
    assert abs(got["totals"][0] + masked - want) <= 0.01 * want


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if a not in ("mamba2-2.7b", "zamba2-7b")])
def test_gemm_flops_agree_with_the_jax_dump_outside_the_scan(captured,
                                                             arch):
    """Every GEMM and the flash op, whichever unit runs it, against JAX's
    dot flops: equal but for the SSD scan's einsums (mamba2, zamba2),
    whose contraction order is torch's."""
    got = captured[arch]
    masked = sum(_masked(r) for r in got["ops"]
                 if r["opcode"] == "flash_attention")
    want = _jax(arch).mxu_flops
    assert abs(got["gemm"] + masked - want) <= 0.01 * want


def test_deepseek_gemms_run_on_the_cuda_cores_in_float32(captured):
    """The reduced deepseek-v3 runs in float32: with TF32 off every GEMM
    is CUDA-core work, and its GEMM flops are JAX's dot flops."""
    got = captured["deepseek-v3-671b"]
    assert got["totals"][0] == 0.0
    want = _jax("deepseek-v3-671b").mxu_flops
    assert abs(got["gemm"] - want) <= 0.01 * want


def test_fleet_and_hlo_roofline_price_a_captured_program(captured):
    f = captured["fleet"]
    assert f["conserved"] and f["config"] == "graph:granite-8b"
    g = captured["granite-8b"]["totals"]
    assert f["roofline"]["mxu_flops"] == g[0]
    assert f["roofline"]["hbm_bytes"] == g[2]
    assert f["module"] == f["roofline"]


def test_a_named_shape_captures_that_step(captured):
    """``graph:<arch>:<shape>``: the shape's step on the default cell's
    config and mesh; one-token decode takes the grouped plain path."""
    dec, default = captured["decode"], captured["granite-8b"]
    assert dec["shape"] == "decode_32k" and dec["flash"] == 0
    assert dec["key"][:2] == ["graph", "granite-8b"]
    assert dec["key"] != default["key"]


def test_graph_and_hlo_keys_never_collide():
    ana = hlo_analysis.HLOAnalysis()
    g = GraphProgram(arch="hlo", shape="x", mesh=(2, 2), config_digest="0",
                     analysis=ana)
    h = HLOProgram(text="HloModule m", name="hlo")
    assert g.cache_key()[0] == "graph" and h.cache_key()[0] == "hlo"
    assert g.cache_key() != h.cache_key()
