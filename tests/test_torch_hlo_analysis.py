"""The port's HLO analysis (``repro_torch.core.hlo_analysis``, the ``hlo``
frontend, ``hlo-roofline`` and the wire models of ``repro_torch.dist``)
against the JAX package's.

Every case of ``tests/test_hlo_analysis.py`` runs here on the same input
through both packages — programs that JAX lowers and compiles on the CPU,
hand-written HLO text, randomized while/fusion nests — and the port's
analysis must equal JAX's exactly: module totals, collective schedule,
per-op records and breakdowns, bit for bit (both do the same float64
arithmetic on the same parse).  The case's own pin is checked on the
port's result.  ``test_sharded_program_collectives`` has no counterpart
here: it needs a JAX program lowered on eight forced host devices;
collectives are covered by the hand-written cases (every wire model)
and by the bundled dumps, whose real sharded lowerings hold all-reduce,
all-gather, all-to-all and collective-permute, and all-reduces that the
rewrite re-costs as reduce-scatters.
"""
import dataclasses
import gzip
import pathlib

import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import dist as j_dist  # noqa: E402
from repro.core import analyze as j_analyze  # noqa: E402
from repro.core import hlo_analysis as J  # noqa: E402
from repro.core import reports as j_reports  # noqa: E402
from repro.core.machine import Machine as JMachine  # noqa: E402

from repro_torch import dist  # noqa: E402
from repro_torch.core import analyze, api, reports  # noqa: E402
from repro_torch.core import hlo_analysis as H  # noqa: E402
from repro_torch.core.machine import Machine  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # container without hypothesis
    from _hypothesis_fallback import given, settings, st

REPO = pathlib.Path(__file__).resolve().parents[1]
from _torch_machines import H100, IVY, V5E, as_port_text, jax_side  # noqa
DUMPS = REPO / "src" / "repro_torch" / "configs" / "hlo"


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile()


def _as_dict(ana) -> dict:
    """Everything an HLOAnalysis holds, in plain containers."""
    return {
        "mxu_flops": ana.mxu_flops, "vpu_flops": ana.vpu_flops,
        "hbm_bytes": ana.hbm_bytes,
        "collective_wire_bytes": ana.collective_wire_bytes,
        "collective_by_kind": dict(ana.collective_by_kind),
        "schedule": [dataclasses.asdict(r) for r in ana.schedule],
        "traffic_by_shape": dict(ana.traffic_by_shape),
        "flops_by_shape": dict(ana.flops_by_shape),
        "ops": [o.to_dict() for o in ana.ops],
        "top_traffic": ana.top_traffic(), "top_flops": ana.top_flops(),
    }


def both(text, **kw):
    """The port's analysis of ``text``, after checking it equals JAX's."""
    ours, theirs = H.analyze_hlo_text(text, **kw), J.analyze_hlo_text(
        text, **kw)
    assert _as_dict(ours) == _as_dict(theirs)
    return ours


def test_dot_flops_exact():
    a = jax.ShapeDtypeStruct((64, 128), jnp.float32)
    b = jax.ShapeDtypeStruct((128, 32), jnp.float32)
    ana = both(_compiled(jnp.dot, a, b).as_text(), per_op=True)
    assert ana.mxu_flops == 2 * 64 * 128 * 32


def test_scan_trip_count_multiplies():
    """cost_analysis() counts while bodies once; the analyzer multiplies
    by the known trip count, in both packages."""
    n_layers = 8

    def f(ws, x):
        def body(h, w):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, x, ws)
        return h

    ws = jax.ShapeDtypeStruct((n_layers, 64, 64), jnp.float32)
    x = jax.ShapeDtypeStruct((16, 64), jnp.float32)
    compiled = _compiled(f, ws, x)
    ana = both(compiled.as_text(), per_op=True)
    want = n_layers * 2 * 16 * 64 * 64
    assert ana.mxu_flops == want
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):   # older jax wraps it in a list
        ca = ca[0]
    assert ca["flops"] < want


def test_scan_weight_traffic_slice_sized():
    """Stacked scan weights count one layer-slice per iteration."""
    n_layers, d = 16, 64

    def f(ws, x):
        def body(h, w):
            return jnp.tanh(h @ w), None
        return jax.lax.scan(body, x, ws)[0]

    ws = jax.ShapeDtypeStruct((n_layers, d, d), jnp.float32)
    x = jax.ShapeDtypeStruct((8, d), jnp.float32)
    ana = both(_compiled(f, ws, x).as_text(), per_op=True)
    stack_bytes = n_layers * d * d * 4
    slice_bytes = d * d * 4
    assert ana.hbm_bytes < 0.35 * n_layers * stack_bytes
    assert ana.hbm_bytes >= n_layers * slice_bytes


_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")


def test_collective_wire_models():
    for kind in _KINDS:
        for n in (1, 2, 3, 4, 8, 512):
            for nbytes in (0, 100, 4096, 12345.5):
                assert H._collective_wire_bytes(kind, nbytes, n) == \
                    J._collective_wire_bytes(kind, nbytes, n)
    assert H._collective_wire_bytes("all-reduce", 100, 4) == \
        pytest.approx(150.0)
    assert H._collective_wire_bytes("all-gather", 100, 4) == \
        pytest.approx(75.0)
    assert H._collective_wire_bytes("reduce-scatter", 100, 4) == 300.0
    assert H._collective_wire_bytes("collective-permute", 100, 4) == 100.0
    assert H._collective_wire_bytes("all-reduce", 100, 1) == 0.0


@pytest.mark.parametrize("machine", [IVY, V5E, H100])
def test_dist_wire_models_match_jax(machine):
    """The port's ``dist`` wire models read the same rate off the same
    file as JAX's: the ICI link where the file has one (v5e 50 GB/s, the
    H100's NVLink estimate 450 GB/s), else main memory (Ivy Bridge)."""
    ours = Machine.from_yaml(machine)
    theirs = JMachine.from_yaml(jax_side(machine))
    bw = dist.collective_bandwidth(ours)
    assert bw == j_dist.collective_bandwidth(theirs)
    assert bw == {IVY: ours.main_memory_bandwidth, V5E: 50e9,
                  H100: 450e9}[machine]
    assert dist.collective_wire_time(1e9, ours) == \
        j_dist.collective_wire_time(1e9, theirs)
    for kind in _KINDS:
        assert dist.collective_time(kind, 1 << 20, 8, ours) == \
            j_dist.collective_time(kind, 1 << 20, 8, theirs)


def test_group_size_parsing():
    for rest, default in (("replica_groups=[2,4]<=[8]", 1),
                          ("replica_groups={{0,1,2,3},{4,5,6,7}}", 1),
                          ("no groups here", 3)):
        assert H._group_size(rest, default) == J._group_size(rest, default)
    assert H._group_size("replica_groups=[2,4]<=[8]", 1) == 4
    assert H._group_size("replica_groups={{0,1,2,3},{4,5,6,7}}", 1) == 4
    assert H._group_size("no groups here", 3) == 3


def test_shape_bytes():
    for ty in ("f32[8,64]{1,0}", "bf16[2,2]{1,0}", "(s32[], f32[4]{0})",
               "pred[10]{0}", "token[]", "(f8e4m3fn[3], c128[2,2])"):
        assert H._shape_bytes(ty) == J._shape_bytes(ty)
        assert H._shape_dims(ty) == J._shape_dims(ty)
    assert H._shape_bytes("f32[8,64]{1,0}") == 8 * 64 * 4
    assert H._shape_bytes("bf16[2,2]{1,0}") == 8
    assert H._shape_bytes("(s32[], f32[4]{0})") == 4 + 16
    assert H._shape_bytes("pred[10]{0}") == 10


def test_roofline_report_terms():
    """``roofline_from_compiled`` reads a compiled object by duck type:
    JAX's executable goes through both packages to the same report."""
    def f(a, b):
        return jnp.tanh(a @ b)

    a = jax.ShapeDtypeStruct((256, 256), jnp.bfloat16)
    b = jax.ShapeDtypeStruct((256, 256), jnp.bfloat16)
    compiled = _compiled(f, a, b)
    kw = dict(arch="toy", shape="s", mesh="m", chips=1,
              model_flops_global=2 * 256**3)
    rep = H.roofline_from_compiled(compiled, **kw)
    assert rep.to_dict() == J.roofline_from_compiled(compiled,
                                                     **kw).to_dict()
    assert rep.t_compute == pytest.approx(
        rep.mxu_flops / H.PEAK_FLOPS_BF16)
    assert rep.useful_flop_ratio == pytest.approx(1.0)
    assert rep.dominant in ("compute", "memory", "collective")
    d = rep.to_dict()
    assert {"t_compute", "t_memory", "t_collective",
            "roofline_fraction"} <= set(d)


def test_save_report_matches_jax(tmp_path):
    def f(a, b):
        return a @ b

    a = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    compiled = _compiled(f, a, a)
    kw = dict(arch="toy", shape="s", mesh="m", chips=2,
              model_flops_global=4 * 64**3)
    H.save_report(H.roofline_from_compiled(compiled, **kw),
                  tmp_path / "ours.json")
    J.save_report(J.roofline_from_compiled(compiled, **kw),
                  tmp_path / "theirs.json")
    assert (tmp_path / "ours.json").read_bytes() == \
        (tmp_path / "theirs.json").read_bytes()


# ----------------------------------------------------------------------
# Collective wire models through real HLO text
# ----------------------------------------------------------------------

def _entry(body_lines: str) -> str:
    return ("HloModule m\n\n"
            "ENTRY %main (p: f32[1024]) -> f32[1024] {\n"
            "  %p = f32[1024]{0} parameter(0)\n"
            f"{body_lines}"
            "}\n")


_KB4 = 1024 * 4          # result bytes of an f32[1024]


@pytest.mark.parametrize("kind, wire", [
    ("all-reduce", 2 * 3 / 4 * _KB4),
    ("all-gather", 3 / 4 * _KB4),
    ("reduce-scatter", 3 * _KB4),
    ("all-to-all", 3 / 4 * _KB4),
    ("collective-permute", float(_KB4)),
])
def test_collective_bytes_in_hlo_text(kind, wire):
    txt = _entry(
        f"  ROOT %c = f32[1024]{{0}} {kind}(%p), "
        "replica_groups={{0,1,2,3}}, to_apply=%sum\n")
    ana = both(txt, assume_rs_rewrite=False, per_op=True)
    assert ana.collective_wire_bytes == pytest.approx(wire)
    assert dict(ana.collective_by_kind) == {kind: pytest.approx(wire)}
    [rec] = ana.schedule
    assert rec.kind == kind and rec.group_size == 4 and rec.multiplier == 1


def test_collective_group_of_one_is_free():
    txt = _entry("  ROOT %c = f32[1024]{0} all-reduce(%p), "
                 "replica_groups={{0}}, to_apply=%sum\n")
    assert both(txt).collective_wire_bytes == 0.0


def test_ar_ds_recost_as_reduce_scatter():
    txt = _entry(
        "  %ar = f32[1024]{0} all-reduce(%p), "
        "replica_groups={{0,1,2,3}}, to_apply=%sum\n"
        "  ROOT %ds = f32[256]{0} dynamic-slice(%ar, %p), "
        "dynamic_slice_sizes={256}\n")
    ana = both(txt, assume_rs_rewrite=True, per_op=True)
    assert ana.collective_wire_bytes == pytest.approx(3 / 4 * 256 * 4)
    assert set(ana.collective_by_kind) == {"reduce-scatter(rewritten)"}
    raw = both(txt, assume_rs_rewrite=False)
    assert raw.collective_wire_bytes == pytest.approx(2 * 3 / 4 * _KB4)


_WHILE_TXT = """HloModule m

%body (bp: (f32[256])) -> (f32[256]) {
  %bp = (f32[256]{0}) parameter(0)
  %gte = f32[256]{0} get-tuple-element(%bp), index=0
  %ar = f32[256]{0} all-reduce(%gte), replica_groups={{0,1}}, to_apply=%sum
  %sq = f32[256]{0} multiply(%ar, %ar)
  ROOT %t = (f32[256]{0}) tuple(%sq)
}

%cond (cp: (f32[256])) -> pred[] {
  %cp = (f32[256]{0}) parameter(0)
  ROOT %lt = pred[] constant(false)
}

ENTRY %main (a: f32[256]) -> (f32[256]) {
  %a = f32[256]{0} parameter(0)
  %t0 = (f32[256]{0}) tuple(%a)
  %w = (f32[256]{0}) while(%t0), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"5"}}
  ROOT %r = f32[256]{0} get-tuple-element(%w), index=0
}
"""


def test_while_trip_count_multiplies_collectives_and_flops():
    ana = both(_WHILE_TXT, per_op=True)
    per_iter_wire = 2 * (2 - 1) / 2 * 256 * 4     # AR over group of 2
    assert ana.collective_wire_bytes == pytest.approx(5 * per_iter_wire)
    assert ana.vpu_flops == 5 * 256
    [rec] = ana.schedule
    assert rec.multiplier == 5 and rec.group_size == 2
    assert ana.hbm_bytes >= 5 * 3 * 256 * 4


def test_unannotated_while_counts_once():
    txt = _WHILE_TXT.replace(
        ', backend_config={"known_trip_count":{"n":"5"}}', "")
    ana = both(txt, per_op=True)
    assert ana.vpu_flops == 256
    assert ana.schedule[0].multiplier == 1


def test_parse_computations_matches_jax():
    for txt in (_WHILE_TXT, _entry("  ROOT %o = f32[1024]{0} add(%p, %p)\n"),
                "", "not hlo at all\n"):
        ours, o_entry = H.parse_computations(txt)
        theirs, t_entry = J.parse_computations(txt)
        assert o_entry == t_entry
        assert {k: dataclasses.asdict(v) for k, v in ours.items()} == \
            {k: dataclasses.asdict(v) for k, v in theirs.items()}


# ----------------------------------------------------------------------
# The bundled dumps: every collective kind of a real sharded lowering
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dump", sorted(p.name for p in
                                        DUMPS.glob("*.hlo.gz")))
def test_bundled_dump_analysis_matches_jax(dump):
    text = gzip.decompress((DUMPS / dump).read_bytes()).decode()
    for rewrite in (True, False):
        ana = both(text, per_op=True, assume_rs_rewrite=rewrite)
    assert ana.schedule and ana.collective_wire_bytes > 0
    assert set(ana.collective_by_kind) <= set(_KINDS)


def test_bundled_dumps_cover_every_collective_kind():
    kinds = set()
    for p in DUMPS.glob("*.hlo.gz"):
        ana = H.analyze_hlo_text(gzip.decompress(p.read_bytes()).decode(),
                                 assume_rs_rewrite=False)
        kinds |= set(ana.collective_by_kind)
    assert {"all-reduce", "all-gather", "all-to-all",
            "collective-permute"} <= kinds
    rewritten = set()
    for p in DUMPS.glob("*.hlo.gz"):
        rewritten |= set(H.analyze_hlo_text(
            gzip.decompress(p.read_bytes()).decode()).collective_by_kind)
    assert "reduce-scatter(rewritten)" in rewritten


# ----------------------------------------------------------------------
# The registered "hlo-roofline" model
# ----------------------------------------------------------------------

def test_hlo_roofline_model_registered():
    from repro_torch.core.model_api import MODEL_REGISTRY, resolve_model
    from repro.core import MODEL_REGISTRY as J_REGISTRY
    m = resolve_model("hlo-roofline")
    assert m is MODEL_REGISTRY["hlo-roofline"]
    assert m.input_kind == "hlo"
    assert sorted(MODEL_REGISTRY) == sorted(J_REGISTRY)


@pytest.mark.parametrize("machine", [V5E, H100])
def test_hlo_roofline_result_json_round_trip(machine):
    api.clear_sessions()
    res = analyze(_WHILE_TXT, machine, model="hlo-roofline",
                  name="while-toy")
    d = res.to_dict()
    assert d == j_analyze(_WHILE_TXT, jax_side(machine),
                          model="hlo-roofline", name="while-toy").to_dict()
    assert d["model"] == "hlo-roofline"
    rebuilt = reports.from_json(reports.to_json(res))
    assert isinstance(rebuilt, H.HLORooflineResult)
    assert rebuilt.to_dict() == d
    assert reports.json_report(res) == j_reports.json_report(
        j_reports.from_json(reports.to_json(res)))
    assert "HLO Roofline" in reports.json_report(res)
    # machine constants flow from the yaml, not the module fallbacks
    if machine == V5E:
        assert res.peak_flops == pytest.approx(1.97e14)
        assert res.hbm_bandwidth == pytest.approx(819e9)
    else:
        assert res.peak_flops == pytest.approx(9.89e14)
        assert res.hbm_bandwidth == pytest.approx(3.35e12)
        assert res.ici_bandwidth == pytest.approx(450e9)
        assert res.vpu_peak_flops == pytest.approx(6.7e13)


@pytest.mark.parametrize("machine", [V5E, H100])
def test_hlo_roofline_uses_machine_dtype(machine):
    res32 = analyze(_WHILE_TXT, machine, model="hlo-roofline",
                    name="while-toy", dtype="FP32")
    assert res32.to_dict() == j_analyze(
        _WHILE_TXT, jax_side(machine), model="hlo-roofline",
        name="while-toy", dtype="FP32").to_dict()
    assert res32.peak_flops == pytest.approx(
        {V5E: 8.25e12, H100: 6.7e13}[machine])


@pytest.mark.parametrize("machine, kw, match", [
    (IVY, {}, "no TPU fields"),
    (V5E, {"dtype": "INT8"}, r"no peak flops for dtype 'INT8'.*BF16.*FP32"),
    (H100, {"dtype": "FP64"}, r"no peak flops for dtype 'FP64'.*BF16.*FP32"),
], ids=["ivy", "v5e-int8", "h100-fp64"])
def test_hlo_roofline_rejects_non_tpu_machine_and_unknown_dtype(machine, kw,
                                                                match):
    """No silent v5e-constant substitution, in JAX's words."""
    with pytest.raises(ValueError, match=match) as ours:
        analyze(_WHILE_TXT, machine, model="hlo-roofline", **kw)
    with pytest.raises(ValueError) as theirs:
        j_analyze(_WHILE_TXT, jax_side(machine), model="hlo-roofline",
                  **kw)
    assert str(ours.value) == as_port_text(str(theirs.value))


@pytest.mark.parametrize("machine", [V5E, H100])
def test_vpu_only_program_gets_compute_term(machine):
    res = analyze(_WHILE_TXT, machine, model="hlo-roofline",
                  name="while-toy")
    assert res.mxu_flops == 0 and res.vpu_flops > 0
    assert res.t_compute == pytest.approx(res.vpu_flops
                                          / res.vpu_peak_flops)
    assert res.arithmetic_intensity > 0
    assert reports.text_report(res) == j_reports.text_report(
        j_analyze(_WHILE_TXT, jax_side(machine), model="hlo-roofline",
                  name="while-toy"))


# ----------------------------------------------------------------------
# Property: per-op roll-up conservation on randomized fusion/while nests
# ----------------------------------------------------------------------

_T16 = "f32[16,16]{1,0}"
_EW_OPS = ("add", "multiply", "maximum", "subtract")
_COLL_KINDS = ("all-reduce", "all-gather", "all-to-all",
               "collective-permute")


def _nest_module(trips, ew, kind, with_coll, with_fusion, inner) -> str:
    """A synthetic module: a chain of trip-annotated whiles whose bodies
    hold a dot, an elementwise chain, optionally a collective, a fusion
    (exp+multiply inside), and — in the first body — an inner while."""
    comps, entry = [], ["  %p = f32[16,16]{1,0} parameter(0)\n"]
    prev = "p"
    for i, t in enumerate(trips):
        body = [
            f"  %bp{i} = ({_T16}) parameter(0)\n",
            f"  %gte{i} = {_T16} get-tuple-element(%bp{i}), index=0\n",
            f"  %dot{i} = {_T16} dot(%gte{i}, %gte{i}), "
            "lhs_contracting_dims={1}, rhs_contracting_dims={0}\n"]
        cur = f"dot{i}"
        for j in range(ew):
            op = _EW_OPS[j % len(_EW_OPS)]
            body.append(f"  %e{i}_{j} = {_T16} {op}(%{cur}, %gte{i})\n")
            cur = f"e{i}_{j}"
        if with_coll:
            body.append(f"  %c{i} = {_T16} {kind}(%{cur}), "
                        "replica_groups={{0,1,2,3}}, to_apply=%sum\n")
            cur = f"c{i}"
        if with_fusion:
            comps.append(
                f"%fused_{i} (fp{i}: f32[16,16]) -> f32[16,16] {{\n"
                f"  %fp{i} = {_T16} parameter(0)\n"
                f"  %fe{i} = {_T16} exponential(%fp{i})\n"
                f"  ROOT %fm{i} = {_T16} multiply(%fe{i}, %fe{i})\n"
                "}\n")
            body.append(f"  %fu{i} = {_T16} fusion(%{cur}), kind=kLoop, "
                        f"calls=%fused_{i}\n")
            cur = f"fu{i}"
        if inner and i == 0:
            comps.append(
                f"%ibody_{i} (ibp{i}: (f32[16,16])) -> (f32[16,16]) {{\n"
                f"  %ibp{i} = ({_T16}) parameter(0)\n"
                f"  %igte{i} = {_T16} get-tuple-element(%ibp{i}), index=0\n"
                f"  %im{i} = {_T16} multiply(%igte{i}, %igte{i})\n"
                f"  ROOT %ibt{i} = ({_T16}) tuple(%im{i})\n"
                "}\n")
            comps.append(
                f"%icond_{i} (icp{i}: (f32[16,16])) -> pred[] {{\n"
                f"  %icp{i} = ({_T16}) parameter(0)\n"
                f"  ROOT %ilt{i} = pred[] constant(false)\n"
                "}\n")
            body += [
                f"  %it{i} = ({_T16}) tuple(%{cur})\n",
                f"  %iw{i} = ({_T16}) while(%it{i}), "
                f"condition=%icond_{i}, body=%ibody_{i}, "
                f'backend_config={{"known_trip_count":{{"n":"{inner}"}}}}\n',
                f"  %ig{i} = {_T16} get-tuple-element(%iw{i}), index=0\n"]
            cur = f"ig{i}"
        body.append(f"  ROOT %bt{i} = ({_T16}) tuple(%{cur})\n")
        comps.append(f"%body_{i} (bp{i}: (f32[16,16])) -> (f32[16,16]) {{\n"
                     + "".join(body) + "}\n")
        comps.append(f"%cond_{i} (cp{i}: (f32[16,16])) -> pred[] {{\n"
                     f"  %cp{i} = ({_T16}) parameter(0)\n"
                     f"  ROOT %lt{i} = pred[] constant(false)\n"
                     "}\n")
        entry += [
            f"  %t{i} = ({_T16}) tuple(%{prev})\n",
            f"  %w{i} = ({_T16}) while(%t{i}), condition=%cond_{i}, "
            f"body=%body_{i}, "
            f'backend_config={{"known_trip_count":{{"n":"{t}"}}}}\n',
            f"  %g{i} = {_T16} get-tuple-element(%w{i}), index=0\n"]
        prev = f"g{i}"
    entry.append(f"  ROOT %out = {_T16} add(%{prev}, %{prev})\n")
    return ("HloModule m\n\n" + "\n".join(comps)
            + "\nENTRY %main (p: f32[16,16]) -> f32[16,16] {\n"
            + "".join(entry) + "}\n")


@settings(max_examples=25, deadline=None)
@given(trips=st.lists(st.integers(1, 5), min_size=1, max_size=3),
       ew=st.integers(0, 3),
       kind=st.sampled_from(_COLL_KINDS),
       with_coll=st.booleans(),
       with_fusion=st.booleans(),
       inner=st.integers(0, 4))
def test_per_op_rollup_conserves_on_random_nests(trips, ew, kind,
                                                 with_coll, with_fusion,
                                                 inner):
    """Per-op sums reproduce the module totals on arbitrary while/fusion
    nests, per-op recording never perturbs the totals, and every record
    equals JAX's."""
    txt = _nest_module(trips, ew, kind, with_coll, with_fusion, inner)
    ana = both(txt, per_op=True)
    base = both(txt)
    assert (ana.mxu_flops, ana.vpu_flops, ana.hbm_bytes,
            ana.collective_wire_bytes) == \
        (base.mxu_flops, base.vpu_flops, base.hbm_bytes,
         base.collective_wire_bytes)
    assert sum(o.mxu_flops for o in ana.ops) == \
        pytest.approx(ana.mxu_flops, rel=1e-12)
    assert sum(o.vpu_flops for o in ana.ops) == \
        pytest.approx(ana.vpu_flops, rel=1e-12)
    assert sum(o.hbm_bytes for o in ana.ops) == \
        pytest.approx(ana.hbm_bytes, rel=1e-12)
    assert sum(o.wire_bytes for o in ana.ops) == \
        pytest.approx(ana.collective_wire_bytes, rel=1e-12)
    for i, t in enumerate(trips):
        recs = [o for o in ana.ops if o.computation == f"body_{i}"]
        assert recs and all(o.multiplier == t for o in recs)
    if inner:
        recs = [o for o in ana.ops if o.computation == "ibody_0"]
        assert recs and all(o.multiplier == trips[0] * inner for o in recs)
    if with_fusion:
        fus = [o for o in ana.ops if o.opcode == "fusion"]
        assert len(fus) == len(trips)
        for o in fus:
            assert o.vpu_flops == 2 * 256 * o.multiplier   # exp + multiply
    # the OpCost records round-trip through their dicts
    for o in ana.ops:
        assert H.OpCost.from_dict(o.to_dict()) == o
