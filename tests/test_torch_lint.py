"""The port's lint (``repro_torch.core.lint``) against the JAX package's.

Every case of ``tests/test_lint.py`` runs through both packages on the
same inputs — the same C text through each package's parser, the same
builder stencils, the same machine files (Ivy Bridge, its §1.2.2 variant
and v5e by path, and the H100 file), broken the same way — and the
port's ``LintReport`` must equal JAX's in ``to_dict``, ``to_sarif`` and
``render``, with no ``L000`` (a rule that crashed on a port object).  The
case's own pin (the code it expects) is checked on the port's report.
The ``analyze``/``sweep`` wiring, the store replay and the command line
are held to JAX's the same way.
"""
import dataclasses
import json
import pathlib

import pytest

pytest.importorskip("jax")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:    # container without hypothesis: deterministic shim
    from _hypothesis_fallback import given, settings, st

from repro import cli as j_cli  # noqa: E402
from repro.core import analyze as j_analyze  # noqa: E402
from repro.core import kernel_ir as j_ir  # noqa: E402
from repro.core import lint as j_lint  # noqa: E402
from repro.core import sweep as j_sweep  # noqa: E402
from repro.core.c_parser import parse_kernel as j_parse  # noqa: E402
from repro.core.machine import Machine as JMachine  # noqa: E402
from repro.service import AnalysisService as JService  # noqa: E402

from repro_torch import cli  # noqa: E402
from repro_torch.core import (LintError, analyze, kernel_ir,  # noqa: E402
                              layer_conditions, lint, sweep)
from repro_torch.core.c_parser import parse_kernel  # noqa: E402
from repro_torch.core.machine import Machine  # noqa: E402
from repro_torch.core.predictors import predict_volumes  # noqa: E402
from repro_torch.service import AnalysisService  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
J_MACHINES = REPO / "src" / "repro" / "configs" / "machines"
IVY = str(J_MACHINES / "ivybridge_ep.yaml")
IVY122 = str(J_MACHINES / "ivybridge_ep_sec122.yaml")
V5E = str(J_MACHINES / "tpu_v5e.yaml")
H100 = str(REPO / "src" / "repro_torch" / "machines" / "h100_sxm.yaml")
# the port's byte copies of the listings, passed by path to both packages
STENCILS = REPO / "src" / "repro_torch" / "configs" / "stencils"
PAPER_STENCILS = ["stencil_2d5pt.c", "stencil_3d7pt.c",
                  "stencil_3d_long_range.c"]
LISTING = {f: str(STENCILS / f) for f in PAPER_STENCILS}

SQ = "double a[N];\nfor (int i = 0; i < N; i++) {\n  a[i] = a[i*i];\n}\n"
SQ_W = "double a[N];\nfor (int i = 0; i < N; i++) {\n  a[i*i] = a[i];\n}\n"
DD = ("double a[N];\ndouble b[N];\n"
      "for (int i = 0; i < N; i++) {\n  b[i] = a[i + q];\n}\n")
OOB = ("double a[N];\ndouble b[N];\n"
       "for (int i = 0; i < N; i++) {\n  b[i] = a[i + 1];\n}\n")
RED = ("double s[1];\ndouble a[N];\n"
       "for (int i = 0; i < N; i++) {\n  s[0] = s[0] + a[i];\n}\n")


class Side:
    """One package's lint surface, so that a case is written once."""

    def __init__(self, jax: bool):
        self.lint = j_lint if jax else lint
        self.parse = j_parse if jax else parse_kernel
        self.ir = j_ir if jax else kernel_ir
        self.machine = (JMachine if jax else Machine).from_yaml

    def star2d(self, radius: int, n: int):
        reads = [("a", "j", f"i+{c}") for c in range(-radius, radius + 1)]
        reads += [("a", f"j+{c}", "i")
                  for c in range(-radius, radius + 1) if c]
        return self.ir.make_stencil(
            "star2d", {"a": ("M", "N"), "b": ("M", "N")},
            [("j", radius, f"M-{radius}"), ("i", radius, f"N-{radius}")],
            reads=reads, writes=[("b", "j", "i")],
            flops=self.ir.FlopCount(add=len(reads) - 1, mul=1),
            constants={"M": 4 * radius + 8, "N": n})

    def star3d(self, radius: int, n: int):
        reads = [("a", "k", "j", f"i+{c}")
                 for c in range(-radius, radius + 1)]
        reads += [("a", "k", f"j+{c}", "i")
                  for c in range(-radius, radius + 1) if c]
        reads += [("a", f"k+{c}", "j", "i")
                  for c in range(-radius, radius + 1) if c]
        return self.ir.make_stencil(
            "star3d", {"a": ("M", "N", "N"), "b": ("M", "N", "N")},
            [("k", radius, f"M-{radius}"), ("j", radius, f"N-{radius}"),
             ("i", radius, f"N-{radius}")],
            reads=reads, writes=[("b", "k", "j", "i")],
            flops=self.ir.FlopCount(add=len(reads) - 1, mul=1),
            constants={"M": 2 * radius + 4, "N": n})


JAX, PORT = Side(True), Side(False)


def _ports_without_mul(m):
    entries = {k: v for k, v in m.ports.entries.items() if k != "MUL"}
    return dataclasses.replace(
        m, ports=dataclasses.replace(m.ports, entries=entries))


def _zero_add_rate(m):
    fpc = dict(m.flops_per_cycle)
    fpc["DP"] = {**fpc["DP"], "ADD": 0}
    return dataclasses.replace(m, flops_per_cycle=fpc)


def _inverted_l2(m):
    results = list(m.results)
    idx = next(i for i, r in enumerate(results) if r.level == "L2")
    results[idx] = dataclasses.replace(
        results[idx], bandwidth_bytes=tuple(
            b / 100 for b in results[idx].bandwidth_bytes))
    return dataclasses.replace(m, results=tuple(results))


def _edited(tmp, name, old, new):
    src = pathlib.Path(IVY).read_text()
    assert old in src
    p = tmp / name
    p.write_text(src.replace(old, new))
    return str(p)


GEOM = ("{sets: 64, ways: 8, cl_size: 64}",
        "{sets: 64, ways: 8, cl_size: 64, size: 48 kB}")

# id -> (runner(side, tmp) -> LintReport, the code(s) the JAX test pins,
#        whether the report must be ok())
CASES = {
    "sorted-and-stable": (
        lambda s, t: s.lint.lint_kernel(s.parse(SQ_W, name="bad"),
                                        s.machine(IVY)), ["K101"], False),
    "non-affine-k101": (
        lambda s, t: s.lint.lint_kernel(s.parse(SQ, name="sq"),
                                        s.machine(IVY)), ["K101"], False),
    "data-dependent-k102": (
        lambda s, t: s.lint.lint_kernel(s.parse(DD, name="dd"),
                                        s.machine(IVY)), ["K102"], False),
    "out-of-bounds-k103": (
        lambda s, t: s.lint.lint_kernel(s.parse(OOB, name="oob"),
                                        s.machine(IVY)), ["K103"], None),
    "in-bounds-no-k103": (
        lambda s, t: s.lint.lint_kernel(
            s.parse(pathlib.Path(LISTING["stencil_2d5pt.c"]).read_text(),
                    name="5pt"), s.machine(IVY)), [], None),
    "reduction-k105": (
        lambda s, t: s.lint.lint_kernel(s.parse(RED, name="red"),
                                        s.machine(IVY)), ["K105"], None),
    "way-size-k106": (
        lambda s, t: s.lint.lint_kernel(s.star2d(1, 1024), s.machine(IVY)),
        ["K106"], None),
    "compiled-k107": (
        lambda s, t: s.lint.lint_kernel(
            s.parse(pathlib.Path(LISTING["stencil_3d7pt.c"]).read_text(),
                    name="7pt"), s.machine(IVY)), ["K107"], True),
    "compiled-k107-bound": (
        lambda s, t: s.lint.lint_kernel(
            s.parse(pathlib.Path(LISTING["stencil_3d7pt.c"]).read_text(),
                    name="7pt", constants={"M": 30, "N": 50}),
            s.machine(IVY)), [], True),
    "geometry-m202": (
        lambda s, t: s.lint.lint_machine(
            s.machine(_edited(t, "geom.yaml", *GEOM)),
            filename=str(t / "geom.yaml")), ["M202"], False),
    "shrunk-hierarchy-m202": (
        lambda s, t: s.lint.lint_machine(
            s.machine(_edited(t, "order.yaml", "sets: 512", "sets: 32")),
            filename=str(t / "order.yaml")), ["M202"], False),
    "missing-ports-m203-m204": (
        lambda s, t: s.lint.lint_machine(_ports_without_mul(s.machine(IVY))),
        ["M203", "M204"], False),
    "no-ports-table-m203-info": (
        lambda s, t: s.lint.lint_machine(
            dataclasses.replace(s.machine(IVY), ports=None)), ["M203"], True),
    "zero-flop-rate-m205": (
        lambda s, t: s.lint.lint_machine(_zero_add_rate(s.machine(IVY))),
        ["M205"], False),
    "bandwidth-inversion-m201": (
        lambda s, t: s.lint.lint_machine(_inverted_l2(s.machine(IVY))),
        ["M201"], False),
    "no-hierarchy-m206": (
        lambda s, t: s.lint.lint_machine(
            dataclasses.replace(s.machine(IVY), levels=())), ["M206"], False),
    "kind-mismatch-x301": (
        lambda s, t: s.lint.lint_request(
            s.parse(pathlib.Path(LISTING["stencil_2d5pt.c"]).read_text()),
            s.machine(IVY), models=["hlo-roofline"]), ["X301", "X302"],
        False),
    "kind-mismatch-x301-h100": (
        lambda s, t: s.lint.lint_request(
            s.parse(pathlib.Path(LISTING["stencil_2d5pt.c"]).read_text()),
            s.machine(H100), models=["hlo-roofline"]), ["X301"], False),
    "unknown-model-no-x3": (
        lambda s, t: s.lint.lint_request(
            s.parse(pathlib.Path(LISTING["stencil_2d5pt.c"]).read_text()),
            s.machine(IVY), models=["bogus"]), [], None),
    "sim-dense-x303": (
        lambda s, t: s.lint.lint_request(
            s.parse(pathlib.Path(LISTING["stencil_2d5pt.c"]).read_text()),
            s.machine(IVY), models=["ecm"], predictor="SIM", compiled=True),
        ["X303"], False),
    "sim-nd-grid-x307": (
        lambda s, t: s.lint.lint_request(
            s.parse(pathlib.Path(LISTING["stencil_3d7pt.c"]).read_text()),
            s.machine(H100), models=["ecm"], predictor="SIM",
            sweep_params=["M", "N"], cores_axis=True), ["X307"], True),
    "ports-without-table-x306": (
        lambda s, t: s.lint.lint_request(
            s.parse(pathlib.Path(LISTING["stencil_2d5pt.c"]).read_text()),
            dataclasses.replace(s.machine(IVY), ports=None),
            models=["ecm"], incore="ports"), ["X306"], False),
    "load-failure-k100": (
        lambda s, t: s.lint.load_failure(
            "nosuch.c", FileNotFoundError("gone")), ["K100"], False),
    "load-failure-m200": (
        lambda s, t: s.lint.load_failure(
            "bad.yaml", ValueError("bad"), kind="machine"), ["M200"], False),
    "lc-unsafe-k106": (
        lambda s, t: s.lint.lint_kernel(s.star2d(4, 1024), s.machine(IVY)),
        ["K106"], None),
    "odd-leading-dimension": (
        lambda s, t: s.lint.lint_kernel(s.star2d(2, 201), s.machine(IVY)),
        [], None),
}
for _f in PAPER_STENCILS:
    for _m, _path in (("ivy", IVY), ("h100", H100)):
        CASES[f"paper-{_f[:-2]}-{_m}"] = (
            lambda s, t, f=_f, p=_path: s.lint.lint_request(
                s.parse(pathlib.Path(LISTING[f]).read_text(), name=f),
                s.machine(p), models=["ecm"], predictor="LC",
                incore="simple"), [], True)
for _name, _path in (("IVY", IVY), ("IVY122", IVY122), ("V5E", V5E),
                     ("H100", H100)):
    CASES[f"bundled-machine-{_name}"] = (
        lambda s, t, p=_path: s.lint.lint_machine(s.machine(p)), [], True)


def assert_same(ours, theirs):
    """The port's report equals JAX's in every encoding, and no rule of
    the port crashed."""
    assert "L000" not in ours.codes(), ours.render()
    assert ours.to_dict() == theirs.to_dict()
    assert ours.to_sarif() == theirs.to_sarif()
    assert ours.render() == theirs.render()


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_equals_jax(case, tmp_path):
    run, codes, ok = CASES[case]
    theirs = run(JAX, tmp_path)
    ours = run(PORT, tmp_path)
    assert_same(ours, theirs)
    for code in codes:
        assert code in ours.codes(), ours.render()
    if ok is not None:
        assert ours.ok() is ok, ours.render()
    if case.startswith(("paper-", "bundled-machine-")):
        assert not ours.warnings, ours.render()


def test_registry_is_jax_s():
    assert sorted(lint.RULE_REGISTRY) == sorted(j_lint.RULE_REGISTRY)
    for code, rule in lint.RULE_REGISTRY.items():
        theirs = j_lint.RULE_REGISTRY[code]
        assert (rule.family, rule.title, rule.needs) == \
            (theirs.family, theirs.title, theirs.needs)
    assert lint.LC_UNSAFE_CODES == j_lint.LC_UNSAFE_CODES
    assert lint.SEVERITIES == j_lint.SEVERITIES


def test_report_is_memoized_and_severity_sorted():
    k = parse_kernel(SQ_W, name="bad")
    ivy = Machine.from_yaml(IVY)
    rep = lint.lint_kernel(k, ivy)
    sevs = [d.severity for d in rep.diagnostics]
    assert sevs == sorted(sevs, key=lint.SEVERITIES.index)
    assert lint.lint_kernel(k, ivy) is rep


def test_spans_point_at_the_source():
    rep = lint.lint_kernel(parse_kernel(OOB, name="oob"),
                           Machine.from_yaml(IVY))
    d = next(d for d in rep.diagnostics if d.code == "K103")
    assert "by 1" in d.message and d.span is not None and d.span.line == 4


def test_hlo_roofline_request_draws_jax_s_words():
    """X301 and X302 fire for a model the port does not carry, in JAX's
    words, while computing it still names its ROADMAP item."""
    k = parse_kernel(pathlib.Path(LISTING["stencil_2d5pt.c"]).read_text())
    rep = lint.lint_request(k, Machine.from_yaml(IVY),
                            models=["hlo-roofline"])
    x302 = next(d for d in rep.errors if d.code == "X302")
    assert x302.suggestion == "use -m V5E (or add the TPU fields)"
    with pytest.raises(ValueError, match="item 6"):
        analyze(LISTING["stencil_2d5pt.c"], IVY, model="hlo-roofline",
                constants={"M": 8, "N": 8})


# ----------------------------------------------------------------------
# analyze / sweep wiring
# ----------------------------------------------------------------------

SRC = LISTING["stencil_3d7pt.c"]


@pytest.mark.parametrize("machine", [IVY, H100])
def test_warn_mode_bit_for_bit_parity(machine):
    kw = dict(model="ecm", constants={"M": 130, "N": 100})
    off = analyze(SRC, machine, **kw).to_dict()
    warn = analyze(SRC, machine, lint="warn", **kw).to_dict()
    assert warn == j_analyze(SRC, machine, lint="warn", **kw).to_dict()
    diags = warn.pop("diagnostics")
    assert warn == off and isinstance(diags, list)


def test_warn_mode_carries_findings():
    res = analyze(SRC, IVY, model="ecm", lint="warn")
    assert res.to_dict() == j_analyze(SRC, IVY, model="ecm",
                                      lint="warn").to_dict()
    assert "K107" in [d["code"] for d in res.to_dict()["diagnostics"]]
    assert res.report.ok()
    assert res.t_ecm == res.result.t_ecm      # delegation


def test_error_mode_raises_before_compute():
    with pytest.raises(LintError) as ours:
        analyze(SRC, IVY, model="hlo-roofline",
                constants={"M": 8, "N": 8}, lint="error")
    with pytest.raises(j_lint.LintError) as theirs:
        j_analyze(SRC, IVY, model="hlo-roofline",
                  constants={"M": 8, "N": 8}, lint="error")
    assert "X301" in ours.value.report.codes()
    assert str(ours.value) == str(theirs.value)
    assert_same(ours.value.report, theirs.value.report)


def test_error_mode_passes_clean_requests():
    res = analyze(SRC, H100, model="ecm", constants={"M": 130, "N": 100},
                  lint="error")
    assert res.to_dict()["diagnostics"] == []


def test_unknown_lint_mode_rejected():
    with pytest.raises(ValueError, match="lint mode") as ours:
        analyze(SRC, IVY, model="ecm", lint="loud")
    with pytest.raises(ValueError) as theirs:
        j_analyze(SRC, IVY, model="ecm", lint="loud")
    assert str(ours.value) == str(theirs.value)


def test_sweep_attaches_one_report_to_every_result():
    kw = dict(models=["ecm"], constants={"M": 20}, lint="warn")
    out = sweep(SRC, IVY, "N", [50, 60], **kw)
    assert len({id(r.report) for r in out["ecm"]}) == 1
    theirs = j_sweep(SRC, IVY, "N", [50, 60], **kw)
    assert [r.to_dict() for r in out["ecm"]] == \
        [r.to_dict() for r in theirs["ecm"]]
    plain = sweep(SRC, IVY, "N", [50, 60], models=["ecm"],
                  constants={"M": 20})
    for r, p in zip(out["ecm"], plain["ecm"]):
        d = r.to_dict()
        d.pop("diagnostics")
        assert d == p.to_dict()


# ----------------------------------------------------------------------
# the store replays reports
# ----------------------------------------------------------------------

@pytest.mark.parametrize("filler", ["port", "jax"])
def test_lint_report_stored_and_replayed(filler, tmp_path):
    """A report stored by either package replays from disk in the port
    without a rule run, equal to the one computed."""
    svc = (AnalysisService if filler == "port" else JService)(
        cache_dir=str(tmp_path))
    r1 = svc.analyze(SRC, IVY, "ecm", lint="warn")
    assert "K107" in [d["code"] for d in r1.to_dict()["diagnostics"]]
    assert svc.store.summary(detail=True)["by_kind"].get("lint") == 1
    lint.clear_report_cache()
    s2 = AnalysisService(cache_dir=str(tmp_path))
    r2 = s2.analyze(SRC, IVY, "ecm", lint="warn")
    assert r2.to_dict() == r1.to_dict()
    assert s2.stats.computed == 0 and s2.stats.disk_hits == 2


def test_service_error_mode_raises(tmp_path):
    svc = AnalysisService(cache_dir=str(tmp_path))
    with pytest.raises(LintError):
        svc.analyze(LISTING["stencil_2d5pt.c"], IVY, "hlo-roofline",
                    lint="error")


# ----------------------------------------------------------------------
# the command line, against JAX's
# ----------------------------------------------------------------------

def run_both(argv, capsys):
    rc = cli.main(argv)
    ours = capsys.readouterr()
    j_rc = j_cli.main(argv)
    theirs = capsys.readouterr()
    return (rc, ours.out, ours.err), (j_rc, theirs.out, theirs.err)


@pytest.mark.parametrize("fname", PAPER_STENCILS)
@pytest.mark.parametrize("machine", [IVY, H100])
def test_lint_paper_stencils_exit_0(fname, machine, capsys):
    ours, theirs = run_both(["lint", LISTING[fname], "-m", machine], capsys)
    assert ours == theirs
    assert ours[0] == 0
    assert "0 error(s)" in ours[1] or "no findings" in ours[1]


def test_lint_non_affine_exit_3(tmp_path, capsys):
    p = tmp_path / "sq.c"
    p.write_text(SQ)
    ours, theirs = run_both(["lint", str(p), "-m", IVY], capsys)
    assert ours == theirs
    assert ours[0] == 3 and "[K101]" in ours[1]


@pytest.mark.parametrize("fmt", ["--json", "--sarif"])
@pytest.mark.parametrize("machine", [IVY, H100])
def test_lint_json_and_sarif(fmt, machine, capsys):
    ours, theirs = run_both(["lint", SRC, "-m", machine, fmt], capsys)
    assert ours == theirs and ours[0] == 0
    d = json.loads(ours[1])
    if fmt == "--json":
        assert lint.LintReport.from_dict(d).to_dict() == d
    else:
        assert d["runs"][0]["tool"]["driver"]["name"] == "repro-lint"


def test_lint_unreadable_source_is_diagnostic(capsys):
    ours, theirs = run_both(["lint", "nosuch.c", "-m", IVY], capsys)
    assert ours == theirs
    assert ours[0] == 3 and "[K100]" in ours[1]


def test_lint_hlo_source_names_item_6(tmp_path, capsys):
    """An HLO dump loads in JAX; in the port its load failure is the
    diagnostic (K100), naming the ROADMAP item it waits for."""
    p = tmp_path / "toy.hlo"
    p.write_text("HloModule m\n\nENTRY %main (p: f32[8]) -> f32[8] {\n"
                 "  ROOT %p = f32[8]{0} parameter(0)\n}\n")
    assert cli.main(["lint", str(p), "-m", V5E]) == 3
    out = capsys.readouterr().out
    assert "[K100]" in out and "item 6" in out


def test_machine_validate_all_bundled_clean(capsys):
    assert cli.main(["machine", "validate"]) == 0
    out = capsys.readouterr().out
    assert "h100_sxm.yaml" in out and "error" not in out
    ours, theirs = run_both(["machine", "validate", IVY, IVY122, V5E, H100,
                             "--json"], capsys)
    assert ours == theirs and ours[0] == 0


def test_machine_validate_broken_yaml_exit_3(tmp_path, capsys):
    p = tmp_path / "broken.yaml"
    p.write_text("model name: [unterminated\n")
    for fmt in ([], ["--json"]):
        ours, theirs = run_both(["machine", "validate", str(p)] + fmt,
                                capsys)
        assert ours == theirs and ours[0] == 3
    d = json.loads(ours[1])
    assert d[0]["file"] == str(p) and d[0]["errors"] == 1


def test_machine_validate_inconsistent_geometry(tmp_path, capsys):
    p = _edited(tmp_path, "geom.yaml", *GEOM)
    ours, theirs = run_both(["machine", "validate", p], capsys)
    assert ours == theirs
    assert ours[0] == 3 and "[M202]" in ours[1]


@pytest.mark.parametrize("machine", [IVY, H100])
def test_analyze_preflight_rejects_kind_mismatch(machine, capsys):
    ours, theirs = run_both(
        ["analyze", LISTING["stencil_2d5pt.c"], "-m", machine,
         "-p", "hlo-roofline", "-D", "M", "8", "-D", "N", "8"], capsys)
    assert ours == theirs
    assert ours[0] == 3 and "X301" in ours[2]


# ----------------------------------------------------------------------
# the LC-safety verdict is sound on the port too
# ----------------------------------------------------------------------

@given(st.integers(1, 2), st.integers(48, 220), st.booleans())
@settings(max_examples=8, deadline=None)
def test_lc_safe_verdict_implies_volume_agreement(radius, n, three_d):
    ivy = Machine.from_yaml(IVY)
    n |= 1
    k = PORT.star3d(radius, n) if three_d else PORT.star2d(radius, n)
    report = lint.lint_kernel(k, ivy)
    jk = JAX.star3d(radius, n) if three_d else JAX.star2d(radius, n)
    assert_same(report, j_lint.lint_kernel(jk, JMachine.from_yaml(IVY)))
    if not lint.lc_safe(report):
        return
    for lv in ivy.levels:
        for tr in layer_conditions.transition_points(k, lv.size_bytes, "N"):
            if abs(n - tr.max_value) < 8:
                return
    lc = predict_volumes(k, ivy, predictor="LC")
    sim = predict_volumes(k, ivy, predictor="SIM",
                          sim_kwargs={"warmup_rows": 6, "measure_rows": 2})
    for lvl in ("L1", "L2"):
        assert sim.volume(lvl) == pytest.approx(lc.volume(lvl),
                                                abs=ivy.cacheline_bytes)


def test_lc_unsafe_verdict_diverges():
    ivy = Machine.from_yaml(IVY)
    k = PORT.star2d(4, 1024)
    report = lint.lint_kernel(k, ivy)
    assert not lint.lc_safe(report) and "K106" in report.codes()
    lc = predict_volumes(k, ivy, predictor="LC")
    sim = predict_volumes(k, ivy, predictor="SIM",
                          sim_kwargs={"warmup_rows": 6, "measure_rows": 2})
    assert abs(sim.volume("L1") - lc.volume("L1")) > ivy.cacheline_bytes
