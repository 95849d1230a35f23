"""The port's fleet analyzer (``repro_torch.fleet``, ``python -m
repro_torch fleet``) against the JAX package's.

Every case of ``tests/test_fleet.py`` runs here through both packages on
the same input — the toy module, the ten bundled dumps, the same machine
files — and the port's reports must equal JAX's ``to_dict()`` exactly.
JAX's two machines (Ivy Bridge and v5e) are passed by path: the port
bundles only its card, ``h100_sxm.yaml``, which is its default machine.
On JAX's files, the port's 20 artifacts pass ``scripts/fleet_gate.py``
against ``benchmarks/golden/fleet/``; the gate's own cases run on the
port's artifacts.  Stores are shared: either package fills a cache
directory and the other reads every report from disk.
"""
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("jax")

from repro import cli as j_cli  # noqa: E402
from repro import fleet as j_fleet  # noqa: E402
from repro.core import api as j_api  # noqa: E402
from repro.core.hlo_analysis import OpCost as JOpCost  # noqa: E402

from repro_torch import cli, configs  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core.hlo_analysis import OpCost  # noqa: E402
from repro_torch.fleet import (DEFAULT_MACHINES, DUMP_DIR,  # noqa: E402
                               FleetAnalyzer, FleetReport, MachineRates,
                               dump_configs, load_program, machine_label,
                               price_op)
from repro_torch.fleet import analyzer as t_analyzer  # noqa: E402
from repro_torch.service import ResultStore  # noqa: E402
from _torch_machines import H100, IVY, V5E, jax_side  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_DIR = REPO / "benchmarks" / "golden" / "fleet"
JAX_PAIR = (IVY, V5E)          # the goldens' machines, by path
J_PAIR = tuple(jax_side(m) for m in JAX_PAIR)   # JAX's own files of them

TOY_HLO = """\
HloModule toy_fleet

%body (bp: (f32[64,64])) -> (f32[64,64]) {
  %bp = (f32[64,64]{1,0}) parameter(0)
  %gte = f32[64,64]{1,0} get-tuple-element(%bp), index=0
  %dot = f32[64,64]{1,0} dot(%gte, %gte), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %add = f32[64,64]{1,0} add(%dot, %gte)
  %ar = f32[64,64]{1,0} all-reduce(%add), replica_groups={{0,1,2,3}}, to_apply=%sum
  ROOT %bt = (f32[64,64]{1,0}) tuple(%ar)
}

%cond (cp: (f32[64,64])) -> pred[] {
  %cp = (f32[64,64]{1,0}) parameter(0)
  ROOT %lt = pred[] constant(false)
}

ENTRY %main (p: f32[64,64]) -> f32[64,64] {
  %p = f32[64,64]{1,0} parameter(0)
  %t = (f32[64,64]{1,0}) tuple(%p)
  %w = (f32[64,64]{1,0}) while(%t), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"7"}}
  %g = f32[64,64]{1,0} get-tuple-element(%w), index=0
  ROOT %out = f32[64,64]{1,0} multiply(%g, %g)
}
"""


def _load_gate():
    spec = importlib.util.spec_from_file_location(
        "fleet_gate", REPO / "scripts" / "fleet_gate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_artifacts(tmp_path_factory):
    """The port's 20 artifacts on JAX's two machine files, by path."""
    out = tmp_path_factory.mktemp("fleet") / "art"
    an = FleetAnalyzer()
    an.write_artifacts(an.analyze_all(None, JAX_PAIR), JAX_PAIR, out)
    return out


def _report_pair(config, machine, **kw):
    ours = FleetAnalyzer(**kw).analyze(config, machine)
    theirs = j_fleet.FleetAnalyzer(**kw).analyze(config, jax_side(machine))
    assert ours.to_dict() == theirs.to_dict()
    assert ours.render() == theirs.render()
    return ours


# ----------------------------------------------------------------------
# MachineRates: both machine dialects, and the H100 file
# ----------------------------------------------------------------------

def _rates_pair(machine, dtype="BF16"):
    ours = MachineRates.from_machine(api.resolve_machine(machine), dtype)
    theirs = j_fleet.MachineRates.from_machine(
        j_api.resolve_machine(jax_side(machine)), dtype)
    assert ours.to_dict() == theirs.to_dict()
    return ours


def test_machine_rates_x86_dialect():
    r = _rates_pair(IVY)
    assert r.kind == "x86"
    assert r.mxu_peak == pytest.approx(240e9)
    assert r.vpu_peak == r.mxu_peak
    assert r.mem_bandwidth == pytest.approx(47.2e9, rel=1e-6)
    assert r.wire_bandwidth == r.mem_bandwidth
    assert r.fingerprint == api.resolve_machine(IVY).fingerprint


@pytest.mark.parametrize("machine", [V5E, H100])
def test_machine_rates_tpu_dialect(machine):
    mach = api.resolve_machine(machine)
    r = _rates_pair(machine, "BF16")
    assert r.kind == "tpu"
    assert r.mxu_peak == pytest.approx(float(mach.peak_flops["BF16"]))
    assert r.mem_bandwidth == pytest.approx(float(mach.hbm_bandwidth))
    assert r.mxu_peak > r.vpu_peak > 0
    assert r.wire_bandwidth == mach.ici_link_bandwidth
    for dtype in ("FP32", "fp32"):
        _rates_pair(machine, dtype)
    with pytest.raises(ValueError, match="no peak flops for dtype") as e:
        MachineRates.from_machine(mach, "FP64")
    with pytest.raises(ValueError) as je:
        j_fleet.MachineRates.from_machine(
            j_api.resolve_machine(jax_side(machine)), "FP64")
    assert str(e.value) == str(je.value)


def test_h100_rates_are_the_card_s():
    """The H100 file: tensor-core BF16 and CUDA-core FP32 peaks, HBM3 and
    the NVLink estimate (450 GB/s a direction)."""
    r = MachineRates.from_machine(api.resolve_machine("H100"))
    assert (r.mxu_peak, r.vpu_peak, r.mem_bandwidth, r.wire_bandwidth) == \
        (9.89e14, 6.7e13, 3.35e12, 450e9)


def test_price_op_bound_classes():
    kw = dict(machine="m", fingerprint="fp", kind="tpu", mxu_peak=100.0,
              vpu_peak=10.0, mem_bandwidth=50.0, wire_bandwidth=5.0)
    opk = dict(name="o", opcode="dot", computation="e", shape="f32[2]",
               multiplier=1, mxu_flops=200.0, vpu_flops=10.0,
               hbm_bytes=50.0, wire_bytes=5.0)
    p = price_op(OpCost(**opk), MachineRates(**kw))
    jp = j_fleet.price_op(JOpCost(**opk), j_fleet.MachineRates(**kw))
    assert p.to_dict() == jp.to_dict()
    assert (p.t_mxu, p.t_vpu, p.t_memory, p.t_collective) == (2, 1, 1, 1)
    assert p.bound == "MXU" and p.t_pred == 2.0 and p.t_serial == 4.0
    assert p.t_compute == 2.0
    assert type(p).from_dict(p.to_dict()).to_dict() == p.to_dict()


def test_machine_label_stability():
    """The port's aliases label as their files, as JAX's do; a file by
    path labels as its stem in both packages, so the goldens' names come
    out."""
    assert DEFAULT_MACHINES == ("H100",)
    assert machine_label("H100") == "h100_sxm"
    for alias in ("IVY", "IVY122", "V5E"):
        assert machine_label(alias) == j_fleet.machine_label(alias)
    for spec in (IVY, V5E, H100, "path/to/tpu_v5e.yaml", "x.yml"):
        assert machine_label(spec) == j_fleet.machine_label(jax_side(spec))
    assert machine_label(IVY) == "ivybridge_ep"
    assert machine_label(V5E) == "tpu_v5e"
    for spec in (IVY, V5E, H100):
        assert machine_label(api.resolve_machine(spec)) == \
            j_fleet.machine_label(j_api.resolve_machine(jax_side(spec)))


# ----------------------------------------------------------------------
# FleetAnalyzer on a toy module: report shape + conservation
# ----------------------------------------------------------------------

@pytest.mark.parametrize("machine", [IVY, V5E, H100, "H100"],
                         ids=["ivy", "v5e", "h100-path", "h100-default"])
def test_toy_report_shape_and_conservation(machine):
    if machine == "H100":       # the port's default, by its alias
        rep = FleetAnalyzer().analyze(TOY_HLO, machine)
        assert rep.to_dict() == j_fleet.FleetAnalyzer().analyze(
            TOY_HLO, H100).to_dict()
    else:
        rep = _report_pair(TOY_HLO, machine)
    assert isinstance(rep, FleetReport) and rep.conserved
    assert rep.totals["n_ops"] == 4          # dot, add, ar (x7), multiply
    assert rep.totals["n_collectives"] == 1
    by_name = {d["name"]: d for d in rep.top_ops}
    assert by_name["dot"]["multiplier"] == 7
    assert by_name["out"]["multiplier"] == 1
    assert rep.t_graph_serial >= rep.t_graph > 0
    assert sum(b["share"] for b in rep.bounds.values()) \
        == pytest.approx(1.0)
    assert rep.bottleneck in rep.bounds
    assert sum(d["ops"] for d in rep.layers) == rep.totals["n_ops"]
    txt = rep.render()
    assert f"Fleet report: {rep.config}" in txt and "bound mix:" in txt


def test_report_round_trip_exact():
    rep = _report_pair(TOY_HLO, V5E)
    d = rep.to_dict()
    assert d["kind"] == "fleet-report" and d["schema"] == 1
    rebuilt = FleetReport.from_dict(json.loads(json.dumps(d)))
    assert rebuilt.to_dict() == d
    # each package rebuilds the other's payload
    assert j_fleet.FleetReport.from_dict(d).to_dict() == d
    with pytest.raises(ValueError, match="not a fleet-report"):
        FleetReport.from_dict({**d, "schema": 999})


def test_fleet_reports_served_from_disk(tmp_path):
    an1 = FleetAnalyzer(cache_dir=tmp_path)
    rep1 = an1.analyze(TOY_HLO, V5E)
    assert an1.service.stats.computed >= 1
    an2 = FleetAnalyzer(cache_dir=tmp_path)
    rep2 = an2.analyze(TOY_HLO, V5E)
    assert an2.service.stats.disk_hits == 1
    assert an2.service.stats.computed == 0
    assert rep2.to_dict() == rep1.to_dict()
    assert an2.analyze(TOY_HLO, V5E) is rep2


@pytest.mark.parametrize("filler", ["jax", "port"])
def test_stores_are_shared_across_packages(filler, tmp_path):
    """A store one package fills serves the other from disk: the fleet
    entries and the hlo-roofline entries behind them have the same keys,
    digest for digest."""
    fill, read = ((j_fleet.FleetAnalyzer, FleetAnalyzer) if filler == "jax"
                  else (FleetAnalyzer, j_fleet.FleetAnalyzer))
    configs_ = dump_configs()[:2]
    machines = {FleetAnalyzer: [V5E, IVY, H100]}
    machines[j_fleet.FleetAnalyzer] = [jax_side(m)
                                       for m in machines[FleetAnalyzer]]
    cold = fill(cache_dir=tmp_path).analyze_all(configs_, machines[fill])
    entries = ResultStore(tmp_path).summary(detail=True)
    assert entries["by_kind"] == {"fleet": 6, "analyze": 4}
    warm_an = read(cache_dir=tmp_path)
    warm = warm_an.analyze_all(configs_, machines[read])
    assert [r.to_dict() for r in warm] == [r.to_dict() for r in cold]
    assert warm_an.service.stats.disk_hits == 6
    assert warm_an.service.stats.computed == 0
    assert ResultStore(tmp_path).summary(detail=True) == entries


def test_hlo_roofline_store_keys_match_jax(tmp_path):
    prog = load_program("granite-8b")[0]
    from repro.service import AnalysisService as JService
    from repro_torch.service import AnalysisService
    j_res = JService(cache_dir=tmp_path).analyze(
        j_fleet.load_program("granite-8b")[0], H100, "hlo-roofline")
    svc = AnalysisService(cache_dir=tmp_path)
    res = svc.analyze(prog, H100, "hlo-roofline")
    assert res.to_dict() == j_res.to_dict()
    assert svc.stats.disk_hits == 1 and svc.stats.computed == 0


def test_load_program_rejects_unknown_config():
    with pytest.raises(FileNotFoundError, match="bundled") as ours:
        load_program("no-such-config")
    with pytest.raises(FileNotFoundError) as theirs:
        j_fleet.load_program("no-such-config")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("spec", ["granite-8b", "text", "path", "program"])
def test_load_program_sources_match_jax(spec, tmp_path):
    dump = DUMP_DIR / "granite-8b.hlo.gz"
    src = {"granite-8b": "granite-8b", "text": TOY_HLO,
           "path": str(tmp_path / "toy.hlo"),
           "program": load_program(TOY_HLO)[0]}[spec]
    (tmp_path / "toy.hlo").write_text(TOY_HLO)
    prog, label = load_program(src)
    j_src = j_fleet.load_program(TOY_HLO)[0] if spec == "program" else src
    j_prog, j_label = j_fleet.load_program(j_src)
    assert label == j_label
    assert prog.cache_key() == j_prog.cache_key()
    if spec == "granite-8b":
        assert label == dump.name


# ----------------------------------------------------------------------
# Bundled dumps + goldens: every config, both JAX machines
# ----------------------------------------------------------------------

def test_every_config_has_a_dump_and_goldens():
    assert dump_configs() == sorted(configs.ARCH_IDS) == \
        j_fleet.dump_configs()
    labels = [machine_label(m) for m in JAX_PAIR]
    missing = [f"{c}__{l}.json" for c in dump_configs() for l in labels
               if not (GOLDEN_DIR / f"{c}__{l}.json").is_file()]
    assert not missing, f"goldens missing: {missing}"


def test_dumps_are_byte_copies_of_jax_s():
    ours = sorted(DUMP_DIR.glob("*.hlo.gz"))
    theirs = sorted(j_fleet.DUMP_DIR.glob("*.hlo.gz"))
    assert DUMP_DIR != j_fleet.DUMP_DIR
    assert DUMP_DIR.parent.parent.name == "repro_torch"
    assert [p.name for p in ours] == [p.name for p in theirs]
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes(), a.name


def test_bundled_dump_analyzes_and_matches_golden_structure():
    cfg = dump_configs()[0]
    rep = _report_pair(cfg, V5E)
    assert rep.conserved and rep.source == f"{cfg}.hlo.gz"
    golden = json.loads(
        (GOLDEN_DIR / f"{cfg}__tpu_v5e.json").read_text())
    assert golden["totals"]["n_ops"] == rep.totals["n_ops"]
    assert golden["bottleneck"] == rep.bottleneck
    assert golden["conserved"] is True


@pytest.mark.parametrize("config", sorted(configs.ARCH_IDS))
def test_every_report_equals_jax_s_and_its_golden(config, port_artifacts):
    """Each config on both of JAX's machines: the port's report equals
    JAX's ``to_dict()`` bit for bit, and its artifact passes the gate's
    ``compare`` against the golden with no failure."""
    gate = _load_gate()
    for machine in JAX_PAIR:
        rep = _report_pair(config, machine)
        name = f"{config}__{machine_label(machine)}.json"
        art = json.loads((port_artifacts / name).read_text())
        assert art == rep.to_dict()
        golden = json.loads((GOLDEN_DIR / name).read_text())
        assert gate.compare(art, golden, tol=0.05) == []


@pytest.mark.parametrize("config", sorted(configs.ARCH_IDS))
def test_every_config_on_the_h100(config):
    """The port's card: the report equals JAX's on the same file, it
    conserves, and its module roofline is hlo-roofline's."""
    rep = _report_pair(config, H100)
    assert rep.conserved and rep.rates.kind == "tpu"
    assert rep.module == api.analyze(
        load_program(config)[0], H100, model="hlo-roofline").to_dict()
    assert FleetAnalyzer().analyze(config, "H100").to_dict() == \
        rep.to_dict()


def test_analyze_all_covers_configs_x_machines(tmp_path):
    an = FleetAnalyzer(cache_dir=tmp_path, top=5)
    two = dump_configs()[:2]
    reps = an.analyze_all(two, JAX_PAIR)
    assert len(reps) == len(two) * len(JAX_PAIR)
    paths = an.write_artifacts(reps, JAX_PAIR, tmp_path / "out")
    assert [p.name for p in paths] == [
        f"{c}__{machine_label(m)}.json" for c in two for m in JAX_PAIR]
    j_an = j_fleet.FleetAnalyzer(top=5)
    j_paths = j_an.write_artifacts(j_an.analyze_all(two, J_PAIR),
                                   J_PAIR, tmp_path / "j_out")
    for p, q in zip(paths, j_paths):
        assert p.read_bytes() == q.read_bytes()
        assert json.loads(p.read_text())["kind"] == "fleet-report"
    assert len(FleetAnalyzer().analyze_all(two)) == len(two)   # H100


def test_analyze_all_without_dumps_names_the_source(monkeypatch, tmp_path):
    monkeypatch.setattr(t_analyzer, "DUMP_DIR", tmp_path / "none")
    with pytest.raises(FileNotFoundError, match="no HLO dumps under"):
        FleetAnalyzer().analyze_all()


# ----------------------------------------------------------------------
# The gate on the port's artifacts
# ----------------------------------------------------------------------

def test_gate_passes_on_port_artifacts(port_artifacts, capsys):
    gate = _load_gate()
    assert len(list(port_artifacts.glob("*.json"))) == 20
    assert gate.run_gate(port_artifacts, GOLDEN_DIR, tol=0.05,
                         update=False) == 0
    out = capsys.readouterr().out
    assert "OK (20 reports" in out and "FAIL" not in out


def test_gate_fails_on_injected_time_regression(port_artifacts, tmp_path,
                                                capsys):
    gate = _load_gate()
    art = tmp_path / "art"
    shutil.copytree(port_artifacts, art)
    victim = sorted(art.glob("*.json"))[0]
    d = json.loads(victim.read_text())
    d["t_graph"] *= 1.10
    victim.write_text(json.dumps(d))
    assert gate.run_gate(art, GOLDEN_DIR, tol=0.05, update=False) == 1
    out = capsys.readouterr().out
    assert f"FAIL {victim.name}" in out and "t_graph" in out
    d["t_graph"] /= 1.10
    d["t_graph"] *= 1.03
    victim.write_text(json.dumps(d))
    assert gate.run_gate(art, GOLDEN_DIR, tol=0.05, update=False) == 0


def test_gate_fails_on_structural_changes(port_artifacts, tmp_path, capsys):
    gate = _load_gate()
    art = tmp_path / "art"
    shutil.copytree(port_artifacts, art)
    victim = sorted(art.glob("*.json"))[0]
    d = json.loads(victim.read_text())
    golden = json.loads((GOLDEN_DIR / victim.name).read_text())
    d["totals"]["n_ops"] += 1
    d["conserved"] = False
    victim.write_text(json.dumps(d))
    assert gate.compare(d, golden, tol=0.05)
    assert gate.run_gate(art, GOLDEN_DIR, tol=0.05, update=False) == 1
    out = capsys.readouterr().out
    assert "n_ops" in out and "conserved" in out


def test_gate_fails_on_missing_pairs(port_artifacts, tmp_path, capsys):
    gate = _load_gate()
    art = tmp_path / "art"
    shutil.copytree(port_artifacts, art)
    extra = art / "new-config__tpu_v5e.json"
    shutil.copyfile(sorted(art.glob("*.json"))[0], extra)
    sorted(art.glob("*.json"))[1].unlink()
    assert gate.run_gate(art, GOLDEN_DIR, tol=0.05, update=False) == 1
    out = capsys.readouterr().out
    assert "artifact has no golden" in out and "golden has no artifact" in out


def test_gate_update_goldens_rebaselines(port_artifacts, tmp_path, capsys):
    """Re-baselining into a scratch golden directory (never the checked-in
    one) from the port's artifacts."""
    gate = _load_gate()
    art, gold = tmp_path / "art", tmp_path / "gold"
    shutil.copytree(port_artifacts, art)
    gold.mkdir()
    assert gate.run_gate(art, gold, tol=0.05, update=False) == 2
    assert gate.run_gate(art, gold, tol=0.05, update=True) == 0
    stale = gold / "gone-config__tpu_v5e.json"
    shutil.copyfile(sorted(gold.glob("*.json"))[0], stale)
    assert gate.run_gate(art, gold, tol=0.05, update=True) == 0
    assert not stale.exists()
    assert gate.run_gate(art, gold, tol=0.05, update=False) == 0
    assert gate.run_gate(tmp_path / "empty", gold, tol=0.05,
                         update=False) == 2


# ----------------------------------------------------------------------
# CLI surface: python -m repro_torch fleet, against python -m repro fleet
# ----------------------------------------------------------------------

def run(main, argv, capsys):
    api.clear_sessions()
    j_api.clear_sessions()
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_cli_fleet_single_config_text_and_artifact(tmp_path, capsys):
    """The same report text and artifact bytes; the closing line names
    the gate's ``--artifacts`` (the port writes outside JAX's default)."""
    cfg = dump_configs()[0]
    outs = {}
    for side, main, v5e in (("port", cli.main, V5E),
                            ("jax", j_cli.main, jax_side(V5E))):
        d = tmp_path / side
        outs[side] = run(main, ["fleet", "--config", cfg, "-m", v5e,
                                "--out", str(d)], capsys)
    rc, out, err = outs["port"]
    assert rc == 0 and err == ""
    assert f"Fleet report: {cfg}" in out and "bound mix:" in out
    d = tmp_path / "port"
    assert out.replace(f" --artifacts {d}", "").replace(str(d), "D") == \
        outs["jax"][1].replace(str(tmp_path / "jax"), "D")
    assert f"wrote 1 artifact(s) under {d} (compare: python " \
        f"scripts/fleet_gate.py --artifacts {d})" in out
    name = f"{cfg}__tpu_v5e.json"
    assert (d / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_cli_fleet_json_round_trips(capsys):
    cfg = dump_configs()[0]
    rc, out, _ = run(cli.main, ["fleet", "--config", cfg, "--out", "-",
                                "--json"], capsys)
    assert rc == 0
    payload = json.loads(out)
    assert len(payload) == len(DEFAULT_MACHINES) == 1
    for d in payload:
        rebuilt = FleetReport.from_dict(d)
        assert rebuilt.to_dict() == d and d["conserved"] is True
    ours = run(cli.main, ["fleet", "--config", cfg, "-m", H100, "-m", IVY,
                          "--out", "-", "--json"], capsys)
    theirs = run(j_cli.main, ["fleet", "--config", cfg, "-m", H100, "-m",
                              jax_side(IVY), "--out", "-", "--json"], capsys)
    assert ours == theirs
    assert json.loads(ours[1])[0] == payload[0]


def test_cli_fleet_unknown_config_fails_cleanly(capsys):
    argv = ["fleet", "--config", "no-such-config", "--out", "-"]
    ours, theirs = run(cli.main, argv, capsys), run(j_cli.main, argv,
                                                    capsys)
    assert ours == theirs
    assert ours[0] == 2 and "no-such-config" in ours[2]


def test_cli_fleet_default_out_is_under_build(tmp_path, monkeypatch,
                                              capsys):
    """Without ``--out`` the port writes under ``build/fleet`` of the
    working directory, never into the JAX harness's benchmarks/out."""
    monkeypatch.chdir(tmp_path)
    rc, out, _ = run(cli.main, ["fleet", "--config", "granite-8b"], capsys)
    assert rc == 0
    assert [p.relative_to(tmp_path).as_posix()
            for p in tmp_path.rglob("*.json")] == \
        ["build/fleet/granite-8b__h100_sxm.json"]
    assert "under build/fleet" in out


def test_cli_fleet_warm_store_walks_no_module(tmp_path, monkeypatch,
                                             capsys):
    """``python -m repro fleet --cache-dir C`` fills a store from which
    the port's command answers without walking one module, and the
    reverse (the JAX command's walk patched to fail)."""
    argv = ["fleet", "--all", "-m", H100, "--out", "-", "--json",
            "--cache-dir"]
    j_rc, j_out, _ = run(j_cli.main, argv + [str(tmp_path / "j")], capsys)

    def no_walk(*a, **k):
        raise AssertionError("walked a module on a warm store")

    monkeypatch.setattr(FleetAnalyzer, "_build", no_walk)
    assert run(cli.main, argv + [str(tmp_path / "j")], capsys) == \
        (j_rc, j_out, "")
    monkeypatch.undo()
    rc, out, _ = run(cli.main, argv + [str(tmp_path / "t")], capsys)
    monkeypatch.setattr(j_fleet.FleetAnalyzer, "_build", no_walk)
    assert run(j_cli.main, argv + [str(tmp_path / "t")], capsys) == \
        (rc, out, "") == (0, j_out, "")
    assert len(json.loads(out)) == 10


def _python_m(package, argv):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run([sys.executable, "-m", package] + argv,
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=120)


def test_python_m_fleet_shares_a_store_with_python_m_repro(tmp_path):
    """As real processes: ``python -m repro fleet`` fills the store,
    ``python -m repro_torch fleet`` prints the same reports from it and
    adds no entry."""
    argv = ["fleet", "--config", "granite-8b", "--config", "gemma-7b",
            "-m", V5E, "--out", "-", "--json", "--cache-dir",
            str(tmp_path)]
    theirs = _python_m("repro", [jax_side(a) for a in argv])
    assert theirs.returncode == 0, theirs.stderr
    before = ResultStore(tmp_path).summary(detail=True)
    ours = _python_m("repro_torch", argv)
    assert (ours.returncode, ours.stdout) == (0, theirs.stdout)
    assert ResultStore(tmp_path).summary(detail=True) == before
