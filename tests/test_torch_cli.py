"""The port's command line (``python -m repro_torch``) against the JAX
package's (``python -m repro``).

Every case of ``tests/test_cli.py``, and the command-line cases of
``tests/test_service.py``, runs through both commands with the same
arguments, on the paper's Ivy Bridge file and on the H100 file (both by
path), and must print the same output and exit with the same code.  The
sources are the port's byte copies of the listings, passed by path to
both.  What the port does not carry yet — HLO sources, ``-p
hlo-roofline`` computed, ``fleet`` — exits 2 naming ROADMAP.md Queue 1,
item 6.  A few cases run as real ``python -m`` processes.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("jax")

from repro import cli as j_cli  # noqa: E402
from repro.core import api as j_api  # noqa: E402

from repro_torch import cli  # noqa: E402
from repro_torch.core import api, reports  # noqa: E402
from repro_torch.service import ResultStore  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
IVY = str(REPO / "src" / "repro" / "configs" / "machines" /
          "ivybridge_ep.yaml")
H100 = str(REPO / "src" / "repro_torch" / "machines" / "h100_sxm.yaml")
STENCILS = REPO / "src" / "repro_torch" / "configs" / "stencils"
S3D7 = str(STENCILS / "stencil_3d7pt.c")
S2D5 = str(STENCILS / "stencil_2d5pt.c")
SLR = str(STENCILS / "stencil_3d_long_range.c")
MACHINES = {"ivy": IVY, "h100": H100}

LONGRANGE = ["analyze", SLR, "-p", "ecm", "-D", "M", "130", "-D", "N",
             "1015"]
SIM = ["--cache-predictor", "SIM", "--sim-warmup-rows", "3",
       "--sim-measure-rows", "2"]

# id -> argv without the machine (inserted as "-m PATH" after the source)
CASES = {
    "listing4": LONGRANGE,
    "cores-6": LONGRANGE + ["--cores", "6"],
    "cores-2": LONGRANGE + ["--cores", "2"],
    "cores-132-json": LONGRANGE + ["--cores", "132", "--json"],
    "cores-json": LONGRANGE + ["--cores", "6", "--json"],
    "multiple-models": LONGRANGE + ["-p", "roofline-iaca"],
    "json": LONGRANGE + ["--json"],
    "c-named": ["analyze", S3D7, "--name", "3d-7pt", "-p", "ecm", "-D", "M",
                "130", "-D", "N", "100", "--json"],
    "trace": ["analyze", "trace:stencil3d7pt", "-p", "ecm", "-D", "M",
              "130", "-D", "N", "100", "--json"],
    "ports": ["analyze", S3D7, "-p", "ecm", "-p", "roofline-iaca",
              "--incore", "ports", "-D", "M", "130", "-D", "N", "100"],
    "sweep": ["sweep", S3D7, "--param", "N", "--range", "50", "80", "10",
              "-D", "M", "20", "--json"],
    "sweep-text": ["sweep", S3D7, "--param", "N", "--range", "50", "80",
                   "10", "-D", "M", "20", "-p", "ecm", "-p", "roofline"],
    "sweep-2d-cores": ["sweep", S3D7, "--range", "M", "20", "40", "20",
                       "--range", "N", "50", "80", "30", "--cores-range",
                       "1", "4", "3", "--dense"],
    "blocking": ["blocking", SLR, "-D", "M", "130", "-D", "N", "1015"],
    "blocking-grid": ["blocking", SLR, "-D", "M", "130", "--grid", "64",
                      "1024", "64", "--cores-range", "1", "8", "7"],
    "sim-auto": ["analyze", S3D7, "-p", "ecm", "-D", "M", "20", "-D", "N",
                 "40"] + SIM + ["--json"],
    "sim-scalar": ["analyze", S3D7, "-p", "ecm", "-D", "M", "20", "-D", "N",
                   "40"] + SIM + ["--json", "--sim-backend", "scalar"],
    "sim-header": ["analyze", S2D5, "-p", "ecm", "-D", "M", "20", "-D", "N",
                   "40", "--cache-predictor", "SIM"],
    "sim-dense-x303": ["sweep", S3D7, "--range", "50", "60", "10", "-D",
                       "M", "20", "--cache-predictor", "SIM", "--dense"],
}
ERRORS = {
    "not-found": (["analyze", "nosuch.c"], "not found"),
    "unknown-model": (["analyze", S3D7, "-p", "bogus", "-D", "M", "8",
                       "-D", "N", "8"], "unknown performance model"),
    "measure-rows": (["analyze", S2D5, "-D", "M", "20", "-D", "N", "40",
                      "--cache-predictor", "SIM", "--sim-measure-rows",
                      "0"], "measure_rows must be >= 1"),
}


def _with_machine(argv, machine):
    return argv[:2] + ["-m", machine] + argv[2:]


def run(main, argv, capsys):
    api.clear_sessions()
    j_api.clear_sessions()
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def run_both(argv, capsys):
    return run(cli.main, argv, capsys), run(j_cli.main, argv, capsys)


@pytest.mark.parametrize("machine", sorted(MACHINES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_prints_what_jax_prints(case, machine, capsys):
    ours, theirs = run_both(_with_machine(CASES[case], MACHINES[machine]),
                            capsys)
    assert ours == theirs
    assert ours[0] == (3 if case.endswith("x303") else 0), ours[2]


def test_analyze_reproduces_listing4(capsys):
    """The paper's Listing-4 ECM terms { 52.0 || 54.0 | 40.0 | 24.0 | 48.5 }
    on Ivy Bridge, from the port's command."""
    rc, out, _ = run(cli.main, _with_machine(LONGRANGE, IVY), capsys)
    assert rc == 0
    assert "{ 52.0 || 54.0 | 40.0 | 24.0 | 48." in out
    assert "saturating at 4 cores" in out


def test_analyze_cores_surfaces_ecm_saturation(capsys):
    rc, out, _ = run(cli.main, _with_machine(LONGRANGE, IVY)
                     + ["--cores", "6"], capsys)
    assert rc == 0 and "performance at 6 cores:" in out
    assert "(saturated)" in out and "scaling (GFLOP/s at 1..6 cores):" in out
    rc, out, _ = run(cli.main, _with_machine(LONGRANGE, IVY)
                     + ["--cores", "2"], capsys)
    assert "(scaling)" in out and "scaling (GFLOP/s at 1..4 cores):" in out


@pytest.mark.parametrize("machine", sorted(MACHINES))
def test_analyze_cores_json_scaling_curve(machine, capsys):
    cores = 6 if machine == "ivy" else 132
    rc, out, _ = run(cli.main, _with_machine(LONGRANGE, MACHINES[machine])
                     + ["--cores", str(cores), "--json"], capsys)
    assert rc == 0
    d = json.loads(out)[0]
    assert d["cores"] == cores
    curve = d["scaling_curve"]
    assert len(curve) == max(cores, d["saturation_cores"])
    assert curve[-1] == d["performance_at_cores"]
    rc, out, _ = run(cli.main, _with_machine(LONGRANGE, MACHINES[machine])
                     + ["--json"], capsys)
    base = json.loads(out)[0]
    assert "scaling_curve" not in base and "cores" not in base


@pytest.mark.parametrize("machine", sorted(MACHINES))
def test_json_output_round_trips(machine, capsys):
    rc, out, _ = run(cli.main, _with_machine(LONGRANGE, MACHINES[machine])
                     + ["-p", "roofline", "--json"], capsys)
    assert rc == 0
    for d in json.loads(out):
        assert reports.result_from_dict(d).to_dict() == d
    assert "[LC] [simple]" in json.loads(out)[0]["notation"]


def test_trace_and_c_frontends_agree_via_cli(capsys):
    for machine in MACHINES.values():
        _, via_c, _ = run(cli.main, _with_machine(CASES["c-named"], machine),
                          capsys)
        _, via_trace, _ = run(cli.main,
                              _with_machine(CASES["trace"], machine), capsys)
        assert via_c == via_trace


def test_sim_backend_flag_and_json_provenance(capsys):
    _, out, _ = run(cli.main, _with_machine(CASES["sim-auto"], IVY), capsys)
    d = json.loads(out)[0]
    assert d["predictor"] == "SIM"
    assert d["predictor_params"]["backend"] == "vector"
    assert "[SIM:vector]" in d["notation"]
    assert reports.result_from_dict(d).to_dict() == d
    _, out, _ = run(cli.main, _with_machine(CASES["sim-scalar"], IVY),
                    capsys)
    d2 = json.loads(out)[0]
    assert d2["predictor_params"]["backend"] == "scalar"
    assert d2["t_ecm"] == d["t_ecm"]


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_cli_errors_exit_2(case, capsys):
    argv, msg = ERRORS[case]
    ours, theirs = run_both(_with_machine(argv, IVY), capsys)
    assert ours[0] == theirs[0] == 2
    assert msg in ours[2] and msg in theirs[2]
    assert ours[1] == theirs[1] == ""


HLO = ("HloModule m\n\n"
       "ENTRY %main (p: f32[1024]) -> f32[1024] {\n"
       "  %p = f32[1024]{0} parameter(0)\n"
       "  ROOT %o = f32[1024]{0} add(%p, %p)\n"
       "}\n")


@pytest.mark.parametrize("argv", [
    ["analyze", "{hlo}", "-m", IVY, "-p", "hlo-roofline"],
    ["analyze", "{hlo}", "-m", H100, "-p", "hlo-roofline", "--json"],
    ["blocking", "{hlo}", "-m", IVY],
    ["sweep", "{hlo}", "-m", IVY, "--range", "1", "2", "1"],
    ["analyze", S3D7, "-m", H100, "--frontend", "hlo"],
    ["fleet", "--all"],
], ids=["hlo-source", "hlo-source-json", "blocking-hlo", "sweep-hlo",
        "frontend-hlo", "fleet"])
def test_unported_cases_name_item_6(argv, tmp_path, capsys):
    """Where JAX reads an HLO dump (the ``hlo`` frontend, ``hlo-roofline``,
    ``blocking``'s X304, ``fleet``), the port exits 2 naming the item."""
    path = tmp_path / "toy.hlo"
    path.write_text(HLO)
    rc, out, err = run(cli.main, [str(path) if a == "{hlo}" else a
                                  for a in argv], capsys)
    assert rc == 2 and out == ""
    assert "ROADMAP.md Queue 1, item 6" in err


# ----------------------------------------------------------------------
# --cache-dir, --stats and the cache subcommand (tests/test_service.py)
# ----------------------------------------------------------------------

ANALYZE = ["analyze", S3D7, "-m", H100, "-D", "M", "130", "-D", "N", "100"]


def test_cli_cache_dir_round_trip(tmp_path, capsys):
    argv = ANALYZE + ["--stats", "--json"]
    runs = {}
    for side, main in (("port", cli.main), ("jax", j_cli.main)):
        cache = ["--cache-dir", str(tmp_path / side)]
        runs[side] = [run(main, argv + cache, capsys) for _ in range(2)]
    assert runs["port"] == runs["jax"]
    cold, warm = (json.loads(out) for _, out, _ in runs["port"])
    assert cold["stats"]["service"]["computed"] == 1
    assert warm["stats"]["service"]["disk_hits"] == 1
    assert warm["stats"]["service"]["computed"] == 0
    assert warm["stats"]["session"]["misses"] == 0
    assert warm["results"] == cold["results"]
    # the JAX command reads the port's store warm too
    _, out, _ = run(j_cli.main, argv + ["--cache-dir", str(tmp_path /
                                                           "port")], capsys)
    assert json.loads(out) == warm


def test_cli_stats_without_cache_dir(capsys):
    ours, theirs = run_both(ANALYZE + ["--stats"], capsys)
    assert ours == theirs and "stats: hits" in ours[1]
    ours, theirs = run_both(ANALYZE + ["--stats", "--json"], capsys)
    assert ours == theirs
    payload = json.loads(ours[1])
    assert set(payload) == {"results", "stats"}


def test_cli_json_shape_unchanged_without_stats(capsys):
    ours, theirs = run_both(ANALYZE + ["--json"], capsys)
    assert ours == theirs
    payload = json.loads(ours[1])
    assert isinstance(payload, list) and payload[0]["model"] == "ecm"


def test_cli_cache_stats_and_clear(tmp_path, capsys):
    cache = ["--cache-dir", str(tmp_path)]
    assert run(cli.main, ANALYZE + cache, capsys)[0] == 0
    ours, theirs = run_both(["cache", "stats"] + cache + ["--json"], capsys)
    assert ours == theirs
    s = json.loads(ours[1])
    assert s["entries"] == 1 and s["by_kind"] == {"analyze": 1}
    ours, theirs = run_both(["cache", "stats"] + cache, capsys)
    assert ours == theirs
    rc, out, _ = run(cli.main, ["cache", "clear"] + cache, capsys)
    assert rc == 0 and "cleared 1" in out
    rc, out, _ = run(cli.main, ["cache", "stats"] + cache + ["--json"],
                     capsys)
    assert json.loads(out)["entries"] == 0


def test_cli_sweep_stats_json(tmp_path, capsys):
    argv = ["sweep", S3D7, "-m", H100, "--param", "N", "--range", "100",
            "150", "10", "-D", "M", "130", "--stats", "--json"]
    ours = run(cli.main, argv + ["--cache-dir", str(tmp_path / "t")],
               capsys)
    theirs = run(j_cli.main, argv + ["--cache-dir", str(tmp_path / "j")],
                 capsys)
    assert ours == theirs and ours[0] == 0
    payload = json.loads(ours[1])
    assert len(payload["results"]["ecm"]) == 6
    assert payload["stats"]["service"]["requests"] == 1


def test_cli_tune_cache_dir(tmp_path, capsys):
    """``tune --cache-dir``: a predict-only report, then one measured on
    the CPU in process, each replayed from the store on the second run;
    the two keys differ, so the store holds both."""
    base = ["tune", "stencil3d7pt", "-m", "H100", "--shape", "m", "8",
            "--shape", "n_min", "16", "--shape", "n_max", "32", "--top-k",
            "1", "--cache-dir", str(tmp_path), "--json"]
    for extra in (["--no-measure"], ["--device", "cpu", "--no-isolate",
                                     "--reps", "2"]):
        first = run(cli.main, base + extra, capsys)
        assert first[0] == 0
        assert run(cli.main, base + extra, capsys) == first
    kinds = ResultStore(tmp_path).summary(detail=True)["by_kind"]
    assert kinds == {"tune": 2}


# ----------------------------------------------------------------------
# as real processes
# ----------------------------------------------------------------------

def _python_m(package, argv):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run([sys.executable, "-m", package] + argv,
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=120)


@pytest.mark.parametrize("argv", [
    ["analyze", SLR, "-m", H100, "-p", "ecm", "-p", "roofline", "-D", "M",
     "130", "-D", "N", "1015", "--cores", "132", "--json"],
    ["lint", "trace:longrange3d", "-m", H100, "-D", "M", "130", "-D", "N",
     "1015", "--sarif"],
], ids=["analyze-json", "lint-sarif"])
def test_python_m_prints_what_python_m_repro_prints(argv):
    ours, theirs = _python_m("repro_torch", argv), _python_m("repro", argv)
    assert (ours.returncode, ours.stdout, ours.stderr) == \
        (theirs.returncode, theirs.stdout, theirs.stderr) == (0,
                                                              ours.stdout, "")
