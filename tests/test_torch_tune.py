"""The port's autotuner (``repro_torch.tune``) against the JAX package's.

The flash-attention space's visited-step count, the harness's median, the
error summary and the calibration derivation are held to the JAX copies
on the same inputs; reports decode through either package's
``from_dict``; the tune loop runs end to end on the CPU (named as such:
nothing falls back to it), in process and in a spawned child with an
injected fault; and the command line exits 0 without touching a device.
"""
import dataclasses
import json
import math
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

jax = pytest.importorskip("jax")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:    # container without hypothesis: deterministic shim
    from _hypothesis_fallback import given, settings, st

from repro.core.machine import Machine as JMachine  # noqa: E402
from repro.tune import calibrate as j_cal  # noqa: E402
from repro.tune import measure as j_measure  # noqa: E402
from repro.tune import report as j_report  # noqa: E402
from repro.tune import space as j_space  # noqa: E402

from repro_torch.core import api as t_api  # noqa: E402
from repro_torch.core import blocking  # noqa: E402
from repro_torch.core import machine as t_machine  # noqa: E402
from repro_torch.kernels import flash_attention as t_fa  # noqa: E402
from repro_torch.tune import calibrate as t_cal  # noqa: E402
from repro_torch.tune import measure as t_measure  # noqa: E402
from repro_torch.tune import report as t_report  # noqa: E402
from repro_torch.tune import space as t_space  # noqa: E402
from repro_torch.tune import tune  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
H100_YAML = REPO / "src" / "repro_torch" / "machines" / "h100_sxm.yaml"
H100 = t_machine.load("H100")
TINY = {"batch": 1, "heads": 2, "seq_q": 64, "seq_kv": 64, "head_dim": 32,
        "causal": True, "dtype": "float32"}


def _spaces(**config):
    j = j_space.resolve_space("flash_attention",
                              JMachine.from_yaml(H100_YAML), **config)
    t = t_space.resolve_space("flash_attention", H100, **config)
    return j, t


@pytest.mark.parametrize("sq, skv", [(256, 256), (128, 512), (512, 512),
                                     (64, 4096), (96, 96)])
@pytest.mark.parametrize("causal", [True, False])
def test_steps_equal_jax(sq, skv, causal):
    """The causal visit rule of the model equals the JAX space's over a
    grid of blocks (and so the kernel's loop bound, which it states)."""
    j, t = _spaces(seq_q=sq, seq_kv=skv, causal=causal)
    for bq in (4, 8, 16, 32, 64, 96, 128):
        for bkv in (4, 8, 32, 64, 128, 192):
            if sq % bq or skv % bkv:
                continue
            assert t._steps(bq, bkv) == j._steps(bq, bkv), (bq, bkv)


@settings(max_examples=30, deadline=None)
@given(sq=st.integers(1, 256), extra=st.integers(0, 256),
       d=st.sampled_from([4, 32, 64, 96, 112, 128, 256]),
       causal=st.booleans(), dtype=st.sampled_from(["float32", "bfloat16"]))
def test_default_and_advisor_are_feasible(sq, extra, d, causal, dtype):
    """default() and the advisor's pick are feasible — they divide the
    lengths and pass the launch limits — at every shape the space takes."""
    sp = t_space.resolve_space(
        "flash_attention", H100, seq_q=4 * sq, seq_kv=4 * (sq + extra),
        head_dim=d, causal=causal, dtype=dtype)
    cands = [sp.default(), sp._advisor()]
    assert all(c in sp.candidates() for c in cands)
    for p in sp.predict(cands):
        assert p.feasible and 0 < p.seconds < math.inf, p.reason


def test_space_refuses_what_the_kernel_refuses():
    with pytest.raises(ValueError, match="multiples of 4"):
        t_space.resolve_space("flash_attention", H100, seq_q=66)
    with pytest.raises(ValueError, match="ROADMAP Queue 3"):
        t_space.resolve_space("flash_attention", H100, seq_q=128,
                              seq_kv=64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_space.resolve_space("flash_attention", H100, dtype="float16")
    with pytest.raises(ValueError, match="unknown flash_attention config"):
        t_space.resolve_space("flash_attention", H100, seq=1)
    with pytest.raises(ValueError, match="unknown tune family"):
        t_space.resolve_space("matmul", H100)


def test_feasibility_is_the_launch_limit():
    """Every candidate is feasible exactly when the wrapper would launch
    it: blocks divide the lengths and launch_limits accept them on the
    route the wrapper takes; the tensor-core pairs of each dtype (wgmma
    in bf16, bf16x3 in f32) are among them."""
    for dtype in ("bfloat16", "float32"):
        sp = t_space.resolve_space("flash_attention", H100, seq_q=512,
                                   seq_kv=1024, head_dim=128, dtype=dtype)
        cands = sp.candidates()
        n, routes = 0, set()
        for c, p in zip(cands, sp.predict(cands)):
            bq, bkv = c.config["block_q"], c.config["block_kv"]
            lim = t_fa.launch_limits(bq, bkv, 128, dtype)
            ok = 512 % bq == 0 and 1024 % bkv == 0 and lim.ok
            assert p.feasible == ok, (c, p)
            assert sp.route(c) == lim.route \
                == t_fa.route(bq, bkv, 128, dtype)
            n += ok
            routes.add(lim.route)
        assert n > 10
        assert routes == ({"simt", "wgmma"} if dtype == "bfloat16"
                          else {"simt", "bf16x3"})
    for dtype in ("bfloat16", "float32"):
        assert {(b, k) for b, k, d in t_fa.tc_set(dtype) if d == 128} <= \
            {(c.config["block_q"], c.config["block_kv"])
             for c in t_space.resolve_space(
                 "flash_attention", H100, seq_q=512, seq_kv=1024,
                 head_dim=128, dtype=dtype).candidates()}


def test_model_follows_the_kernel():
    """The matmul term runs at the unit of the candidate's route (the
    tensor cores in bf16 for wgmma, three bf16 passes for bf16x3, fp32
    CUDA cores for simt), and the peak is shared over the SMs the CTAs
    keep busy: with fewer CTAs than SMs a pair of halved q blocks runs
    about twice as fast on simt (at head_dim 160, pairs off the
    tensor-core sets).  bf16x3 also pays its split pass."""
    assert t_fa.MATMUL_UNIT == {"wgmma": "BF16", "simt": "FP32",
                                "bf16x3": "BF16"}
    assert t_fa.MATMUL_PASSES == {"wgmma": 1, "simt": 1, "bf16x3": 3}
    assert set(t_fa.STEP_OVERHEAD_CY) == {"wgmma", "simt", "bf16x3"}
    wide = t_space.resolve_space("flash_attention", H100, batch=1, heads=1,
                                 seq_q=1024, seq_kv=1024, head_dim=160,
                                 causal=False, dtype="float32")
    big, small = wide.predict([
        t_space.Candidate.make("flash_attention", block_q=64, block_kv=64),
        t_space.Candidate.make("flash_attention", block_q=32, block_kv=64)])
    assert big.bound == small.bound == "compute"
    assert 1.8 < big.seconds / small.seconds < 2.2
    # 16 CTAs keep 16 of the 132 SMs busy: the products alone take the
    # flops over 16 SMs' share of the fp32 peak
    assert big.seconds >= \
        4 * 1024 * 1024 * 160 / (H100.peak_flops["FP32"] * 16 / 132)
    sp = t_space.resolve_space("flash_attention", H100, batch=1, heads=1,
                               seq_q=1024, seq_kv=1024, causal=False,
                               dtype="float32")
    off = t_space.Candidate.make("flash_attention", block_q=64, block_kv=32)
    assert sp.route(off) == "simt"
    (simt,) = sp.predict([off])
    assert simt.seconds >= \
        4 * 1024 * 1024 * 128 / (H100.peak_flops["FP32"] * 16 / 132)
    bf = t_space.resolve_space("flash_attention", H100, batch=1, heads=1,
                               seq_q=1024, seq_kv=1024, causal=False,
                               dtype="bfloat16")
    cand = t_space.Candidate.make("flash_attention", block_q=64,
                                  block_kv=64)
    assert bf.route(cand) == "wgmma"
    (wg,) = bf.predict([cand])
    floor = 4 * 1024 * 1024 * 128 / (H100.peak_flops["BF16"] * 16 / 132)
    assert floor <= wg.seconds < simt.seconds / 5
    # the same pair in f32: three passes at the bf16 rate plus the split
    assert sp.route(cand) == "bf16x3"
    (x3,) = sp.predict([cand])
    split = t_fa.split_bytes(1024 * 128, 1024 * 128) / H100.hbm_bandwidth
    assert split == 8 * 3 * 1024 * 128 / 3.35e12
    assert 3 * floor + split <= x3.seconds < simt.seconds / 2


def test_model_counts_occupancy_and_padding():
    """CTAs resident per SM come from the route's shared memory and
    threads: at granite-8b's attention a (64, 64) wgmma CTA fits twice on
    an SM, (128, 128) once, so the per-step latency of (64, 64) is spread
    over 264 resident CTAs.  A q block below 64 rows still pays for the
    64-row tile it is padded to."""
    sp = t_space.resolve_space("flash_attention", H100, batch=1, heads=32,
                               seq_q=4096, seq_kv=4096, head_dim=128,
                               causal=False, dtype="bfloat16")
    lim = {pair: t_fa.launch_limits(*pair, 128, "bfloat16")
           for pair in ((64, 64), (128, 128))}
    assert lim[(64, 64)].ctas_per_sm == 2
    assert lim[(128, 128)].ctas_per_sm == 1
    assert sp.concurrency(64, 64) == 264
    assert sp.concurrency(128, 128) == 132
    small = t_space.resolve_space("flash_attention", H100, batch=1,
                                  heads=1, seq_q=256, seq_kv=256,
                                  dtype="bfloat16")
    assert small.concurrency(64, 64) == 4       # fewer CTAs than slots
    pad, full = sp.predict([
        t_space.Candidate.make("flash_attention", block_q=16, block_kv=64),
        t_space.Candidate.make("flash_attention", block_q=64, block_kv=64)])
    assert pad.seconds > 3 * full.seconds


# gemma-7b (src/repro/configs/gemma_7b.py: 16 heads of 256) and zamba2-7b
# (src/repro/configs/zamba2_7b.py: 32 heads of 112) at the train_4k length
REAL_MODELS = {"gemma-7b": {"heads": 16, "head_dim": 256},
               "zamba2-7b": {"heads": 32, "head_dim": 112}}
TC_ROUTE = {"bfloat16": "wgmma", "float32": "bf16x3"}


@pytest.mark.parametrize("model", sorted(REAL_MODELS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_real_model_spaces_take_the_tensor_cores(model, dtype):
    """At gemma-7b's and zamba2-7b's attention every pair of the dtype's
    tensor-core set at the instantiated head dim is a feasible candidate
    on that route, the default takes it, and every candidate is feasible
    exactly when it launches, on the route it names."""
    cfg = REAL_MODELS[model]
    d = cfg["head_dim"]
    sp = t_space.resolve_space("flash_attention", H100, batch=1,
                               seq_q=4096, seq_kv=4096, causal=True,
                               dtype=dtype, **cfg)
    cands = sp.candidates()
    preds = dict(zip(cands, sp.predict(cands)))
    tc = TC_ROUTE[dtype]
    for c, p in preds.items():
        bq, bkv = c.config["block_q"], c.config["block_kv"]
        lim = t_fa.launch_limits(bq, bkv, d, dtype)
        assert p.feasible == (4096 % bq == 0 and 4096 % bkv == 0
                              and lim.ok), (c, p)
        assert sp.route(c) == lim.route == t_fa.route(bq, bkv, d, dtype)
    pairs = {(bq, bkv) for bq, bkv, dd in t_fa.tc_set(dtype)
             if dd == t_fa.tc_head_dim(d)}
    assert len(pairs) == (6 if d == 112 and dtype == "float32" else
                          12 if d == 112 else 5)
    on_tc = {(c.config["block_q"], c.config["block_kv"])
             for c, p in preds.items() if p.feasible and sp.route(c) == tc}
    assert on_tc == pairs
    assert sp.route(sp.default()) == tc
    assert t_fa.route(*t_fa.default_config(4096, 4096, d, dtype), d,
                      dtype) == tc
    best = min((p.seconds, sp.route(c)) for c, p in preds.items())
    assert best[1] == tc


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_model_charges_the_padded_head_dim(dtype):
    """A tensor-core candidate at head_dim 112 does the arithmetic of
    128, the instantiation it runs, and moves the bytes of 112; the
    CUDA-core route computes at 112.  Seen with the HBM term taken away
    (compute alone), and with it (the bytes shrink by 112/128)."""
    fast = dataclasses.replace(H100, hbm_bandwidth=1e30)
    cfg = dict(batch=1, heads=32, seq_q=4096, seq_kv=4096, causal=True,
               dtype=dtype)
    tc = t_space.Candidate.make("flash_attention", block_q=64, block_kv=64)
    simt = t_space.Candidate.make("flash_attention", block_q=64,
                                  block_kv=32)
    by_d = {}
    for d in (112, 128):
        sp = t_space.resolve_space("flash_attention", fast, head_dim=d,
                                   **cfg)
        assert sp.route(tc) == TC_ROUTE[dtype] and sp.route(simt) == "simt"
        by_d[d] = [p.seconds for p in sp.predict([tc, simt])]
    assert by_d[112][0] == by_d[128][0]
    assert by_d[112][1] < by_d[128][1]
    hbm = {d: t_space.resolve_space("flash_attention", H100, head_dim=d,
                                    **cfg).predict([tc])[0]
           for d in (112, 128)}
    assert hbm[112].bound == hbm[128].bound == "L2"
    assert hbm[112].seconds == pytest.approx(hbm[128].seconds * 112 / 128)


def test_attention_bound_at_the_real_model_shapes():
    """The bound counts the real head dim: gemma-7b's attention has
    granite-8b's flops (16 heads of 256 against 32 of 128), zamba2-7b's
    112/128 of them; three bf16 passes in f32."""
    want = {("gemma-7b", torch.bfloat16): 0.1390,
            ("gemma-7b", torch.float32): 0.4170,
            ("zamba2-7b", torch.bfloat16): 0.1216,
            ("zamba2-7b", torch.float32): 0.3649}
    for (model, dtype), ms in want.items():
        cfg = REAL_MODELS[model]
        q = torch.empty(1, cfg["heads"], 4096, cfg["head_dim"], dtype=dtype,
                        device="meta")
        b = t_space.attention_bound(q, q, causal=True, machine=H100)
        assert b.by == "operations"
        assert abs(b.seconds * 1e3 - ms) < 5e-5, (model, dtype)


def test_attention_bound_at_the_granite_shape():
    """4·d flops per visible pair at the BF16 peak, 4 × 32 MiB moved; in
    f32 three bf16 passes by default (0.4170 ms at the granite shape),
    and the fp32 cores' floor when asked for."""
    q = torch.empty(1, 32, 4096, 128, dtype=torch.bfloat16, device="meta")
    b = t_space.attention_bound(q, q, causal=True, machine=H100)
    assert b.bytes == 4 * 32 * 2 ** 20
    flops = 4 * 128 * 32 * 4096 * 4097 // 2
    assert b.ops_s == flops / 9.89e14 and b.by == "operations"
    assert abs(b.seconds * 1e3 - 0.139) < 5e-4
    f = q.float()
    assert t_space.attention_bound(f, f, causal=False, machine=H100,
                                   unit="FP32").ops_s == \
        4 * 128 * 32 * 4096 * 4096 / 6.7e13
    x3 = t_space.attention_bound(f, f, causal=False, machine=H100)
    assert x3.ops_s == 3 * 4 * 128 * 32 * 4096 * 4096 / 9.89e14
    assert x3.bytes == 4 * 64 * 2 ** 20
    causal = t_space.attention_bound(f, f, causal=True, machine=H100)
    assert abs(causal.seconds * 1e3 - 0.4170) < 5e-5
    assert causal.ops_s == 3 * b.ops_s
    floor = t_space.attention_bound(f, f, machine=H100, unit="FP32")
    assert abs(floor.seconds * 1e3 - 2.0518) < 5e-5


@pytest.mark.parametrize("samples", [
    [], [1.0], [3.0, 1.0, 2.0], [1.0, 1.1, 0.9, 1.05, 50.0],
    [0.5, 0.6, 0.55, 0.52, 0.58, 0.01, 0.57, 0.56]])
def test_robust_median_equals_jax(samples):
    assert t_measure.robust_median(samples) == \
        j_measure.robust_median(samples)


PAIRS = [(1e-3, 2e-3, "compute"), (2e-3, 3e-3, "compute"),
         (1e-3, 0.5e-3, "L2"), (0.0, 1.0, "compute"),
         (1e-3, math.inf, "compute")]


def test_prediction_error_and_calibration_equal_jax():
    pairs = [(p, m) for p, m, _ in PAIRS]
    assert t_cal.prediction_error(pairs) == j_cal.prediction_error(pairs)
    assert t_cal.prediction_error([]) == j_cal.prediction_error([])
    jm = JMachine.from_yaml(H100_YAML)
    got = t_cal.derive_calibration("flash_attention", PAIRS, H100,
                                   meta={"k": "v"})
    want = j_cal.derive_calibration("flash_attention", PAIRS, jm,
                                    meta={"k": "v"})
    assert got == want and got["levels"] == {"L2": 0.5}


def test_apply_calibration_round_trips(tmp_path):
    path = tmp_path / "h100_sxm.yaml"
    shutil.copy(H100_YAML, path)
    cal = t_cal.derive_calibration(
        "flash_attention", [(1e-3, 4e-3, "compute")], H100)
    mach = t_cal.apply_calibration(path, cal)
    assert mach.calibration_factor("time", "flash_attention") == \
        pytest.approx(4.0)
    again = t_api.resolve_machine(str(path))
    assert again.calibration == mach.calibration
    assert again.peak_flops == H100.peak_flops
    # written twice, the section is replaced, not appended
    t_cal.apply_calibration(path, cal)
    assert path.read_text().count("calibration:") == 1
    assert path.read_text().startswith(H100_YAML.read_text()[:200])
    assert t_cal.machine_yaml_path("H100") == H100_YAML
    assert t_cal.machine_yaml_path(path) == path
    with pytest.raises(ValueError, match="cannot resolve"):
        t_cal.machine_yaml_path("no_such_machine")


def test_tune_on_the_cpu_end_to_end():
    """The whole loop on the CPU, which the caller names: the report says
    where it measured, chooses the fastest measured candidate and derives
    a time factor."""
    rep = tune("flash_attention", "H100", config=TINY, top_k=2, reps=2,
               isolate=False, device="cpu")
    assert rep.options["device"] == "cpu"
    assert "measured on: cpu" in rep.render()
    ok = [c for c in rep.candidates if c.status == "ok"]
    assert len(ok) >= 2 and rep.n_failed == 0
    assert rep.measured_chosen_s == min(c.measured_s for c in ok)
    assert rep.speedup_vs_default >= 1.0
    assert rep.calibration["time"]["flash_attention"] > 0
    assert rep.calibration["meta"]["flash_attention.device"] == "cpu"
    assert rep.machine_fingerprint == H100.fingerprint


def test_predict_only_touches_no_device():
    rep = tune("flash_attention", "H100", config=TINY, measure=False,
               device="cuda:7")
    assert rep.options["device"] is None and rep.measured_chosen_s is None
    preds = [c for c in rep.candidates if c.status == "predicted"]
    assert preds[0].params == rep.chosen_params
    assert not rep.calibration


def test_measuring_on_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        tune("flash_attention", "H100", config=TINY, top_k=1)


def test_time_closure_never_times_the_cpu_for_the_card():
    assert t_measure.time_closure(lambda: None, "cpu", reps=3).ok
    with pytest.raises(ValueError, match="cannot time"):
        t_measure.time_closure(lambda: None, "meta")


def test_failed_candidate_does_not_abort(monkeypatch):
    """A candidate that raises is recorded 'failed'; the run completes and
    chooses among the others."""
    pred = tune("flash_attention", "H100", config=TINY, measure=False)
    bad = pred.chosen_params                 # the predicted best
    tag = ",".join(f"{k}={v}" for k, v in sorted(bad.items()))
    monkeypatch.setenv("REPRO_TUNE_FAULT", "raise")
    monkeypatch.setenv("REPRO_TUNE_FAULT_MATCH", tag)
    rep = tune("flash_attention", "H100", config=TINY, top_k=3, reps=1,
               isolate=False, device="cpu")
    failed = [c for c in rep.candidates if c.status == "failed"]
    assert [c.params for c in failed] == [bad]
    assert "injected tune fault" in failed[0].measured.error
    assert rep.chosen_params != bad and rep.measured_chosen_s is not None


def test_isolated_child_exit_is_recorded_not_raised(monkeypatch):
    """A spawned measuring child that dies is a failed record."""
    monkeypatch.setenv("REPRO_TUNE_FAULT", "exit")
    tr = t_measure.measure_candidate(
        "flash_attention", TINY, {"block_q": 16, "block_kv": 32}, H100,
        device="cpu", reps=1, retries=0, timeout_s=120)
    assert not tr.ok and tr.wall_s == math.inf
    assert "exit code 3" in tr.error and tr.retries == 0


def test_reports_decode_across_packages():
    rep = tune("flash_attention", "H100", config=TINY, top_k=1, reps=1,
               isolate=False, device="cpu")
    payload = json.loads(json.dumps(rep.to_dict()))
    theirs = j_report.TuneReport.from_dict(payload)
    assert theirs.to_dict() == payload
    ours = t_report.TuneReport.from_dict(theirs.to_dict())
    assert ours.to_dict() == rep.to_dict()
    # and a JAX-side report decodes through the port's class
    jrep = j_report.TuneReport(
        family="flash_attention", machine="m", machine_fingerprint="f",
        config={"seq_q": 8}, options={"interpret": True},
        candidates=(j_report.CandidateOutcome(
            params={"block_q": 8}, status="ok", predicted_s=1e-3,
            bound="compute", measured=j_measure.TimedRun(
                ok=True, wall_s=2e-3, samples=(2e-3,))),),
        n_enumerated=1, n_feasible=1, default_params={"block_q": 8},
        chosen_params={"block_q": 8}, error={"n": 1})
    assert t_report.TuneReport.from_dict(jrep.to_dict()).to_dict() == \
        jrep.to_dict()


def test_api_tune_is_the_tuner():
    rep = t_api.tune("flash_attention", "H100", config=TINY, measure=False)
    assert rep.family == "flash_attention" and rep.n_feasible > 0


def test_cli_predict_only_json_exits_0():
    env_src = str(REPO / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "tune", "flash_attention",
         "-m", "H100", "--no-measure", "--json"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": env_src, "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["kind"] == "tune" and out["options"]["device"] is None
    assert out["n_feasible"] > 0


def test_cli_measures_on_the_cpu_when_named(capsys, tmp_path):
    from repro_torch import cli
    path = tmp_path / "h100.yaml"
    shutil.copy(H100_YAML, path)
    args = ["tune", "flash_attention", "-m", str(path), "--device", "cpu",
            "--no-isolate", "--reps", "1", "--top-k", "1",
            "--apply-calibration"]
    for k, v in TINY.items():
        args += ["--shape", k, str(v)]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "measured on: cpu" in out and f"written to {path}" in out
    assert t_api.resolve_machine(str(path)).calibration_factor(
        "time", "flash_attention") > 0
    assert cli.main(["tune", "matmul", "-m", "H100", "--no-measure"]) == 2


def test_advisor_pick_is_a_candidate():
    sp = t_space.resolve_space("flash_attention", H100, seq_q=4096,
                               seq_kv=4096, heads=32, head_dim=128)
    t = blocking.attention_cta_tiles(4096, 4096, 128, "bfloat16")
    assert sp._advisor().config == {"block_q": t.bq, "block_kv": t.bkv}


# ----------------------------------------------------------------------
# the stencil spaces
# ----------------------------------------------------------------------

STENCILS = ("stencil3d7pt", "longrange3d")
RADIUS = {"stencil3d7pt": 1, "longrange3d": 4}
# the JAX space's defaults, passed explicitly (the card widens n_max)
JAX_RANGE = {"m": 16, "n_min": 32, "n_max": 128, "n_step": 16}
TINY_STENCIL = {"m": 8, "n_min": 16, "n_max": 32, "n_step": 16}


def _jax_expectation(family, cfg, cores):
    """What the JAX space's predict computes, on the kernel traced at the
    4-byte elements the port models: grid_search's ECM cycles per unit
    (saturated at ``cores`` over the batched cores grid when cores > 1)
    converted to seconds per sample with the JAX space's point count and
    repeats.  Returns (JAX space, {n: seconds})."""
    from repro.core import api as j_api
    from repro.core import blocking as j_blocking
    jm = JMachine.from_yaml(H100_YAML)
    jsp = j_space.resolve_space(family, jm, **cfg, cores=cores)
    jk = j_api._load_kernel_cached(f"trace:{family}", None, None,
                                   {"M": cfg["m"]}, {"element_bytes": 4})
    vals = jsp._values()
    if cores > 1:
        gs = j_blocking.grid_search(jk, jm, [("N", vals)], model="ecm",
                                    cores=list(range(1, cores + 1)))
        score = {n: gs.best_result.flops_per_unit * jm.clock_hz
                 / float(gs.scores[i, -1]) for i, n in enumerate(vals)}
    else:
        gs = j_blocking.grid_search(jk, jm, [("N", vals)], model="ecm")
        score = {p["N"]: s for p, s in gs.ranking}
    unit = gs.best_result.unit_iterations
    return jsp, {n: score[n] / unit / jm.clock_hz * jsp._points(n)
                 * jsp.repeats(n) for n in vals}


@pytest.mark.parametrize("cores", [1, 132])
@pytest.mark.parametrize("cfg", [JAX_RANGE, {**JAX_RANGE, "n_max": 256}],
                         ids=["jax-range", "card-range"])
@pytest.mark.parametrize("family", STENCILS)
def test_stencil_space_equals_jax_at_four_bytes(family, cfg, cores):
    """Candidates, default and repeats are the JAX space's; predictions
    are its conversion of JAX's own grid_search on the 4-byte kernel."""
    sp = t_space.resolve_space(family, H100, **cfg, cores=cores)
    jsp, want = _jax_expectation(family, cfg, cores)
    cands = sp.candidates()
    assert cands == [t_space.Candidate(c.family, c.params)
                     for c in jsp.candidates()]
    assert sp.default().params == jsp.default().params
    preds = sp.predict(cands)
    for c, p in zip(cands, preds):
        n = c.config["n"]
        assert sp.repeats(n) == jsp.repeats(n)
        assert p.feasible and p.seconds == want[n], n
        assert p.bound == ("L2" if cores > 1 else "L1")


def test_stencil_families_resolve():
    """Both stencil families resolve; on the card the cores default to
    the 132 SMs and n runs to GPU_N_MAX, on a one-core TPU file the JAX
    space's defaults hold."""
    v5e = t_machine.load(
        str(REPO / "src/repro/configs/machines/tpu_v5e.yaml"))
    for fam in STENCILS:
        sp = t_space.resolve_space(fam, "H100")
        assert type(sp).__name__ in ("Stencil7ptSpace", "LongRange3DSpace")
        assert sp.config == {"m": 16, "n_min": 32, "n_step": 16,
                             "cores": 132, "n_max": t_space.GPU_N_MAX}
        assert sp.sources == (fam,)
        assert t_space.resolve_space(fam, v5e).config == \
            {**JAX_RANGE, "cores": 1}
        assert t_space.resolve_space(fam, "H100", n_max=128).config[
            "n_max"] == 128
        with pytest.raises(ValueError, match="unknown .* config"):
            t_space.resolve_space(fam, H100, seq_q=1)
        with pytest.raises(ValueError, match="no block edge"):
            t_space.resolve_space(fam, H100, n_min=300)


def test_card_range_straddles_the_regime_change():
    """At 132 SMs the predicted seconds per point change regime inside
    the card's range for both stencils (the 7-point one only past JAX's
    n_max of 128)."""
    for fam, inside_jax in (("stencil3d7pt", False), ("longrange3d", True)):
        sp = t_space.resolve_space(fam, H100)
        cands = sp.candidates()
        per_point = [p.seconds / (sp._points(c.config["n"])
                                  * sp.repeats(c.config["n"]))
                     for c, p in zip(cands, sp.predict(cands))]
        first_change = next(c.config["n"] for c, a, b in
                            zip(cands[1:], per_point, per_point[1:])
                            if not math.isclose(a, b))
        assert (first_change <= 128) == inside_jax, (fam, first_change)


@pytest.mark.parametrize("family", STENCILS)
def test_stencil_feasibility_is_the_launch_plan(family):
    """A candidate is feasible exactly when the ops wrapper would launch
    its cutout; one whose grid the kernel refuses names the limit."""
    sp = t_space.resolve_space(family, H100, n_min=32, n_max=46400,
                               n_step=46368)
    cands = sp.candidates()
    assert [c.config["n"] for c in cands] == [32, 46400]
    ok, big = sp.predict(cands)
    assert ok.feasible and sp.plan(32).launch == \
        blocking.stencil_cta_tile(RADIUS[family], (16, 32, 32),
                                  sp.MODULE.OWN).launch
    assert not big.feasible and big.seconds == math.inf
    assert "N*N < 2**31" in big.reason
    for c in t_space.resolve_space(family, H100).candidates():
        n = c.config["n"]
        plan = sp.plan(n)
        assert blocking.check_launch(plan, RADIUS[family],
                                     sp.MODULE.OWN) == plan.launch


@pytest.mark.parametrize("family", STENCILS)
def test_cli_stencil_predict_only_json_exits_0(family):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "tune", family,
         "-m", "H100", "--no-measure", "--json"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["family"] == family and out["options"]["device"] is None
    assert out["n_feasible"] == 15 and out["config"]["cores"] == 132


def test_stencil_tune_measures_in_child_processes_on_the_cpu():
    """The whole loop for a stencil family at a tiny cutout: every
    shortlisted candidate runs in its own child process on the plain
    version (named cpu), and calibration lands on the binding level and
    the family's time without dropping another family's keys."""
    prev = {"compute": 2.0, "levels": {"L1": 1.5},
            "time": {"flash_attention": 3.0}}
    mach = dataclasses.replace(H100, calibration=prev)
    rep = tune("longrange3d", mach, config=TINY_STENCIL, top_k=2, reps=1,
               device="cpu", isolate=True, timeout_s=120)
    ok = [c for c in rep.candidates if c.status == "ok"]
    assert len(ok) == 2 and rep.n_failed == 0
    assert all(c.bound == "L2" for c in ok)
    assert rep.options["device"] == "cpu" and rep.options["isolate"]
    cal = rep.calibration
    assert cal["compute"] == 2.0 and cal["time"]["flash_attention"] == 3.0
    assert cal["levels"]["L1"] == 1.5 and cal["levels"]["L2"] > 0
    assert cal["time"]["longrange3d"] > 0


def test_stencil_tune_takes_a_session():
    """A warm session serves a second ranking from its compiled plans."""
    sess = t_api.get_session(H100)
    before = sess.stats.plan_compiles
    first = tune("stencil3d7pt", H100, measure=False, session=sess)
    compiled_once = sess.stats.plan_compiles
    again = tune("stencil3d7pt", H100, measure=False, session=sess)
    assert compiled_once == before + 1
    assert sess.stats.plan_compiles == compiled_once
    assert first.to_dict() == again.to_dict()


def test_children_see_the_fault_hook_as_the_parent_sets_it(monkeypatch):
    """Children come from a fork server started once; the fault hook's
    variables reach each child as the parent has them when it starts
    that child, not as they stood when the server started."""
    cand = {"block_q": 16, "block_kv": 32}
    monkeypatch.delenv("REPRO_TUNE_FAULT", raising=False)
    ok = t_measure.measure_candidate("flash_attention", TINY, cand, H100,
                                     device="cpu", reps=1, retries=0)
    assert ok.ok
    monkeypatch.setenv("REPRO_TUNE_FAULT", "raise")
    bad = t_measure.measure_candidate("flash_attention", TINY, cand, H100,
                                      device="cpu", reps=1, retries=0)
    assert not bad.ok and "injected tune fault" in bad.error
    monkeypatch.delenv("REPRO_TUNE_FAULT")
    assert t_measure.measure_candidate("flash_attention", TINY, cand, H100,
                                       device="cpu", reps=1,
                                       retries=0).ok
