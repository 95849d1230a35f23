"""The port's examples (``examples/torch_*.py``), each run once as a child
process on the CPU (``--device cpu``, under a timeout of ``TIMEOUT`` s),
shared by the tests below through a module fixture: each exits 0, the
analysis lines they print equal what the JAX package computes in-process
for the same inputs (the reference's examples are not run), the pipeline
matches the sequential model, and no port example imports ``jax`` or the
JAX package."""
from __future__ import annotations

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
NAMES = ("torch_quickstart", "torch_stencil_modeling", "torch_serve_batched",
         "torch_train_100m", "torch_multipod_pipeline")
TIMEOUT = 90
#: the pipeline against the sequential model (float32; reads 0.0)
PIPELINE_TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """Each example's exit code and output, run one after another."""
    tmp = tmp_path_factory.mktemp("examples")
    extra = {"torch_train_100m": ["--steps", "3", "--ckpt-dir",
                                  str(tmp / "train" / "ckpt")],
             "torch_multipod_pipeline": ["--ranks", "8"]}
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src")] + [p for p in [os.environ.get(
                   "PYTHONPATH")] if p])}
    out = {}
    for name in NAMES:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"{name}.py"),
             "--device", "cpu", *extra.get(name, [])],
            cwd=tmp, env=env, capture_output=True, text=True,
            timeout=TIMEOUT)
        out[name] = (proc.returncode, proc.stdout, proc.stderr)
    return out


def _line(text: str, prefix: str) -> str:
    lines = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    assert len(lines) == 1, (prefix, text[-2000:])
    return lines[0][len(prefix):]


def test_the_five_examples_exist():
    assert [p.stem for p in EXAMPLES] == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(runs, name):
    rc, out, err = runs[name]
    assert rc == 0, (out[-2000:], err[-3000:])
    route = _line(out, "route: ") if name != "torch_multipod_pipeline" \
        else None
    assert route is None or "cpu, no launch" in route


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert "repro_torch" in roots


def test_quickstart_matches_the_jax_package(runs):
    pytest.importorskip("jax")
    from repro.core import blocking, ecm, load_machine, parse_kernel
    src = ROOT / "src" / "repro" / "configs" / "stencils" / "stencil_3d7pt.c"
    kernel = parse_kernel(src.read_text(), constants={"M": 300, "N": 1000})
    machine = load_machine("IVY")
    out = runs["torch_quickstart"][1]
    assert _line(out, "ECM notation (IVY): ") == \
        ecm.model(kernel, machine, predictor="LC").notation()
    bs = blocking.lc_block_size(kernel, machine.level("L3").size_bytes, "N")
    assert _line(out, "L3 blocking factor for N: ") == \
        f"block at ~{bs} columns"
    assert _line(out, "ECM notation (H100, one SM): ").startswith("{ ")


def test_stencil_modeling_matches_the_jax_package(runs):
    pytest.importorskip("jax")
    from repro.core import analyze
    from repro.kernels.longrange3d import point
    sizes = {"M": 130, "N": 1015}
    c_file = ROOT / "src" / "repro" / "configs" / "stencils" / \
        "stencil_3d_long_range.c"
    out = runs["torch_stencil_modeling"][1]
    traced = analyze(point, "IVY", model="ecm", predictor="LC",
                     constants=sizes)
    assert _line(out, "trace == c frontend, bit-identical: ") == \
        traced.notation()
    for pred in ("LC", "SIM"):
        res = analyze(str(c_file), "IVY", model="ecm", predictor=pred,
                      name="3d-long-range", constants=sizes)
        assert _line(out, f"[{pred}] ") == (
            f"{res.notation()}  -> saturating at {res.saturation_cores} "
            "cores")
    assert "bound: memory" in out and "program graph:longrange3d-ref" in out


def test_multipod_pipeline_matches_the_sequential_model(runs):
    out = runs["torch_multipod_pipeline"][1]
    assert out.splitlines()[0].startswith("simulating 8 pods: 8 processes")
    fwd = _line(out, "GPipe over 8 pods == sequential forward ")
    assert float(re.search(r"max abs err (\S+)", fwd).group(1)) <= \
        PIPELINE_TOL
    bwd = _line(out, "backward pipeline OK: ")
    assert float(re.search(r"max abs err against the sequential gradient "
                           r"(\S+)", bwd).group(1)) <= PIPELINE_TOL


def test_served_and_trained_on_the_cpu(runs):
    served = runs["torch_serve_batched"][1]
    assert "served 8 requests / 96 tokens" in served
    assert "steady state: 96 tokens" in served
    trained = runs["torch_train_100m"][1]
    assert "over 3 steps on cpu" in trained


@pytest.mark.parametrize("name", ["torch_serve_batched", "torch_train_100m"])
def test_flash_call_held_against_plain_attention(runs, name):
    """Serving and training hold the model's flash call against the plain
    attention at bfloat16's reference tolerance, 2e-2."""
    line = _line(runs[name][1], "flash kernel == plain attention at ")
    assert float(re.search(r"max abs err (\S+);", line).group(1)) <= 2e-2


def test_examples_refuse_a_missing_card():
    """Without ``--device cpu`` an example asks for the card, and raises
    here rather than fall back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py")],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
