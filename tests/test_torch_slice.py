"""The whole first port slice on the CPU, against the JAX package, and the
import guard that keeps ``repro_torch`` free of JAX and of ``repro``.

End to end: trace the point function, model it on the H100 machine file,
run it through the ``ops`` wrapper on seeded inputs, and hold both the
prediction and the output against the JAX package given the same inputs.
"""
import ast
import importlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import analyze as j_analyze  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.tune import stencil  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
H100 = str(PORT / "machines" / "h100_sxm.yaml")


@pytest.mark.parametrize("name, shape", [("stencil3d7pt", (7, 21, 21)),
                                         ("longrange3d", (12, 19, 19))])
def test_slice_end_to_end_on_cpu(name, shape):
    fam = stencil.family(name)
    # trace + model: the prediction equals the JAX package's on the same
    # machine file, and converts to a finite positive time
    pred = stencil.predict_seconds(name, shape, "H100")
    assert pred.cores == 132
    consts = {"M": shape[0], "N": shape[1]}
    jpoint = importlib.import_module(f"repro.kernels.{name}").point
    for ours, model in ((pred.ecm, "ecm"), (pred.roofline, "roofline")):
        theirs = j_analyze(jpoint, H100, model=model, cores=132,
                           constants=consts,
                           frontend_opts={"element_bytes": 4})
        assert ours.to_dict() == theirs.to_dict()
    assert 0 < pred.ecm_s < 1 and 0 < pred.roofline_s < 1
    r = fam.module.RADIUS
    flops_per_point = {"stencil3d7pt": 13, "longrange3d": 41}[name]
    assert pred.flops_total == flops_per_point * (shape[0] - 2 * r) * \
        (shape[1] - 2 * r) ** 2
    # run: the ops wrapper on the CPU against the JAX oracle, same inputs
    args = stencil.make_inputs(name, shape, "cpu", seed=1)
    out = convert.to_numpy(stencil.run(name, shape, "cpu", seed=1))
    grids = [jnp.asarray(convert.to_numpy(t)) for t in args[:-1]]
    if name == "stencil3d7pt":
        want = j_ref.stencil3d7pt(grids[0], convert.star7_dict(args[-1]))
        tol = dict(rtol=2e-5, atol=1e-6)
    else:
        want = j_ref.longrange3d(*grids, jnp.asarray(args[-1], jnp.float32))
        tol = dict(rtol=2e-4, atol=1e-5)
    assert out.shape == shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(want), **tol)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports(path):
    """AST scan: no module of the port, and not chip_smoke.py, imports
    jax or anything under ``repro.``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert bad == []


#: the modules of the blocking-analysis slice, which the scans above and
#: below must reach
BLOCKING_SLICE = ["core/compiled.py", "core/model_api.py", "core/session.py",
                  "core/c_parser.py", "core/frontends/__init__.py",
                  "core/frontends/c.py", "core/frontends/builder.py",
                  "core/blocking.py", "core/api.py", "tune/space.py"]


#: and the modules of the LM slice
LM_SLICE = ["configs/__init__.py", "configs/granite_8b.py",
            "models/common.py", "models/attention.py", "models/mlp.py",
            "models/moe.py", "models/mamba2.py", "models/lm.py",
            "serve/__init__.py", "serve/engine.py", "launch/serve.py",
            "convert.py"]


#: and the modules of the training slice
TRAIN_SLICE = ["optim/__init__.py", "optim/adamw.py", "optim/schedule.py",
               "data/__init__.py", "data/pipeline.py", "ckpt/__init__.py",
               "ckpt/store.py", "train/__init__.py", "train/step.py",
               "train/loop.py", "launch/train.py"]


#: and the modules of the analysis tier (lint, reports, the result store,
#: its worker pool, the tuner's store branch and the command line)
ANALYSIS_SLICE = ["core/reports.py", "core/lint/__init__.py",
                  "core/lint/diagnostics.py", "core/lint/engine.py",
                  "core/lint/rules_kernel.py", "core/lint/rules_machine.py",
                  "core/lint/rules_cross.py", "service/__init__.py",
                  "service/store.py", "service/workers.py",
                  "service/service.py", "tune/tuner.py", "cli.py"]


#: and the modules of graph-level analysis (the HLO parser, the hlo
#: frontend, the wire models and the fleet analyzer)
GRAPH_SLICE = ["dist.py", "core/hlo_analysis.py", "core/frontends/hlo.py",
               "fleet/__init__.py", "fleet/pricing.py", "fleet/report.py",
               "fleet/analyzer.py"]


#: and the modules of distribution (the sharding layer is in
#: models/common.py, already listed)
DIST_SLICE = ["dist.py", "launch/mesh.py", "launch/cell.py"]


def test_scans_cover_the_blocking_slice():
    scanned = {str(p.relative_to(PORT)) for p in _port_files()
               if PORT in p.parents}
    assert set(BLOCKING_SLICE) <= scanned
    assert set(LM_SLICE) <= scanned
    assert set(TRAIN_SLICE) <= scanned
    assert set(ANALYSIS_SLICE) <= scanned
    assert set(GRAPH_SLICE) <= scanned
    assert set(DIST_SLICE) <= scanned
    assert list(PORT.rglob("*.c")) and all(
        p.parent.name == "stencils" for p in PORT.rglob("*.c"))

def test_importing_every_port_module_loads_no_jax():
    """A fresh interpreter imports every repro_torch module (and
    chip_smoke) and ends with no jax and no repro.* in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "n = sum(m.startswith('repro_torch') for m in sys.modules)\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_loaded = int(proc.stdout.split()[0])
    assert n_loaded >= 20
