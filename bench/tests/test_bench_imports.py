"""Nothing a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the port, ``repro_torch``, starts with the JAX
package's name, so the part before the first dot is compared whole),
and the references import nothing of the program."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

from bench import harness

SCRIPT = """
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
from bench import harness
from bench.tests import _tiny
cell = _tiny.cell({cell!r}, loss_gap=1.0, grad_gap=1.0, change_gap=1.0)
out, _ = harness.run_cell(cell, 2 ** 31 + 3, 0.2, False, "cpu",
                          time.perf_counter())
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(out["correct"], " ".join(tops))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cell in ("granite-8b-9L.train_4k", "mamba2-2.7b-32L.train_4k"):
        code = SCRIPT.format(root=str(harness.ROOT),
                             src=str(harness.ROOT / "src"), cell=cell)
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=300,
                              env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        ok, tops = proc.stdout.split("\n")[-2].split(" ", 1)
        tops = set(tops.split())
        assert ok == "True"
        assert "repro_torch" in tops
        assert not tops & set(harness.FORBIDDEN), tops & set(
            harness.FORBIDDEN)


def test_forbidden_names_compare_whole_top_level_names():
    sys.modules.setdefault("repro_torch_lookalike", sys)
    try:
        assert "repro_torch_lookalike" not in harness.forbidden_modules()
    finally:
        if sys.modules.get("repro_torch_lookalike") is sys:
            del sys.modules["repro_torch_lookalike"]


def test_references_import_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro",
                                               "jax", "bench"), (path, n)
