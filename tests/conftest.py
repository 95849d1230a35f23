"""Shared test helpers. NB: XLA_FLAGS / device-count forcing must NOT be set
here (smoke tests and benches run on the 1 real CPU device; only
launch/dryrun.py and subprocess-based dist tests force placeholder
devices)."""
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run_with_devices(code: str, n_devices: int = 8, timeout: int = 300):
    """Run a python snippet in a subprocess with N forced host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{proc.stdout}\n"
            f"STDERR:\n{proc.stderr[-4000:]}")
    return proc.stdout


@pytest.fixture(scope="session")
def devices8():
    return lambda code, timeout=300: run_with_devices(code, 8, timeout)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason elsewhere")
