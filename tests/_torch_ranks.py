"""Run a function on N gloo ranks on the CPU, one process each.

``run_ranks(n, "module:function", *args)`` starts ``n`` Python processes
(``PYTHONPATH`` gets ``src`` and ``tests``), each joins a gloo process
group at ``tcp://localhost:<free port>`` with its rank, calls
``function(*args)``, and pickles its return value; the caller gets the
list of values, by rank.  Every group runs under one timeout: a rank
that hangs or fails kills the others and fails the caller with the
ranks' stderr, and each rank destroys its process group in a ``finally``.
Each rank runs torch on one thread, so a group of 8 fits beside the
suite's other workers.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(n: int, target: str, *args, timeout: float = 240.0) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump((target, args), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [SRC, HERE] + [p for p in [env.get("PYTHONPATH")] if p])
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                   WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
        procs, logs = [], []
        for r in range(n):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import _torch_ranks; _torch_ranks._child()", job],
                env={**env, "RANK": str(r)}, stdout=log,
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                failed = [p for p in procs if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            text = []
            for r, log in enumerate(logs):
                log.seek(0)
                text.append(f"--- rank {r} (exit {procs[r].returncode}) "
                            f"---\n{log.read()[-3000:]}")
                log.close()
        if any(p.returncode != 0 for p in procs):
            late = time.monotonic() > deadline
            raise AssertionError(
                f"{target} on {n} ranks "
                f"{'timed out after %.0f s' % timeout if late else 'failed'}"
                ":\n" + "\n".join(text))
        out = []
        for r in range(n):
            with open(f"{job}.{r}", "rb") as f:
                out.append(pickle.load(f))
        return out


def _child() -> None:
    import datetime
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    job = sys.argv[1]
    with open(job, "rb") as f:
        target, args = pickle.load(f)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    try:
        mod, fn = target.split(":")
        result = getattr(importlib.import_module(mod), fn)(*args)
        with open(f"{job}.{rank}", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()
