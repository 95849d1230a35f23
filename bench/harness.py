"""One run of one cell: set-up, the measured window, the trace, and the
check against the plain reference.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) is found by
name: ``bench/workloads/<cell>.json`` holds its traffic and its limits,
``bench/configs/<config>.json`` its model, ``bench/reference/<family>.py``
the plain reference of the model's family, ``bench/metrics/<metric>.py``
each per-layer metric's reader.

The program under test is the port's training step,
``repro_torch.train.step.make_train_step`` (the ``step_fn`` that
``Trainer`` builds): the parameters are drawn here from the seed
(``weights``), the optimizer state is ``repro_torch.optim.adamw_init``'s,
the batches come from ``traffic``.  Set-up drives the step through its
first ``checked_steps`` steps, which the reference follows; the same
step, parameters and state then run the window.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time

import torch

from . import check, traffic, weights
from . import trace as trace_mod
from .reference import common as ref_common

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # bench/configs/<config>.json
    workload: dict        # bench/workloads/<cell>.json
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def family(self):
        return importlib.import_module(
            f"bench.reference.{self.model['family']}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None,
              root: pathlib.Path = ROOT) -> Cell:
    if manifest is None:
        manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"]
                if c["name"] == entry["config"])
    return Cell(name, entry["chips"],
                json.loads((root / conf["file"]).read_text()),
                json.loads((root / "bench" / "workloads"
                            / f"{name}.json").read_text()),
                [m for m in manifest["end_to_end"] if _applies(m, name)],
                [m for m in manifest["per_layer"] if _applies(m, name)])


def reader(metric: str, root: pathlib.Path = ROOT):
    """The module of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics._" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks(kind: str) -> dict | None:
    table = json.loads((BENCH / "peaks.json").read_text())
    return table.get(kind)


# ----------------------------------------------------------------------
# the program
# ----------------------------------------------------------------------
def arch_config(model: dict):
    """The program's ``ArchConfig`` of a configuration's ``model``."""
    from repro_torch.configs import ArchConfig
    from repro_torch.models.mamba2 import SSMConfig
    kw = dict(model)
    if "ssm" in kw:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ArchConfig(name="bench", **kw)


def train_config(workload: dict):
    from repro_torch.optim import OptConfig
    from repro_torch.train.step import TrainConfig
    t = workload["train"]
    opt = OptConfig(lr=t["lr"], b1=t["b1"], b2=t["b2"], eps=t["eps"],
                    weight_decay=t["weight_decay"], clip_norm=t["clip_norm"])
    return TrainConfig(opt=opt, microbatches=workload["microbatches"],
                       remat=workload["remat"], z_loss=t["z_loss"],
                       warmup_steps=t["warmup_steps"],
                       total_steps=t["total_steps"])


class Program:
    """The training step under test with its parameters, optimizer state
    and batch pool, built from the seed."""

    def __init__(self, cell: Cell, seed: int, device):
        from repro_torch.models.lm import LM
        from repro_torch.optim import adamw_init
        from repro_torch.train import step as step_mod
        self.cell, self.seed, self.device = cell, seed, device
        self.layout = cell.family.layout(cell.model)
        model = LM(arch_config(cell.model))
        self.params = weights.draw(self.layout, seed, device)
        want = weights.shapes(model.param_recs())
        if weights.shapes(self.params) != want:
            raise ValueError(f"{cell.name}: the program's parameters are "
                             f"{want}, the benchmark's layout draws "
                             f"{weights.shapes(self.params)}")
        self.tcfg = train_config(cell.workload)
        self.step_fn = step_mod.make_train_step(model, self.tcfg)
        self.opt = adamw_init(self.params, self.tcfg.opt)
        self.pool = traffic.pool(cell.workload, cell.model["vocab"], seed,
                                 device)
        self.done = 0

    def step(self) -> dict:
        """One step on the next batch; its metrics read to the host, as
        ``Trainer.run`` reads them."""
        i = self.done
        self.params, self.opt, m = self.step_fn(
            self.params, self.opt, traffic.batch(self.pool, i), i)
        self.done += 1
        return {k: float(v) for k, v in m.items()}

    def checked_steps(self, n: int) -> dict:
        """The first ``n`` steps, with what the check compares: each
        loss, the step-0 gradient from the first moment, and each
        slice's change from the drawn parameters in the float32 master
        weights after the last."""
        b1 = self.tcfg.opt.b1
        losses, grad = [], None
        for i in range(n):
            losses.append(self.step()["loss"])
            if i == 0:
                grad = {k: v / (1.0 - b1) for k, v in
                        ref_common.slice_norms(self.opt["m"]).items()}
        kept = self.opt.get("master", self.params)
        start = weights.draw(self.layout, self.seed, self.device)
        with torch.no_grad():
            change = {
                name: float(torch.linalg.vector_norm(
                    a.float() - b.float()))
                for (name, a), (_, b) in zip(ref_common.layer_slices(kept),
                                             ref_common.layer_slices(start))}
        del start
        return {"loss": losses, "grad": grad, "change": change}

    def n_params(self) -> int:
        return sum(t.numel() for _, t in ref_common.leaves(self.params))

    def grad_bytes(self) -> int:
        """Bytes of a gradient element as the optimizer reads it: float32
        where microbatches are summed, else the parameters' type."""
        return 4 if self.tcfg.microbatches > 1 else \
            ref_common.leaves(self.params)[0][1].element_size()


def reference_record(cell: Cell, seed: int, pool: dict, device,
                     precision: str = "fp32") -> dict:
    """The plain reference's first ``checked_steps`` steps from the same
    drawn parameters and batches."""
    params0 = weights.draw(cell.family.layout(cell.model), seed, device)
    loss = functools.partial(cell.family.loss, cfg=cell.model,
                             train=cell.workload["train"])
    n = cell.workload["checked_steps"]
    out = ref_common.follow(loss, params0,
                            [traffic.batch(pool, i) for i in range(n)],
                            cell.workload["train"],
                            cell.workload["microbatches"], n,
                            ref_common.Ops(precision))
    del params0
    return out


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# one run
# ----------------------------------------------------------------------
def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_info(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": dev.type, "kind": dev.type, "count": 1,
            "memory_peak_bytes": int(peak)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> tuple[dict, dict]:
    """Set-up, window, trace, check.  Returns the result line's object
    (its ``checks`` last) and the readings the check compared."""
    cuda = torch.device(device).type == "cuda"
    prog = Program(cell, seed, device)
    record = prog.checked_steps(cell.workload["checked_steps"])
    pool = prog.pool
    free(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tokens = cell.workload["global_batch"] * cell.workload["seq"]
    failed, steps = 0, 0
    _sync(device)
    setup_s = time.perf_counter() - t_start

    def run_steps(n: int | None) -> None:
        """``n`` steps, or steps until ``seconds`` have passed."""
        nonlocal failed, steps
        t0, done = time.perf_counter(), 0
        while (done < n) if n is not None else \
                (time.perf_counter() - t0 < seconds):
            done += 1
            steps += 1
            try:
                loss = prog.step()["loss"]
            except RuntimeError as e:
                log(f"step {prog.done} raised: {e}")
                failed += 1
                break
            if not math.isfinite(loss):
                failed += 1
    t0 = time.perf_counter()
    if trace:
        wanted = {}
        for m in cell.per_layer:
            wanted.update(getattr(reader(m["name"]), "RANGES", {}))
        tr = trace_mod.record(run_steps, cell.workload["trace_steps"],
                              wanted)
    else:
        run_steps(None)
        _sync(device)
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_params, grad_bytes = prog.n_params(), prog.grad_bytes()
    t1 = time.perf_counter()
    log(f"set-up {setup_s:.1f} s, window {t1 - t0:.1f} s, {steps} steps")
    del prog
    free(device)
    ref = reference_record(cell, seed, pool, device)
    log(f"reference {time.perf_counter() - t1:.1f} s")
    values = check.readings(record, ref)
    checks = check.verdict(values, cell.workload["limits"])
    correct = check.passed(checks) and failed == 0 and steps > 0
    dev = device_info(device, peak)
    out = {"correct": correct, "attempted": steps, "failed": failed,
           "metrics": {}, "device": dev}
    if trace:
        ctx = Context(tr, cell, peaks(dev["kind"]), n_params, grad_bytes)
        for m in cell.per_layer:
            v = reader(m["name"]).read(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.ops,
                            "idle_gaps": trace_mod.idle_gaps(tr)}
    else:
        e2e = {"setup_s": setup_s,
               "train_tokens_s": steps * tokens / window_s,
               "train_peak_gib": peak / 2 ** 30}
        for m in cell.end_to_end:
            if m["name"] in e2e:
                out["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                             "unit": m["unit"]}
    out["checks"] = checks
    return out, {"program": record, "reference": ref, "values": values}


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""
    trace: trace_mod.Trace
    cell: Cell
    peaks: dict | None
    n_params: int
    grad_bytes: int

    @property
    def model(self) -> dict:
        return self.cell.model

    @property
    def workload(self) -> dict:
        return self.cell.workload
