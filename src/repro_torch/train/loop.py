"""Trainer: the fault-tolerant outer loop.

Counterpart of ``repro.train.loop``:

* deterministic data replay (step-indexed synthetic pipeline),
* periodic **async** checkpoints + resume from the latest step,
* **watchdog** straggler detection (step time > k x running median flags
  the step),
* failure injection hook for tests (``failure_hook(step)`` may raise) —
  the loop restores from the last checkpoint and replays.

The loop runs on the card unless it is given the CPU
(:func:`repro_torch.device.resolve`).  A step's time is taken once its
loss has reached the host (``float(metrics["loss"])``, the counterpart
of ``jax.block_until_ready``).  As in JAX a ``RuntimeError`` from a step
is a node failure to replay, except the card's own faults, which PyTorch
also raises as ``RuntimeError``: out of device memory, a kernel that does
not build or launch (:class:`repro_torch.kernels._build.KernelError`) and
a sticky CUDA error (an illegal address, a cuBLAS status) are raised,
never replayed (:func:`is_card_fault`).

Sharded training: ``Trainer(rule=..., mesh=...)``.  Under JAX's ``jit``
the inputs carry their mesh; here ``mesh`` is where the leaves go (the
counterpart of JAX's ``device_put``): :meth:`Trainer.init_state` places
the parameters by ``shard(mesh, spec_tree(recs, rule))`` and the
optimizer state by ``opt_specs``, each batch goes by ``batch_specs``,
and a restore lands on the same shardings.  Every rank runs the loop
(SPMD) and draws the same full parameters and batches from the same
seeds, keeping its own shard of each (``Sharding.distribute``): the
values do not depend on the mesh, and no rank waits on a scatter.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import time
from typing import Callable

import torch

from .. import ckpt
from .. import device as _device
from ..kernels._build import KernelError
from ..models.common import materialize, spec_tree, tmap
from ..optim import adamw_init
from .step import TrainConfig, make_train_step

#: RuntimeErrors that are the card's faults: re-raised, not replayed
CARD_FAULTS = (torch.OutOfMemoryError, KernelError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())
#: how a torch without ``AcceleratorError`` words a sticky CUDA error (an
#: illegal address, a cuBLAS or cuDNN status): a plain RuntimeError
CARD_FAULT_PREFIXES = ("CUDA error", "CUDA driver error", "CUBLAS_STATUS",
                       "cuDNN error")


def is_card_fault(e: BaseException) -> bool:
    """Whether ``e`` is the card's own fault rather than a node failure."""
    return isinstance(e, CARD_FAULTS) or str(e).startswith(
        CARD_FAULT_PREFIXES)


class Watchdog:
    """Flags steps slower than ``factor`` x the running median."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor, self.window = factor, window
        self.times: list[float] = []
        self.straggler_steps: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = (len(self.times) >= 5
                and dt > self.factor * statistics.median(self.times))
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if slow:
            self.straggler_steps.append(step)
        return slow


class Trainer:
    def __init__(self, model, data, tcfg: TrainConfig, rule=None,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 failure_hook: Callable[[int], None] | None = None,
                 max_restarts: int = 3, log_path: str | None = None,
                 device=None, mesh=None):
        if mesh is not None and rule is None:
            raise ValueError("a mesh places the leaves by a rule: pass "
                             "rule= too")
        self.model, self.data, self.tcfg, self.rule = model, data, tcfg, rule
        self.mesh = mesh
        self.device = _device.resolve(device)
        self.ckpt_dir = pathlib.Path(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.failure_hook = failure_hook
        self.max_restarts = max_restarts
        self.watchdog = Watchdog()
        self.saver = ckpt.AsyncSaver(self.ckpt_dir) if self.ckpt_dir else None
        self.log_path = pathlib.Path(log_path) if log_path else None
        self.step_fn = make_train_step(model, tcfg, rule=rule)
        self.metrics_log: list[dict] = []

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator | None = None):
        """Parameters drawn from ``generator`` (seed 0 on the trainer's
        device when None) and a fresh optimizer state."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        sh = self._shardings()
        params = materialize(self.model.param_recs(), generator,
                             device=self.device,
                             shardings=sh and sh["params"])
        opt = adamw_init(params, self.tcfg.opt)
        if sh:
            opt = tmap(lambda t, s: s.distribute(t), opt, sh["opt"])
        return params, opt, 0

    def _shardings(self) -> dict | None:
        """The leaves' shardings on the mesh (None without one)."""
        if self.mesh is None:
            return None
        from ..launch.cell import opt_specs, shard
        recs = self.model.param_recs()
        return {"params": shard(self.mesh, spec_tree(recs, self.rule)),
                "opt": shard(self.mesh, opt_specs(recs, self.rule,
                                                  self.tcfg.opt))}

    def restore_state(self):
        """The latest checkpoint's (params, opt, step), or None where
        there is none (or no checkpoint directory: JAX's loop raises a
        ``TypeError`` there, ROADMAP.md Queue 3)."""
        if self.ckpt_dir is None:
            return None
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return None
        params, opt, _ = self.init_state()
        tree, manifest = ckpt.restore(
            self.ckpt_dir, step, {"params": params, "opt": opt},
            shardings=self._shardings())
        return tree["params"], tree["opt"], manifest["step"]

    def _batch(self, step: int) -> dict:
        batch = {k: torch.from_numpy(v).to(self.device, torch.long)
                 for k, v in self.data.batch(step).items()}
        if self.mesh is None:
            return batch
        from .. import configs
        from ..launch.cell import batch_specs, shard
        shape = configs.ShapeSpec("trainer", "train", self.data.seq,
                                  self.data.global_batch)
        specs = shard(self.mesh, batch_specs(self.model.cfg, shape,
                                             self.rule))
        return {k: specs[k].distribute(v) for k, v in batch.items()}

    # ------------------------------------------------------------------
    def run(self, n_steps: int, generator: torch.Generator | None = None,
            resume: bool = True):
        state = self.restore_state() if (resume and self.ckpt_dir) else None
        if state is None:
            state = self.init_state(generator)
        params, opt, start = state

        restarts = 0
        step = start
        while step < n_steps:
            try:
                batch = self._batch(step)
                t0 = time.perf_counter()
                if self.failure_hook is not None:
                    self.failure_hook(step)
                params, opt, metrics = self.step_fn(params, opt, batch, step)
                rec = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                slow = self.watchdog.observe(step, dt)
                rec.update(step=step, dt=dt, straggler=slow)
                self.metrics_log.append(rec)
                if self.log_path:
                    with open(self.log_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                step += 1
                if self.saver and (step % self.ckpt_every == 0
                                   or step == n_steps):
                    self.saver.submit(step, {"params": params, "opt": opt},
                                      extra={"step": step})
            except RuntimeError as e:   # injected node failure
                if is_card_fault(e):
                    raise
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                if self.saver:
                    self.saver.wait()
                state = self.restore_state()
                if state is None:
                    params, opt, step = *self.init_state()[:2], 0
                else:
                    params, opt, step = state
                self.metrics_log.append(
                    {"step": step, "event": "restart", "error": str(e)})
        if self.saver:
            self.saver.wait()
        return params, opt, step
