"""Faults planted in the program under test, to show that the check
catches them: each is a context manager that patches the port while a
run is built and driven.

- ``unchanged_state``: the optimizer step returns the parameters and its
  state as they were.
- ``half_batch``: the loss is the mean over half of the batch's rows
  (over half of the positions where the batch is one row); the rest is
  left out.
- ``layer_grad_dropped``: one layer's gradient of one weight is lost
  before the optimizer reads it (zeros where the backward produced it).

The cell runs on one chip, so no exchange between chips can be left
out.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, attr: str, value):
    real = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield real
    finally:
        setattr(module, attr, real)


@contextlib.contextmanager
def unchanged_state():
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import step

    def frozen(grads, params, state, cfg, lr):
        return params, state, {"grad_norm": global_norm(grads)}
    with _patched(step, "adamw_update", frozen):
        yield


@contextlib.contextmanager
def half_batch():
    from repro_torch.train import step
    real = step._xent

    def half(logits, labels, z_coef):
        b, n = labels.shape
        if b > 1:
            return real(logits[:b // 2], labels[:b // 2], z_coef)
        return real(logits, labels[:, :n // 2], z_coef)
    with _patched(step, "_xent", half):
        yield


@contextlib.contextmanager
def layer_grad_dropped(layer: int = 0):
    """Zero layer ``layer`` of the first weight (in sorted order) of the
    first block of three or more dims in the gradient tree."""
    from repro_torch.train import step
    real = step.adamw_update

    def dropped(grads, params, state, cfg, lr):
        node = grads["stages"][0]["blocks"][0]
        name = sorted(k for k, v in node.items() if v.dim() >= 3)[0]
        node[name][layer].zero_()
        return real(grads, params, state, cfg, lr)
    with _patched(step, "adamw_update", dropped):
        yield


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "layer_grad_dropped": layer_grad_dropped}
