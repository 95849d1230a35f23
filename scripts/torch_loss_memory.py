"""The port's training loss alone on the card: time and memory of
``train.step._xent``'s forward and backward against the plain PyTorch
cross-entropy on the same logits (float32 upcast, ``logsumexp``,
``gather``: what JAX's ``_xent`` computes, written out eagerly).

For each shape (b, s, V) the logits are bf16 (b, s + 1, V) drawn from a
seed, and the loss takes their ``[:, :-1]`` view with z-loss 1e-4, as
``loss_fn`` does; the gradient is taken with ``torch.autograd.grad``.
Per version: the median ms of ``REPS`` calls (CUDA events), the peak
of bytes allocated during one call above what was allocated before it
(``torch.cuda.max_memory_allocated``), and the gradient's and the
loss's distance from plain.  The shapes (``SHAPES``) are granite-8b's
logits of one 10b microbatch (1, 4095, 49152) and a rank's shard of
gemma-7b's ``train_4k`` logits on ``pod16x16`` (16, 4095, 16000).

    PYTHONPATH=src python scripts/torch_loss_memory.py

Needs a CUDA card; prints one JSON line per shape."""
from __future__ import annotations

import json
import statistics

import torch

from repro_torch.train import step as step_mod

SHAPES = [(1, 4095, 49152), (16, 4095, 16000)]
Z_LOSS = 1e-4
REPS = 5


def plain_xent(logits, labels, z_coef: float):
    """JAX's ``_xent`` written out in eager PyTorch."""
    lg = logits.float()
    lse = torch.logsumexp(lg, -1)
    ll = torch.gather(lg, -1, labels[..., None])[..., 0]
    return (lse - ll).mean(), torch.square(lse).mean() * z_coef


def port_call(logits, labels):
    """The port's loss as ``loss_fn`` calls it: the whole logits and the
    labels of all but the last position."""
    ce, z = step_mod._xent(logits, labels[:, :-1], Z_LOSS)
    return ce + z


def plain_call(logits, labels):
    ce, z = plain_xent(logits[:, :-1], labels[:, :-1], Z_LOSS)
    return ce + z


def one_call(fn, logits, labels):
    loss = fn(logits, labels)
    grad, = torch.autograd.grad(loss, logits)
    return loss.detach(), grad


def measure(fn, logits, labels) -> dict:
    """Median ms of ``REPS`` calls and one call's peak above its start."""
    one_call(fn, logits, labels)                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss, grad = one_call(fn, logits, labels)
    torch.cuda.synchronize()
    out = {"peak_bytes": torch.cuda.max_memory_allocated() - base}
    ms = []
    for _ in range(REPS):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        one_call(fn, logits, labels)
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    out["ms"] = statistics.median(ms)
    return out, loss, grad


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    for b, s, v in SHAPES:
        g = torch.Generator("cuda").manual_seed(0)
        logits = torch.randn(b, s + 1, v, generator=g, device="cuda") \
            .bfloat16().requires_grad_()
        labels = torch.randint(0, v, (b, s + 1), generator=g, device="cuda")
        port, lp, gp = measure(port_call, logits, labels)
        plain, lq, gq = measure(plain_call, logits, labels)
        scale = float(gq.float().abs().max())
        print(json.dumps({
            "shape": [b, s, v],
            "logits_bytes": b * s * v * logits.element_size(),
            "port": port, "plain": plain,
            "loss_rel_err": float((lp - lq).abs() / lq.abs()),
            "grad_err_over_max": float((gp.float() - gq.float()).abs().max())
            / scale}))
        del logits, labels, gp, gq
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
