"""Training step: fp32 cross-entropy (+ z-loss, + DeepSeek MTP aux loss),
microbatched gradient accumulation, remat, AdamW.

Counterpart of ``repro.train.step``.  Where JAX scans the microbatches
with ``lax.scan`` inside one jitted function, the port loops over them
eagerly: each slice's gradients (``loss.backward()`` on the parameters'
leaves) are added in float32 to an accumulator, ``acc + g.float()``, and
divided by their count; the loss and metrics are averaged as the scan's
are.  The optimizer then updates the parameters and its state in place
(:func:`repro_torch.optim.adamw_update`).  Sharding constraints on the
gradients (JAX's ``rule`` and ``_pin``) wait for the port's distribution
slice (ROADMAP.md Queue 1, item 5).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.common import tmap
from ..optim import OptConfig, adamw_update, cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    microbatches: int = 1
    remat: bool = True
    z_loss: float = 1e-4
    mtp_weight: float = 0.3        # deepseek MTP aux-loss weight (lambda)
    warmup_steps: int = 100
    total_steps: int = 10_000


def _no_rule(rule) -> None:
    if rule is not None:
        raise NotImplementedError(
            "a sharding rule waits for the port's distribution slice "
            "(ROADMAP.md Queue 1, item 5)")


def _xent(logits, labels, z_coef: float):
    """fp32 softmax cross-entropy with z-loss; returns (loss, zloss) means."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    ce = lse - ll
    z = torch.square(lse)
    return ce.mean(), z.mean() * z_coef


def loss_fn(model, params, batch, rule=None, tcfg: TrainConfig | None = None,
            remat: bool = True):
    """Returns (scalar loss, metrics dict)."""
    _no_rule(rule)
    tcfg = tcfg or TrainConfig()
    cfg = model.cfg
    labels = batch["labels"]
    out = model.forward(params, batch, remat=remat, return_hidden=cfg.mtp)
    if cfg.mtp:
        logits, hidden = out
    else:
        logits = out
    ce, z = _xent(logits[:, :-1], labels[:, :-1], tcfg.z_loss)
    loss = ce + z
    metrics = {"ce": ce, "z_loss": z}
    if cfg.mtp:
        mtp_logits = model.mtp_forward(params, hidden, labels)
        mtp_labels = torch.roll(labels, -1, dims=1)
        mtp_ce, _ = _xent(mtp_logits[:, :-2], mtp_labels[:, :-2], 0.0)
        loss = loss + tcfg.mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def make_train_step(model, tcfg: TrainConfig, rule=None):
    """Build ``step_fn(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``.  The global batch is split into
    ``tcfg.microbatches`` slices along its first axis; ``params`` and
    ``opt_state`` are updated in place and returned."""
    _no_rule(rule)
    k = tcfg.microbatches

    def grads_of(params, mb):
        """(loss, metrics, grads): grads in the parameters' types, zeros
        for a leaf the loss does not reach."""
        live = tmap(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = loss_fn(model, live, mb, tcfg=tcfg,
                                remat=tcfg.remat)
        loss.backward()
        grads = tmap(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), live)
        return loss.detach(), {n: m.detach() for n, m in metrics.items()}, \
            grads

    def step_fn(params, opt_state, batch, step):
        if k == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            grads = tmap(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
            loss_sum, ms = 0.0, []
            for i in range(k):
                mb = {n: x[i * (x.shape[0] // k):(i + 1) * (x.shape[0] // k)]
                      for n, x in batch.items()}
                l, m, g = grads_of(params, mb)
                tmap(lambda a, g_: a.add_(g_), grads, g)   # acc + g.float()
                del g
                loss_sum = loss_sum + l
                ms.append(m)
            tmap(lambda a: a.div_(k), grads)
            loss = loss_sum / k
            metrics = {n: torch.stack([m[n] for m in ms]).mean()
                       for n in ms[0]}
        lr = cosine_schedule(step, peak_lr=tcfg.opt.lr,
                             warmup_steps=tcfg.warmup_steps,
                             total_steps=tcfg.total_steps)
        params, opt_state, om = adamw_update(grads, params, opt_state,
                                             tcfg.opt, lr)
        metrics = dict(metrics, **om, lr=lr, loss=loss)
        return params, opt_state, metrics

    return step_fn
