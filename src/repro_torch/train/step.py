"""Training step: fp32 cross-entropy (+ z-loss, + DeepSeek MTP aux loss),
microbatched gradient accumulation, remat, AdamW.

Counterpart of ``repro.train.step``.  Where JAX scans the microbatches
with ``lax.scan`` inside one jitted function, the port loops over them
eagerly: each slice's gradients (``loss.backward()`` on the parameters'
leaves) are added in float32 to an accumulator, ``acc + g.float()``, and
divided by their count; the loss and metrics are averaged as the scan's
are.  The optimizer then updates the parameters and its state in place
(:func:`repro_torch.optim.adamw_update`).

Under a sharding ``rule`` the parameters, the optimizer state and the
batch are DTensors on one mesh (``launch.cell.shard``; every rank runs
this step on its shards, SPMD).  ``_pin`` redistributes each gradient,
and each microbatch's float32 accumulator, to its parameter's
placements: a ``Partial`` gradient (summed over the ranks that shared a
weight's rows) becomes a reduce-scatter into the shards, not an
all-reduce — JAX's AR->RS rewrite.  The step runs inside
:func:`~repro_torch.models.common.sharded`, so the backward's plain
tensors meet DTensors as replicated too.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .. import obs
from ..models.common import on_replicas, row_shards, sharded, spec_tree, tmap
from ..models.common import with_sharding
from ..optim import OptConfig, adamw_update, cosine_schedule
from . import xent


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    microbatches: int = 1
    remat: bool = True
    z_loss: float = 1e-4
    mtp_weight: float = 0.3        # deepseek MTP aux-loss weight (lambda)
    warmup_steps: int = 100
    total_steps: int = 10_000


def _xent(logits, labels, z_coef: float):
    """fp32 softmax cross-entropy with z-loss; returns (loss, zloss) means.
    ``labels`` (b, n) are the targets of the first n ≤ s positions of
    ``logits`` (b, s, V); the positions after them take no part, so a
    caller passes the whole logits, not a slice whose backward would
    allocate a second logit-sized gradient.  The logits stay in their own
    type: each row's sums run in float32 chunks (:mod:`.xent`), as XLA
    fuses JAX's upcast into them."""
    lse, ll = _lse_and_label(logits, labels)
    ce = lse - ll
    z = torch.square(lse)
    return ce.mean(), z.mean() * z_coef


def _vocab_split(lg):
    """``(vd, rows)`` when DTensor logits ``lg`` are split over vocab on
    exactly one mesh dim ``vd`` of more than one rank and their rows
    split evenly; ``rows`` is their placements with dim 0's split kept
    and every other mesh dim replicated.  The vocab need not divide:
    DTensor lays an uneven dim out in ``torch.chunk``'s sizes
    (:func:`_vocab_offset`).  ``vd`` is None otherwise: a vocab "split"
    over one rank runs whole on each rank's rows, the same local ops as
    the unsharded loss."""
    mesh = lg.device_mesh
    vocab = [d for d, p in enumerate(lg.placements)
             if p == Shard(lg.ndim - 1) and mesh.size(d) > 1]
    rows = tuple(p if p == Shard(0) else Replicate() for p in lg.placements)
    if len(vocab) != 1 or lg.shape[0] % row_shards(lg):
        return None, rows
    return vocab[0], rows


def _vocab_offset(V: int, n: int, r: int) -> int:
    """The first vocab column of rank ``r`` of ``n`` on a vocab of ``V``
    split as DTensor splits an uneven dim (``torch.chunk``: ceil(V / n)
    columns a rank, the last ranks fewer or none)."""
    return min(r * -(-V // n), V)


def _lse_and_label(lg, labels):
    """``(logsumexp(lg, -1), lg[..., labels])``, each (b, n) for labels
    (b, n) on the first n positions of ``lg`` (b, s, V), in float32
    (float64 for float64 logits), through one
    :class:`~.xent.SliceSums`.  Logits split over vocab on one mesh dim
    (the head's `model`), evenly or not, reduce on each rank's vocab
    slice (:func:`_vocab_lse_and_label`).  Other DTensor logits run on
    each rank's rows with the vocab gathered
    (:func:`~repro_torch.models.common.on_replicas`)."""
    if not isinstance(lg, DTensor):
        return xent.lse_and_label(lg, labels)
    vd, rows = _vocab_split(lg)
    if vd is None:
        return on_replicas(xent.lse_and_label, lg, labels, rows=(0, 1))
    return _vocab_lse_and_label(lg, labels, vd, rows)


def _vocab_lse_and_label(lg, labels, vd: int, rows: tuple):
    """:func:`_lse_and_label` of DTensor logits split over vocab on mesh
    dim ``vd``, with the results on ``rows``' placements
    (:func:`_vocab_split`).  The row max of each rank's slice, detached
    (the result does not depend on the shift), is all-reduced with
    ``max`` over ``vd``; then :class:`~.xent.SliceSums` runs once on the
    rank's slice (its first column at :func:`_vocab_offset`; a label
    outside it picks 0, an empty slice adds 0) and its two sums, each
    ``Partial`` over ``vd``, are all-reduced there: three (b, s)
    all-reduces, the rows kept on their batch shards.  The backward is
    each rank's ``g_s·exp(lg - max)`` plus the label's ``g_l`` on its own
    slice, one gradient buffer; DTensor's own ``logsumexp`` would gather
    the whole vocab for a rank's rows, and its vocab-parallel gather
    leaves a masked partial it fails to reduce."""
    mesh = lg.device_mesh
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
    split = tuple(Shard(lg.ndim - 1) if d == vd else p
                  for d, p in enumerate(rows))

    def over_vocab(op):
        return tuple(Partial(op) if d == vd else p
                     for d, p in enumerate(rows))
    n = labels.shape[1]
    m = local_map(lambda t: xent.row_max(t[:, :n]),
                  out_placements=list(over_vocab("max")),
                  in_placements=(split,), device_mesh=mesh,
                  redistribute_inputs=True)(lg.detach()) \
        .redistribute(mesh, rows)
    offset = _vocab_offset(lg.shape[-1], mesh.size(vd),
                           mesh.get_local_rank(vd))
    s, ll = xent.SliceSums.apply(
        _Shard.apply(lg.redistribute(mesh, split)), m.to_local(),
        labels.redistribute(mesh, rows).to_local(), offset)

    def summed(x):
        return DTensor.from_local(x, mesh, over_vocab("sum"),
                                  run_check=False).redistribute(mesh, rows)
    return m + torch.log(summed(s)), summed(ll)


class _Shard(torch.autograd.Function):
    """A DTensor's local shard, whose gradient comes back as a DTensor of
    the input's own global shape and stride.  ``to_local``'s backward
    derives the stride from the local gradient, which on an uneven split
    differs from the input's: a leaf then accumulates through a copy, and
    torch 2.11 gathers that copy whole."""

    @staticmethod
    def forward(ctx, x):
        ctx.meta = (x.device_mesh, x.placements, x.shape, x.stride())
        loc = x.to_local()
        return loc.view_as(loc)

    @staticmethod
    def backward(ctx, g):
        mesh, placements, shape, stride = ctx.meta
        return DTensor.from_local(g, mesh, placements, run_check=False,
                                  shape=shape, stride=stride)


def loss_fn(model, params, batch, rule=None, tcfg: TrainConfig | None = None,
            remat: bool = True):
    """Returns (scalar loss, metrics dict)."""
    tcfg = tcfg or TrainConfig()
    cfg = model.cfg
    labels = batch["labels"]
    out = model.forward(params, batch, remat=remat, return_hidden=cfg.mtp,
                        rule=rule)
    if cfg.mtp:
        logits, hidden = out
    else:
        logits = out
    ce, z = obs.layer("train.xent",
                      lambda lg: _xent(lg, labels[:, :-1], tcfg.z_loss),
                      logits)
    loss = ce + z
    metrics = {"ce": ce, "z_loss": z}
    if cfg.mtp:
        mtp_logits = model.mtp_forward(params, hidden, labels, rule=rule)
        # row by row: torch 2.11's DTensor has no strategy for roll
        mtp_labels = on_replicas(lambda t: torch.roll(t, -1, dims=1),
                                 labels, rows=(0,))
        mtp_ce, _ = obs.layer("train.xent",
                              lambda lg: _xent(lg, mtp_labels[:, :-2], 0.0),
                              mtp_logits)
        loss = loss + tcfg.mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def make_train_step(model, tcfg: TrainConfig, rule=None):
    """Build ``step_fn(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``.  The global batch is split into
    ``tcfg.microbatches`` slices along its first axis; ``params`` and
    ``opt_state`` are updated in place and returned.  Under ``rule`` they
    are DTensors (module docstring); the metrics are plain scalars on
    every rank."""
    k = tcfg.microbatches

    # grad sharding constraints: pin every gradient leaf to its parameter's
    # sharding so the reduction is a reduce-scatter into the shards
    # instead of a full all-reduce (the AR->RS rewrite)
    gspecs = spec_tree(model.param_recs(), rule) if rule is not None \
        else None

    def _pin(grads):
        if gspecs is None:
            return grads
        return tmap(lambda g, s: with_sharding(g, *s), grads, gspecs)

    def grads_of(params, mb):
        """(loss, metrics, grads): grads in the parameters' types, zeros
        for a leaf the loss does not reach."""
        live = tmap(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = loss_fn(model, live, mb, rule=rule, tcfg=tcfg,
                                remat=tcfg.remat)
        loss.backward()
        grads = tmap(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), live)
        return loss.detach(), {n: m.detach() for n, m in metrics.items()}, \
            _pin(grads)

    def step_fn(params, opt_state, batch, step):
        with obs.span("train.step", None), sharded(rule):
            if k == 1:
                loss, metrics, grads = grads_of(params, batch)
            else:
                grads = tmap(
                    lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
                loss_sum, ms = 0.0, []
                for i in range(k):
                    mb = {n: x[i * (x.shape[0] // k):
                               (i + 1) * (x.shape[0] // k)]
                          for n, x in batch.items()}
                    l, m, g = grads_of(params, mb)
                    # acc + g.float()
                    tmap(lambda a, g_: a.add_(g_), grads, g)
                    del g
                    grads = _pin(grads)
                    loss_sum = loss_sum + l
                    ms.append(m)
                tmap(lambda a: a.div_(k), grads)
                loss = loss_sum / k
                metrics = {n: torch.stack([m[n] for m in ms]).mean()
                           for n in ms[0]}
            lr = cosine_schedule(step, peak_lr=tcfg.opt.lr,
                                 warmup_steps=tcfg.warmup_steps,
                                 total_steps=tcfg.total_steps)
            with obs.span("optim.adamw", None):
                params, opt_state, om = adamw_update(grads, params,
                                                     opt_state, tcfg.opt, lr)
            metrics = dict(metrics, **om, lr=lr, loss=loss)
            # scalars every rank holds whole, as JAX's replicated metrics
            metrics = {n: v.full_tensor() if isinstance(v, DTensor) else v
                       for n, v in metrics.items()}
            return params, opt_state, metrics

    return step_fn
