"""What each gloo rank of ``tests/test_torch_dist.py`` runs (through
``_torch_ranks.run_ranks``): the port only, no JAX.  Each function
returns numpy values; the test holds them against JAX's (written to an
``.npz`` by JAX on forced host devices) and against the port's own
single-process results."""
from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import ckpt, configs
from repro_torch.ckpt.store import flatten
from repro_torch import dist as tdist
from repro_torch.data import SyntheticLM
from repro_torch.launch import cell
from repro_torch.launch import mesh as tmesh
from repro_torch.models import common
from repro_torch.models import lm as lm_mod
from repro_torch.models import mamba2
from repro_torch.models.lm import LM
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train import TrainConfig, Trainer, make_train_step
from repro_torch.train import step as step_mod

SHAPE = configs.SHAPES["train_4k"]


def _placed(t) -> list:
    """A DTensor's placements as (kind, dim) pairs."""
    return [(type(p).__name__, getattr(p, "dim", None))
            for p in t.placements]


def _np(t) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ----------------------------------------------------------------------
# 8 ranks: compressed all-reduce and GPipe
# ----------------------------------------------------------------------
def compression_and_gpipe(npz: str) -> dict:
    data = np.load(npz)
    rank = dist.get_rank()
    mesh = tmesh._make_mesh((8,), ("data",), device="cpu")
    group = mesh.get_group("data")
    g = torch.from_numpy(data["g"][rank])
    err0 = tdist.CompressionState.zeros_like(g).error
    mean, err = tdist.compressed_psum_tree(g, err0, group)
    acc, e = torch.zeros_like(g), err0
    for _ in range(8):
        o, e = tdist.compressed_psum_tree(g, e, group)
        acc += o

    pmesh = tmesh._make_mesh((8,), ("pod",), device="cpu")
    ws = common.distribute(torch.from_numpy(data["ws"]), pmesh, [Shard(0)])
    ws.requires_grad_()
    x = torch.from_numpy(data["x"])
    piped = tdist.gpipe(lambda w, h: torch.tanh(h @ w), pmesh, axis="pod",
                        n_microbatches=4)
    y = piped(ws, x)
    (y ** 2).sum().backward()
    return {"mean": mean.numpy(), "err": err.numpy(), "acc": acc.numpy(),
            "y": y.detach().numpy(), "grad": _np(ws.grad),
            "grad_placements": _placed(ws.grad)}


# ----------------------------------------------------------------------
# 4 ranks, a (2, 2) mesh: the sharded step, the ten forwards, checkpoints
# and the Trainer
# ----------------------------------------------------------------------
def _granite():
    return configs.reduced(configs.get_config("granite-8b"))


def _mesh(data: int = 2, model: int = 2):
    return tmesh.make_local_mesh(data, model, device="cpu")


def _step_cfg() -> TrainConfig:
    return TrainConfig(opt=OptConfig(lr=1e-3), warmup_steps=1,
                       total_steps=10)


def sharded_step(jdir: str, npz: str, out_dir: str | None,
                 act_dtype: str) -> dict:
    """JAX's granite parameters (from JAX's checkpoint, bf16) on the
    (2, 2) mesh through one sharded step, and on rank 0 the
    single-device step from the same parameters.  ``act_dtype`` float32
    runs the parameters in float32 too (bf16 at this init moves the
    gradients chaotically: only the loss compares there).  With
    ``out_dir`` the sharded parameters are then saved for JAX to
    restore."""
    cfg = dataclasses.replace(_granite(), act_dtype=act_dtype)
    dtype = common.dtype_of(act_dtype)
    model = LM(cfg)
    recs = model.param_recs()
    rule = cell.rule_for(cfg, SHAPE, multi_pod=False)
    mesh = _mesh()
    tcfg = _step_cfg()
    toks = np.load(npz)["tokens"].astype(np.int64)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    template = {"params": common.abstract_tree(recs)}
    psh = cell.shard(mesh, common.spec_tree(recs, rule))
    tree, _ = ckpt.restore(jdir, 0, template, shardings={"params": psh})
    params = common.tmap(lambda t: t.to(dtype), tree["params"])
    opt = common.tmap(
        lambda t, sh: sh.distribute(t), adamw_init(params, tcfg.opt),
        cell.shard(mesh, cell.opt_specs(recs, rule, tcfg.opt)))
    bspecs = cell.shard(mesh, cell.batch_specs(cfg, SHAPE, rule))
    dbatch = {k: bspecs[k].distribute(v) for k, v in batch.items()}
    params, opt, m = make_train_step(model, tcfg, rule=rule)(
        params, opt, dbatch, 0)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "lr": float(m["lr"]),
           "placed": all(tuple(p.placements) == sh.placements for p, sh in
                         zip(common.leaves(params), common.leaves(psh))),
           "params": [_np(p) for p in common.leaves(params)],
           "master": [_np(p) for p in common.leaves(opt["master"])]}
    if out_dir:
        ckpt.save(out_dir, 1, {"params": params})
    if dist.get_rank() == 0:
        single, _ = ckpt.restore(jdir, 0, template, device="cpu")
        p1 = common.tmap(lambda t: t.to(dtype), single["params"])
        p1, o1, m1 = make_train_step(model, tcfg)(
            p1, adamw_init(p1, tcfg.opt), batch, 0)
        out["single"] = {"loss": float(m1["loss"]),
                         "grad_norm": float(m1["grad_norm"]),
                         "params": [_np(p) for p in common.leaves(p1)],
                         "master": [_np(p) for p in
                                    common.leaves(o1["master"])],
                         "m": [_np(p) for p in common.leaves(o1["m"])]}
    return out


def _forward_batch(cfg, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    b, s = 4, 16
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.n_img_tokens:
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
    if cfg.encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_len, cfg.d_model)).astype(np.float32))
    return batch


def sharded_forwards(archs: list) -> dict:
    """Each reduced config in float32 from the port's seeded parameters:
    the forward on the (2, 2) mesh under ``rule_for(cfg, train_4k)`` and
    the unsharded forward, both in every rank (the latter needs no
    collective)."""
    mesh = _mesh()
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                                  act_dtype="float32")
        model = LM(cfg)
        recs = model.param_recs()
        params = common.materialize(recs, torch.Generator().manual_seed(0),
                                    default_dtype=torch.float32)
        batch = _forward_batch(cfg)
        ref = model.forward(params, batch)
        rule = cell.rule_for(cfg, SHAPE, multi_pod=False)
        sh = cell.shard(mesh, common.spec_tree(recs, rule))
        dparams = common.tmap(lambda t, s: s.distribute(t), params, sh)
        bspecs = cell.shard(mesh, cell.batch_specs(cfg, SHAPE, rule))
        dbatch = {k: bspecs[k].distribute(v) for k, v in batch.items()}
        got = model.forward(dparams, dbatch, rule=rule)
        out[arch] = {"ref": ref.detach().numpy(), "got": _np(got),
                     "placements": _placed(got)}
    return out


def _tree():
    rng = np.random.default_rng(0)
    return {"w": torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32),
            "e": torch.from_numpy(rng.standard_normal((4, 8)).astype(
                np.float32)).bfloat16(),
            "q": {"q": torch.arange(-16, 16, dtype=torch.int8).reshape(4, 8),
                  "scale": torch.ones(4, 1)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _specs():
    P = common.P
    return {"w": P("data", "model"), "e": P(None, "model"),
            "q": {"q": P("data", "model"), "scale": P("data", None)},
            "step": P()}


def elastic(port_dir: str, jax_dir: str) -> dict:
    """Save a tree from the (2, 2) mesh; restore it onto (4, 1) and
    (1, 4); restore JAX's checkpoint (saved from a sharded array) onto
    each of the three meshes."""
    tree = _tree()
    mesh = _mesh()
    sharded = common.tmap(lambda t, sh: sh.distribute(t), tree,
                          cell.shard(mesh, _specs()))
    ckpt.save(port_dir, 1, sharded, extra={"mesh": [2, 2]})
    out = {"saved": ckpt.latest_step(port_dir)}
    want = {k: _np(v) for k, v in flatten(tree).items()}
    jtree = {"w": torch.empty(64, 32), "e": torch.empty(4, 4,
                                                        dtype=torch.bfloat16)}
    jwant = {"w": np.arange(64 * 32, dtype=np.float32).reshape(64, 32)}
    for shape in [(2, 2), (4, 1), (1, 4)]:
        m = _mesh(*shape)
        got, manifest = ckpt.restore(port_dir, 1, tree,
                                     shardings=cell.shard(m, _specs()))
        flat = flatten(got)
        out[shape] = {
            "equal": all(np.array_equal(_np(flat[k]), want[k])
                         for k in want),
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "local_w": tuple(flat["w"].to_local().shape),
            "mesh": tuple(flat["w"].device_mesh.shape),
            "extra": manifest["extra"]}
        jgot, _ = ckpt.restore(jax_dir, 1, jtree, shardings=cell.shard(
            m, {"w": common.P("data", "model"), "e": common.P("model")}))
        out[shape]["jax_w"] = np.array_equal(_np(jgot["w"]), jwant["w"])
        out[shape]["jax_e"] = _np(jgot["e"])
        out[shape]["jax_e_dtype"] = str(jgot["e"].dtype)
    return out


class F32LM(LM):
    """The model with float32 parameters: the trainer draws bf16 ones, and
    bf16 at this init moves the gradients chaotically (``sharded_step``),
    so the trainer's updates compare in float32."""

    def param_recs(self):
        return common.tmap(lambda r: dataclasses.replace(
            r, dtype=r.dtype or torch.float32), super().param_recs())


def trainer_on_mesh(ckpt_dir: str) -> dict:
    """``Trainer(rule=..., mesh=...)`` for 4 steps in 2 microbatches,
    checkpointing every 2 steps, with a failure injected before step 3:
    the trainer restores step 2's checkpoint onto the mesh and replays.
    Rank 0 also runs the unsharded trainer from the same seeds.  Float32
    parameters and activations; each returns its losses and how far each
    float32 master moved from the first draw."""
    cfg = dataclasses.replace(_granite(), act_dtype="float32")
    model = F32LM(cfg)
    rule = cell.rule_for(cfg, SHAPE, multi_pod=False)
    data = SyntheticLM(vocab=cfg.vocab, seq=16, global_batch=4, seed=0)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3), microbatches=2,
                       warmup_steps=1, total_steps=10)
    fired = []

    def fail_once(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    tr = Trainer(model, data, tcfg, rule=rule, mesh=_mesh(), device="cpu",
                 ckpt_dir=ckpt_dir, ckpt_every=2, failure_hook=fail_once)
    params, opt, step = tr.run(4, generator=torch.Generator().manual_seed(0))

    def moved(trainer, opt):
        """Each float32 master's change from the trainer's first draw."""
        init, _, _ = trainer.init_state(torch.Generator().manual_seed(0))
        return [_np(m) - _np(p) for m, p in zip(
            common.leaves(opt["master"]), common.leaves(init))]
    out = {"step": step,
           "losses": {m["step"]: m["loss"] for m in tr.metrics_log
                      if "loss" in m},
           "events": [m["event"] for m in tr.metrics_log if "event" in m],
           "latest": ckpt.latest_step(ckpt_dir),
           "dtensors": all(isinstance(t, DTensor) for t in
                           common.leaves(params) + common.leaves(opt)),
           "moved": moved(tr, opt), "lr": tcfg.opt.lr}
    if dist.get_rank() == 0:
        ref = Trainer(model, data, tcfg, device="cpu")
        _, ro, _ = ref.run(4, generator=torch.Generator().manual_seed(0))
        out["single"] = {"losses": {m["step"]: m["loss"]
                                    for m in ref.metrics_log},
                         "moved": moved(ref, ro)}
    return out


#: einsum cases: equation, operand shapes and their specs on the (2, 2)
#: mesh (None: a plain tensor)
EINSUMS = {
    "qkv projection": ("bsd,dnh->bsnh", (4, 6, 8), ("data", "model", None),
                       (8, 4, 2), ("data", "model", None)),
    "output projection": ("bsnh,nhd->bsd", (4, 6, 4, 2),
                          ("data", None, "model", None), (4, 2, 8),
                          ("model", None, "data")),
    "tied head": ("bsd,vd->bsv", (4, 6, 8), ("data", "model", None),
                  (10, 8), ("model", "data")),
    "one operand's sum": ("bsd,bd->b", (4, 6, 8), ("data", "model", None),
                          (4, 8), ("data", None)),
    "plain weight": ("bsd,df->bsf", (4, 6, 8), ("data", None, "model"),
                     (8, 6), None),
}


def einsums() -> dict:
    """Each EINSUMS case on the (2, 2) mesh against the same einsum on
    full tensors: the result and both operands' gradients (of the sum of
    the result times a fixed weight), max abs differences."""
    mesh = _mesh()
    out = {}
    for name, (eq, sa, pa, sb, pb) in EINSUMS.items():
        g = torch.Generator().manual_seed(len(name))
        a, b = (torch.randn(sh, generator=g, dtype=torch.float64)
                for sh in (sa, sb))
        ref = [t.clone().requires_grad_() for t in (a, b)]
        want = torch.einsum(eq, *ref)
        w = torch.randn(want.shape, generator=g, dtype=torch.float64)
        (want * w).sum().backward()
        live = [common.distribute(t, mesh, common.placements(
            common.P(*p), mesh)).requires_grad_() if p else
            t.clone().requires_grad_() for t, p in ((a, pa), (b, pb))]
        with common.sharded({}):
            got = common.einsum(eq, *live)
            (got * w).sum().backward()
        out[name] = [float((_t(got) - want).abs().max())] + [
            float((_t(x.grad) - r.grad).abs().max())
            for x, r in zip(live, ref)]
    return out


def _t(t) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def escapes() -> dict:
    """``common.on_replicas`` on the (2, 2) mesh in float64, against the
    same function on full tensors: ``rows`` keeps the batch's rows split
    over `data` (a plain tensor among them cut to this rank's rows), the
    rest gathered, and the gradients of a whole argument summed over the
    rows; rows that do not split evenly, and no ``rows``, run whole.
    Then the loss's label pick and its log-sum-exp on vocab shards (10
    split over `model`; 9, which does not split, on each rank's rows), the
    loss on a (4, 1) mesh against the unsharded one in float32 (its `model`
    of one rank runs the same local ops: the rows' log-sum-exp and the
    logits' gradient equal bit for bit) and the embedding lookup.  Each case: max abs differences of the value
    and the gradients, the result's placements and its local rows."""
    mesh = _mesh()
    g = torch.Generator().manual_seed(3)
    out = {}
    for case, b, rows in (("rows", 4, (1, 2)), ("uneven rows", 3, (1, 2)),
                          ("no rows", 4, ())):
        w, x = (torch.randn(sh, generator=g, dtype=torch.float64)
                for sh in ((8, 5), (b, 6, 8)))
        z = torch.randn(b, 6, generator=g, dtype=torch.float64)
        wt = torch.randn(b, 6, 5, generator=g, dtype=torch.float64)

        def fn(w_, x_, z_):
            return (x_ @ w_) * z_[..., None]
        ref = [t.clone().requires_grad_() for t in (w, x)]
        want = fn(*ref, z)
        (want * wt).sum().backward()
        live = [common.distribute(t, mesh, pl).requires_grad_() for t, pl in
                ((w, (Replicate(), Shard(0))), (x, (Shard(0), Shard(2))))]
        got = common.on_replicas(fn, *live, z, rows=rows)
        (got * common.distribute(wt, mesh, got.placements)).sum().backward()
        err = [(_t(got) - want).detach()] + [_t(t.grad) - r.grad
                                             for t, r in zip(live, ref)]
        out[case] = {"err": [float(e.abs().max()) for e in err],
            "placements": _placed(got),
            "local_rows": got.to_local().shape[0]}
    lg = torch.randn(4, 6, 10, generator=g, dtype=torch.float64)
    labels = torch.randint(0, 10, (4, 6), generator=g)
    ref = lg.clone().requires_grad_()
    want = torch.gather(ref, -1, labels[..., None])[..., 0]
    wt = torch.randn(4, 6, generator=g, dtype=torch.float64)
    (want * wt).sum().backward()
    live = common.distribute(lg, mesh, (Shard(0), Shard(2))) \
        .requires_grad_()
    got = step_mod._lse_and_label(live, common.distribute(
        labels, mesh, (Shard(0), Replicate())))[1]
    (got * common.distribute(wt, mesh, got.placements)).sum().backward()
    out["labels"] = {"err": [float((_t(got) - want).detach().abs().max()),
                             float((_t(live.grad) - ref.grad).abs().max())],
                     "placements": _placed(got),
                     "local_rows": got.to_local().shape[0]}
    for case, V in (("logsumexp", 10), ("logsumexp uneven", 9)):
        lg = torch.randn(4, 6, V, generator=g, dtype=torch.float64)
        ref = lg.clone().requires_grad_()
        want = torch.logsumexp(ref, -1)
        wt = torch.randn(4, 6, generator=g, dtype=torch.float64)
        (want * wt).sum().backward()
        live = common.distribute(lg, mesh, (Shard(0), Shard(2))) \
            .requires_grad_()
        got = step_mod._lse_and_label(live, torch.zeros(4, 6,
                                                        dtype=torch.long))[0]
        (got * common.distribute(wt, mesh, got.placements)).sum().backward()
        out[case] = {"err": [float((_t(got) - want).detach().abs().max()),
                             float((_t(live.grad) - ref.grad).abs().max())],
                     "placements": _placed(got),
                     "local_rows": got.to_local().shape[0]}
    # `model` of one rank: the loss runs the unsharded loss's local ops,
    # so a sharded step on one card equals the unsharded one bit for bit
    lg = torch.randn(4, 6, 10, generator=g)
    labels = torch.randint(0, 10, (4, 6), generator=g)
    ref = lg.clone().requires_grad_()
    want = sum(step_mod._xent(ref, labels, 1e-4))
    want.backward()
    m41 = _mesh(4, 1)
    live = common.distribute(lg, m41, (Shard(0), Shard(2))).requires_grad_()
    got = step_mod._xent(live, common.distribute(
        labels, m41, (Shard(0), Replicate())), 1e-4)
    sum(got).backward()
    lse = step_mod._lse_and_label(live, labels)[0]
    out["one-rank vocab"] = {
        "err": [float((_t(lse) - torch.logsumexp(lg, -1)).abs().max()),
                float((_t(live.grad) - ref.grad).abs().max())],
        "placements": _placed(lse), "local_rows": lse.to_local().shape[0]}
    cfg = _granite()
    table = common.distribute(torch.randn(cfg.vocab, 8, generator=g), mesh,
                              (Shard(1), Shard(0)))
    toks = torch.randint(0, cfg.vocab, (4, 16), generator=g)
    got = lm_mod._lookup(table, common.distribute(
        toks, mesh, (Shard(0), Replicate())))
    out["lookup"] = {"err": [float((_t(got) - _t(table)[toks]).abs().max())],
                     "placements": _placed(got),
                     "local_rows": got.to_local().shape[0]}
    return out


def _numel(shape: str) -> int:
    """Elements of a recorded result type such as ``f32[4,6,5]``."""
    dims = shape[shape.index("[") + 1:-1]
    return int(np.prod([int(d) for d in dims.split(",") if d]))


def loss_ops() -> dict:
    """The loss (``_xent`` with its z-loss) forward and backward on the
    (2, 2) mesh under ``graph_analysis.Recorder``, on float32 logits
    (16, 8, 64) split (data, model), against a rank's logits shard: the
    most elements any op of the backward (and of the whole call) touches,
    and the ops' names, beside the shard's elements."""
    from repro_torch.core import graph_analysis
    mesh = _mesh()
    g = torch.Generator().manual_seed(5)
    lg = common.distribute(torch.randn(16, 8, 64, generator=g), mesh,
                           (Shard(0), Shard(2))).requires_grad_()
    labels = common.distribute(torch.randint(0, 64, (16, 8), generator=g),
                               mesh, (Shard(0), Replicate()))

    def loss():
        ce, z = step_mod._xent(lg, labels, 1e-4)
        (ce + z).backward()
    _, cap = graph_analysis.capture(loss)
    ops = cap.analysis.ops
    back = [o for o in ops if o.computation == "backward"]
    return {"shard": lg.to_local().numel(),
            "backward": max(_numel(o.shape) for o in back),
            "all": max(_numel(o.shape) for o in ops),
            "n_backward": len(back),
            "widest": max(ops, key=lambda o: _numel(o.shape)).name}


def mtp_loss() -> dict:
    """``loss_fn`` of the reduced deepseek-v3 (MLA, MoE and the MTP head,
    whose logits go through the same ``_xent``) in float32 on the (2, 2)
    mesh under ``rule_for(cfg, train_4k)``, against the unsharded call
    from the same parameters and batch (:func:`sharded_loss`)."""
    return sharded_loss("deepseek-v3-671b")


def sharded_loss(arch: str, vocab: int | None = None) -> dict:
    """``loss_fn`` of a reduced config (its vocab replaced by ``vocab``
    when given) in float32 on the (2, 2) mesh under ``rule_for(cfg,
    train_4k)``, against the unsharded call from the same parameters and
    batch: the loss, each metric, which leaves the backward reached in
    each, and each reached parameter's gradient (max abs difference over
    the leaf's largest entry)."""
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                              act_dtype="float32")
    if vocab is not None:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    model = F32LM(cfg)
    recs = model.param_recs()
    params = common.materialize(recs, torch.Generator().manual_seed(0),
                                default_dtype=torch.float32)
    batch = _forward_batch(cfg)
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    live = common.tmap(lambda p: p.clone().requires_grad_(), params)
    loss, metrics = step_mod.loss_fn(model, live, batch)
    loss.backward()
    mesh = _mesh()
    rule = cell.rule_for(cfg, SHAPE, multi_pod=False)
    sh = cell.shard(mesh, common.spec_tree(recs, rule))
    dlive = common.tmap(lambda t, s: s.distribute(t).requires_grad_(),
                        params, sh)
    bspecs = cell.shard(mesh, cell.batch_specs(cfg, SHAPE, rule))
    dbatch = {k: bspecs[k].distribute(v) for k, v in batch.items()}
    with common.sharded(rule):
        dloss, dmetrics = step_mod.loss_fn(model, dlive, dbatch, rule=rule)
        dloss.backward()
    grads, reached = [], []
    for d, r in zip(common.leaves(dlive), common.leaves(live)):
        reached.append((r.grad is not None, d.grad is not None))
        if r.grad is None or d.grad is None:
            continue
        want, got = r.grad.detach(), _t(d.grad).detach()
        grads.append(float((got - want).abs().max() /
                           max(float(want.abs().max()), 1e-30)))
    return {"metrics": {n: (float(_t(dmetrics[n])), float(m))
                        for n, m in metrics.items()},
            "grads": grads, "reached": reached}


#: the head-sharded scan's reduced widths: xh (b, L, h, P) is its widest
#: operand, wider than a chunk's (b, Q, Q, h) decays and than the state
SSD = {"b": 4, "L": 32, "h": 4, "P": 4, "N": 6, "Q": 8}
SSD_NAMES = ("xh", "B", "C", "dt", "l_t", "Dp", "state")
#: each operand's placements on the (2, 2) mesh, as the model gives them:
#: batch over `data`, heads over `model`, B and C shared by the heads
SSD_PLACED = ((Shard(0), Shard(2)), (Shard(0), Replicate()),
              (Shard(0), Replicate()), (Shard(0), Shard(2)),
              (Shard(0), Shard(2)), (Replicate(), Shard(0)),
              (Shard(0), Shard(1)))


def _ssd_inputs(g, h: int) -> list:
    """The scan's operands in float64 from generator ``g``: positive
    steps, negative log-decays."""
    b, L, P, N = SSD["b"], SSD["L"], SSD["P"], SSD["N"]

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)
    dt = torch.nn.functional.softplus(rnd(b, L, h))
    A = -torch.exp(0.5 * rnd(h))
    return [rnd(b, L, h, P), rnd(b, L, N), rnd(b, L, N), dt, A * dt,
            rnd(h, 1), rnd(b, h, P, N)]


def _ssd_sharded(live: list):
    """``mamba2._ssd`` through the model's escape on (batch, head)
    shards, the model's rule's ``act_heads`` on `model`."""
    return common.on_replicas(
        lambda *a: mamba2._ssd(*a, SSD["Q"]), *live, rows=(0, 1, 2, 3, 4, 6),
        keep=mamba2._head_split({"act_heads": "model"}))


def ssd_heads() -> dict:
    """The chunked SSD scan on the (2, 2) mesh in float64, each rank on
    its rows and its heads, against the unsharded ``_ssd``: y, the final
    state and the gradient of every operand (B and C, shared by the
    heads, included), max abs differences; the outputs' placements and
    local shapes.  With 3 heads, which do not split over 2 ranks, the
    heads are gathered."""
    mesh = _mesh()
    out = {}
    for case, h in (("heads", SSD["h"]), ("uneven heads", 3)):
        g = torch.Generator().manual_seed(11 + h)
        ins = _ssd_inputs(g, h)
        ref = [t.clone().requires_grad_() for t in ins]
        y, st = mamba2._ssd(*ref, SSD["Q"])
        wy, ws = (torch.randn(t.shape, generator=g, dtype=torch.float64)
                  for t in (y, st))
        ((y * wy).sum() + (st * ws).sum()).backward()
        live = [common.distribute(t, mesh, pl).requires_grad_()
                for t, pl in zip(ins, SSD_PLACED)]
        gy, gst = _ssd_sharded(live)
        ((gy * common.distribute(wy, mesh, gy.placements)).sum()
         + (gst * common.distribute(ws, mesh, gst.placements)).sum()
         ).backward()
        err = {"y": float((_t(gy) - y).detach().abs().max()),
               "state": float((_t(gst) - st).detach().abs().max())}
        for name, x, r in zip(SSD_NAMES, live, ref):
            err["grad " + name] = float((_t(x.grad) - r.grad).abs().max())
        out[case] = {"err": err, "placements": [_placed(gy), _placed(gst)],
                     "local": [tuple(gy.to_local().shape),
                               tuple(gst.to_local().shape)],
                     "grad_placements": [_placed(x.grad) for x in live]}
    return out


def scan_ops() -> dict:
    """The head-sharded scan's forward and backward on the (2, 2) mesh
    under ``graph_analysis.Recorder``: the most elements any op touches,
    beside a rank's (batch, head) shard of the widest operand, xh."""
    from repro_torch.core import graph_analysis
    mesh = _mesh()
    ins = _ssd_inputs(torch.Generator().manual_seed(13), SSD["h"])
    live = [common.distribute(t, mesh, pl).requires_grad_()
            for t, pl in zip(ins, SSD_PLACED)]

    b, L, h, P, N = (SSD[k] for k in "bLhPN")
    # the outputs' gradients on their own shards, as the model's next ops
    # give them
    gy = common.distribute(torch.ones(b, L, h, P, dtype=torch.float64),
                           mesh, (Shard(0), Shard(2)))
    gs = common.distribute(torch.ones(b, h, P, N, dtype=torch.float64),
                           mesh, (Shard(0), Shard(1)))

    def run():
        torch.autograd.backward(_ssd_sharded(live), (gy, gs))
    _, cap = graph_analysis.capture(run)
    ops = cap.analysis.ops
    back = [o for o in ops if o.computation == "backward"]
    return {"shard": live[0].to_local().numel(), "whole": ins[0].numel(),
            "backward": max(_numel(o.shape) for o in back),
            "all": max(_numel(o.shape) for o in ops),
            "n_backward": len(back),
            "widest": max(ops, key=lambda o: _numel(o.shape)).name}


#: uneven vocab cases: the mesh, the logits' shape and a label per case;
#: 67 over 2 ranks is 34 + 33, 5 over 4 is 2 + 2 + 1 + 0
UNEVEN = {"67 over 2": ((2, 2), (4, 6, 67)), "5 over 4": ((1, 4), (4, 6, 5))}


def uneven_loss() -> dict:
    """The loss's parts on logits whose vocab does not divide the `model`
    dim, split (data, model), against the same calls on the whole
    tensor: the log-sum-exp and the label pick in float64 (max abs
    differences of each and of its gradient), and ``_xent`` with its
    z-loss, which casts to float32 as the model's loss does (the loss's
    difference and the logits' gradient's over its largest entry); each
    rank's vocab slice and whether its rows kept the batch's split.  The
    labels take every rank's first and last columns."""
    out = {}
    for case, (shape, lshape) in UNEVEN.items():
        mesh = _mesh(*shape)
        g = torch.Generator().manual_seed(lshape[-1])
        lg = torch.randn(lshape, generator=g, dtype=torch.float64)
        wt = torch.randn(lshape[:2], generator=g, dtype=torch.float64)
        V, n = lshape[-1], shape[1]
        labels = torch.randint(0, V, lshape[:2], generator=g)
        edges = sorted({c for r in range(n) for c in (
            step_mod._vocab_offset(V, n, r),
            step_mod._vocab_offset(V, n, r + 1) - 1) if 0 <= c < V})
        labels.view(-1)[:len(edges)] = torch.tensor(edges)
        dl = common.distribute(labels, mesh, (Shard(0), Replicate()))
        err = {}
        for part, k in (("logsumexp", 0), ("labels", 1)):
            def fn(t, i):
                return step_mod._lse_and_label(t, i)[k]
            ref = lg.clone().requires_grad_()
            want = fn(ref, labels)
            (want * wt).sum().backward()
            live = common.distribute(lg, mesh, (Shard(0), Shard(2))) \
                .requires_grad_()
            got = fn(live, dl)
            (got * common.distribute(wt, mesh, got.placements)).sum() \
                .backward()
            err[part] = [float((_t(got) - want).detach().abs().max()),
                         float((_t(live.grad) - ref.grad).abs().max())]
        ref = lg.clone().requires_grad_()
        want = sum(step_mod._xent(ref, labels, 1e-4))
        want.backward()
        live = common.distribute(lg, mesh, (Shard(0), Shard(2))) \
            .requires_grad_()
        got = sum(step_mod._xent(live, dl, 1e-4))
        got.backward()
        err["xent"] = [float((_t(got) - want).detach().abs()),
                       float((_t(live.grad) - ref.grad).abs().max()
                             / ref.grad.abs().max())]
        lse = step_mod._lse_and_label(live, dl)[0]
        out[case] = {"err": err,
                     "vocab_split": step_mod._vocab_split(live)[0],
                     "slice": live.to_local().shape[-1],
                     "placements": _placed(lse),
                     "local_rows": lse.to_local().shape[0]}
    return out


def uneven_loss_ops() -> dict:
    """The loss forward and backward on (16, 8, 67) float32 logits split
    (data, model) on the (2, 2) mesh under ``graph_analysis.Recorder``:
    the most elements any op touches, beside a rank's logits shard at
    the ceil slice (8 rows of 34 columns)."""
    from repro_torch.core import graph_analysis
    mesh = _mesh()
    g = torch.Generator().manual_seed(67)
    lg = common.distribute(torch.randn(16, 8, 67, generator=g), mesh,
                           (Shard(0), Shard(2))).requires_grad_()
    labels = common.distribute(torch.randint(0, 67, (16, 8), generator=g),
                               mesh, (Shard(0), Replicate()))

    def loss():
        ce, z = step_mod._xent(lg, labels, 1e-4)
        (ce + z).backward()
    _, cap = graph_analysis.capture(loss)
    ops = cap.analysis.ops
    back = [o for o in ops if o.computation == "backward"]
    return {"shard": 8 * 8 * 34, "local": lg.to_local().numel(),
            "whole_rows": 8 * 8 * 67,
            "backward": max(_numel(o.shape) for o in back),
            "all": max(_numel(o.shape) for o in ops),
            "n_backward": len(back),
            "widest": max(ops, key=lambda o: _numel(o.shape)).name}


#: the loss's peak cases: a vocab that splits evenly over `model`'s 2
#: ranks and one that does not (34 + 33 columns)
PEAK_VOCABS = {"even": 64, "uneven": 67}
#: rows of a rank's vocab slice in one float32 chunk of the peak check
PEAK_CHUNK_ROWS = 4


def loss_peak() -> dict:
    """``_xent`` with its z-loss, forward and backward, on bf16 logits
    (16, 8, V) split (data, model) on the (2, 2) mesh and the labels of
    their first 7 positions, as ``loss_fn`` calls it, recorded by
    ``graph_analysis.capture`` with ``xent.CHUNK_BYTES`` cut to
    ``PEAK_CHUNK_ROWS`` rows of this rank's slice in float32, so that a
    shard takes 16 chunks: the peak of bytes allocated during the call
    less its arguments, beside the rank's bf16 logits shard and one
    float32 chunk, for each of ``PEAK_VOCABS``."""
    from repro_torch.core import graph_analysis
    from repro_torch.train import xent
    mesh = _mesh()
    out = {}
    for case, V in PEAK_VOCABS.items():
        g = torch.Generator().manual_seed(V)
        whole = common.distribute(
            torch.randn(16, 8, V, generator=g).bfloat16(), mesh,
            (Shard(0), Shard(2)))
        # a contiguous shard, as the head's matmul writes it
        local = whole.to_local().contiguous()
        lg = DTensor.from_local(local, mesh, whole.placements,
                                shape=whole.shape, stride=whole.stride()) \
            .requires_grad_()
        labels = common.distribute(torch.randint(0, V, (16, 8), generator=g),
                                   mesh, (Shard(0), Replicate()))
        chunk = PEAK_CHUNK_ROWS * local.shape[-1] * 4

        def loss(lg_, labels_):
            ce, z = step_mod._xent(lg_, labels_[:, :-1], 1e-4)
            (ce + z).backward()
        saved = xent.CHUNK_BYTES
        xent.CHUNK_BYTES = chunk
        try:
            _, cap = graph_analysis.capture(loss, lg, labels)
            chunks = len(list(xent._chunks(local, 7)))
        finally:
            xent.CHUNK_BYTES = saved
        out[case] = {"temp": cap.memory()["temp_bytes"],
                     "shard": local.numel() * local.element_size(),
                     "chunk": chunk, "chunks": chunks,
                     "grad": lg.grad.to_local().dtype == torch.bfloat16,
                     "at_peak": cap.live_at_peak[:4]}
    return out


def refuses_model_4() -> str:
    """The reduced granite's forward on (1, 4): its 2 kv heads do not
    split over 4 ranks; returns the error's message."""
    cfg = _granite()
    model = LM(cfg)
    recs = model.param_recs()
    rule = cell.rule_for(cfg, SHAPE, multi_pod=False)
    mesh = _mesh(1, 4)
    params = common.materialize(recs, torch.Generator().manual_seed(0),
                                shardings=cell.shard(
                                    mesh, common.spec_tree(recs, rule)))
    batch = {"tokens": common.distribute(
        torch.zeros(4, 64, dtype=torch.long), mesh, cell.shard(
            mesh, cell.batch_specs(cfg, SHAPE, rule))["tokens"].placements)}
    try:
        model.forward(params, batch, rule=rule)
    except ValueError as e:
        return str(e)
    return "no error"


def group4(jdir: str, npz: str, jax_ckpt: str, work: str,
           archs: list) -> dict:
    """Everything the (2, 2) mesh runs, in one group of 4 ranks, with
    each part's seconds."""
    work = pathlib.Path(work)
    parts = {"step": lambda: sharded_step(jdir, npz, str(work / "port_params"),
                                          "bfloat16"),
             "step_f32": lambda: sharded_step(jdir, npz, None, "float32"),
             "forwards": lambda: sharded_forwards(archs),
             "elastic": lambda: elastic(str(work / "elastic"), jax_ckpt),
             "trainer": lambda: trainer_on_mesh(str(work / "trainer")),
             "refusal": refuses_model_4,
             "einsums": einsums,
             "escapes": escapes,
             "loss_ops": loss_ops,
             "mtp_loss": mtp_loss,
             "ssd_heads": ssd_heads,
             "scan_ops": scan_ops,
             "uneven_loss": uneven_loss,
             "uneven_loss_ops": uneven_loss_ops,
             "loss_peak": loss_peak,
             "mamba2_loss": lambda: sharded_loss("mamba2-2.7b", vocab=515),
             "zamba2_loss": lambda: sharded_loss("zamba2-7b")}
    out, seconds = {}, {}
    for name, run in parts.items():
        t0 = time.perf_counter()
        out[name] = run()
        seconds[name] = time.perf_counter() - t0
    return {**out, "seconds": seconds}
