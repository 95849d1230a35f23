"""The plain references against the port at tiny sizes on the CPU: the
loss and every gradient in float32, the SSD scan alone, the blocked
attention against a dense one, and three whole training steps."""
from __future__ import annotations

import functools

import pytest
import torch

from bench import harness, weights
from bench.reference import common, dense, ssm

TINY = {
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=96, vocab=300),
    "ssm": dict(n_layers=2, d_model=64, vocab=300),
}
TRAIN = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
         "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 100,
         "total_steps": 10000, "z_loss": 1e-4}


def tiny_model(family: str, **kw) -> dict:
    if family == "dense":
        m = {"family": "dense", "rope_theta": 10000.0, "act": "swiglu",
             "norm": "rmsnorm", "tp": 1, "act_dtype": "float32",
             **TINY["dense"]}
    else:
        m = {"family": "ssm", "n_heads": 8, "n_kv_heads": 8, "head_dim": 16,
             "d_ff": 0, "norm": "rmsnorm", "tp": 1, "act_dtype": "float32",
             "ssm": {"d_state": 16, "headdim": 16, "expand": 2, "chunk": 16,
                     "conv_width": 4, "n_groups": 1}, **TINY["ssm"]}
    m.update(kw)
    return m


def batch(vocab: int, b: int, s: int, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, vocab, (b, s), generator=g)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}


def program_grads(model_cfg: dict, params, b: dict):
    from repro_torch.models.lm import LM
    from repro_torch.train.step import TrainConfig, loss_fn
    from repro_torch.models.common import tmap
    model = LM(harness.arch_config(model_cfg))
    live = tmap(lambda t: t.detach().clone().requires_grad_(), params)
    loss, _ = loss_fn(model, live, b, tcfg=TrainConfig(z_loss=TRAIN["z_loss"]),
                      remat=True)
    loss.backward()
    return float(loss), dict(common.leaves(tmap(lambda t: t.grad, live)))


def reference_grads(family, model_cfg: dict, params, b: dict):
    tree = common._tmap(lambda t: t.detach().clone().requires_grad_(),
                        params)
    loss = family.loss(tree, b["tokens"], b["labels"], common.Ops("fp32"),
                       cfg=model_cfg, train=TRAIN)
    loss.backward()
    return float(loss), dict(common.leaves(common._tmap(lambda t: t.grad,
                                                        tree)))


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_loss_and_gradients_match_the_port_in_float32(family):
    mod = {"dense": dense, "ssm": ssm}[family]
    cfg = tiny_model(family)
    params = weights.draw(mod.layout(cfg), 11, "cpu", dtype=torch.float32)
    b = batch(cfg["vocab"], 2, 48, 3)
    lp, gp = program_grads(cfg, params, b)
    lr, gr = reference_grads(mod, cfg, params, b)
    assert abs(lp - lr) <= 1e-5 * abs(lr)
    assert set(gp) == set(gr)
    for name in gr:
        top = float(gr[name].abs().max())
        err = float((gp[name] - gr[name]).abs().max())
        assert err <= 1e-4 * max(top, 1e-6), (name, err, top)


def test_ssd_matches_the_recurrence():
    """The chunked form against the plain recurrence, one step at a time,
    across several chunks."""
    g = torch.Generator().manual_seed(5)
    b, L, h, p, n = 2, 48, 3, 4, 5
    X = torch.randn(b, L, h, p, generator=g, dtype=torch.float64)
    A = -torch.rand(b, L, h, generator=g, dtype=torch.float64) * 0.3
    B = torch.randn(b, L, n, generator=g, dtype=torch.float64)
    C = torch.randn(b, L, n, generator=g, dtype=torch.float64)
    y = ssm.ssd(X, A, B, C, 16)
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    ys = []
    for t in range(L):
        state = state * torch.exp(A[:, t])[..., None, None] + \
            X[:, t, :, :, None] * B[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    assert torch.allclose(y, torch.stack(ys, 1), atol=1e-10, rtol=1e-10)


def test_blocked_attention_matches_dense_with_its_gradient():
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(1, 2, 300, 8, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    out = common.CausalAttention.apply(q, k, v)
    s = q @ k.transpose(-1, -2) / 8 ** 0.5
    s = s.masked_fill(~torch.ones(300, 300, dtype=torch.bool).tril(), -1e30)
    want = torch.softmax(s, -1) @ v
    assert torch.allclose(out, want, atol=1e-12)
    go = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), go)
    ref = torch.autograd.grad(want, (q, k, v), go)
    for a, b_ in zip(got, ref):
        assert torch.allclose(a, b_, atol=1e-10)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_three_steps_match_the_port_in_float32(family):
    """The port's ``make_train_step`` (two microbatches) against the
    reference's ``follow``: every number the check reads agrees."""
    from repro_torch.models.lm import LM
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train.step import TrainConfig, make_train_step
    from bench import check
    mod = {"dense": dense, "ssm": ssm}[family]
    cfg = tiny_model(family)
    params = weights.draw(mod.layout(cfg), 5, "cpu", dtype=torch.float32)
    start = common._tmap(lambda t: t.clone(), params)
    batches = [batch(cfg["vocab"], 2, 32, i) for i in range(3)]
    t = TRAIN
    tcfg = TrainConfig(opt=OptConfig(lr=t["lr"], b1=t["b1"], b2=t["b2"],
                                     eps=t["eps"],
                                     weight_decay=t["weight_decay"],
                                     clip_norm=t["clip_norm"]),
                       microbatches=2, z_loss=t["z_loss"],
                       warmup_steps=t["warmup_steps"],
                       total_steps=t["total_steps"])
    step_fn = make_train_step(LM(harness.arch_config(cfg)), tcfg)
    opt = adamw_init(params, tcfg.opt)
    losses = []
    for i in range(3):
        params, opt, m = step_fn(params, opt, batches[i], i)
        losses.append(float(m["loss"]))
        if i == 0:
            grad = {k: v / (1.0 - t["b1"]) for k, v in
                    common.slice_norms(opt["m"]).items()}
    change = {n: float(torch.linalg.vector_norm(a - b)) for (n, a), (_, b)
              in zip(common.layer_slices(opt["master"]),
                     common.layer_slices(start))}
    ref = common.follow(functools.partial(mod.loss, cfg=cfg, train=TRAIN),
                        start, batches, TRAIN, 2, 3, common.Ops("fp32"))
    got = check.readings({"loss": losses, "grad": grad, "change": change},
                         ref)
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-4
    assert got["change_gap"] < 1e-3
