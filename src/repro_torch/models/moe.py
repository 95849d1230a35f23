"""Mixture-of-Experts FFN: top-k routing with static capacity, shared
experts, and DeepSeek-V3's aux-loss-free sigmoid routing with a learned
bias.

Counterpart of ``repro.models.moe``, with the same two dispatches: the
scatter dispatch in (token, k) pair space (the default) and the one-hot
einsum dispatch, kept for the equivalence test.  Capacity and routing
positions are computed within each of ``rule['moe_groups']`` token groups
(one group per data shard of the production mesh; one without a rule).

Under a rule the routing and both dispatches (top-k, the cumulative
positions, the scatter and the gather back) have no DTensor sharding
strategy and run on plain tensors (:func:`~repro_torch.models.common.
on_replicas`), each rank on its own rows of the batch where the groups
fall within them (the group count a multiple of the batch's shards),
else on the whole batch; the expert FFN between them runs on DTensors
constrained as JAX constrains them, experts over `model`.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import (PRec, constrain, einsum, on_replicas, rms_norm,
                     row_shards)
from .mlp import mlp_apply, mlp_recs


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    router: str = "softmax"     # 'softmax' | 'sigmoid_bias' (aux-loss-free)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


def moe_recs(cfg) -> dict[str, PRec]:
    m: MoEConfig = cfg.moe
    d, ff, e = cfg.d_model, m.d_ff_expert, m.n_experts
    recs = {
        "router": PRec((d, e), ("embed", None), dtype=torch.float32),
        "w_gate": PRec((e, d, ff), ("experts", "embed", "eff")),
        "w_up": PRec((e, d, ff), ("experts", "embed", "eff")),
        "w_out": PRec((e, ff, d), ("experts", "eff", "embed"),
                      scale=ff ** -0.5),
        "ln": PRec((d,), ("embed",), init="zeros"),
    }
    if m.router == "sigmoid_bias":
        recs["router_bias"] = PRec((e,), (None,), init="zeros",
                                   dtype=torch.float32)
    if m.n_shared:
        recs["shared"] = mlp_recs(cfg, d_ff=m.n_shared * ff)
    return recs


def _route(p, xt: torch.Tensor, m: MoEConfig):
    """Router: returns (weights (t, e), khot (t, e), idx (t, k))."""
    logits = einsum("td,de->te", xt.float(), p["router"])
    if m.router == "sigmoid_bias":
        # DeepSeek aux-loss-free: bias only affects selection, not weights
        gate_scores = torch.sigmoid(logits)
        sel_scores = gate_scores + p["router_bias"]
    else:
        sel_scores = logits
        gate_scores = torch.softmax(logits, dim=-1)
    idx = torch.topk(sel_scores, m.top_k, dim=-1).indices
    khot = F.one_hot(idx, m.n_experts).to(gate_scores.dtype).sum(1)
    weights = gate_scores * khot
    if m.router == "sigmoid_bias":                            # renormalize
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-9)
    return weights, khot, idx


def moe_apply(p, x: torch.Tensor, cfg, dispatch: str = "scatter",
              rule=None) -> torch.Tensor:
    """x: (b, s, d).  Static-capacity top-k dispatch, group-local: tokens
    split into ``rule['moe_groups']`` groups (one without a rule, or when
    that count does not divide the tokens), positions and
    capacity computed within each group; pairs past an expert's capacity
    are dropped.  ``dispatch='scatter'`` adds tokens
    into per-expert buffers and gathers them back; ``'einsum'`` builds the
    one-hot dispatch and combine tensors.  The two are numerically the
    same."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    t = b * s
    G = rule.get("moe_groups", 1) if rule is not None else 1
    if t % G:
        G = 1
    tg = t // G
    E, K = m.n_experts, m.top_k
    # floor 8: tiny decode groups otherwise drop colliding tokens
    capacity = max(min(8, tg), int(m.capacity_factor * K * tg / E))
    router = {k: p[k] for k in ("ln", "router", "router_bias") if k in p}
    # each rank routes its own rows where the groups fall within them
    n = row_shards(x)
    own = G % n == 0 and b % n == 0
    xin, comb = on_replicas(
        lambda r, x_: _dispatch(r, x_, m, tg, capacity, dispatch),
        router, x, rows=(1,) if own else ())

    xin = xin.transpose(0, 1)                                 # (e, G, c, d)
    if rule is not None:
        xin = constrain(xin, rule, ("act_experts", "batch", None, None))
    gt = einsum("egcd,edf->egcf", xin, p["w_gate"])
    u = einsum("egcd,edf->egcf", xin, p["w_up"])
    h = F.silu(gt) * u
    eout = einsum("egcf,efd->egcd", h, p["w_out"])
    if rule is not None:
        eout = constrain(eout, rule, ("act_experts", "batch", None, None))
    eout = eout.transpose(0, 1).to(x.dtype)
    out = on_replicas(
        lambda e, c: _combine(e, c, dispatch, capacity).reshape(-1, s, d),
        eout, comb, rows=(0, 1) if own else ())
    if m.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg, rule=rule)
    if rule is not None:
        out = constrain(out, rule, ("batch", "seq", "act_embed"))
    return out


def _dispatch(p, x, m: MoEConfig, tg: int, capacity: int, dispatch: str):
    """Route and dispatch ``x``'s tokens in groups of ``tg``: returns the
    per-expert buffers (G, e, c, d) and what the combine needs — the
    einsum's combine tensor, or the scatter's slots and per-pair
    weights."""
    b, s, d = x.shape
    G = b * s // tg
    E, K = m.n_experts, m.top_k
    xn = rms_norm(x, p["ln"])
    xt = xn.reshape(G, tg, d)
    weights, khot, idx = _route(p, xt.reshape(G * tg, d), m)
    weights = weights.reshape(G, tg, E)
    khot = khot.reshape(G, tg, E)
    idx = idx.reshape(G, tg, K)
    # position of each token within its expert's group-local buffer
    pos_te = (khot.cumsum(dim=1) - khot).long()               # (G, tg, e)

    if dispatch == "einsum":
        keep = (pos_te < capacity) & (khot > 0)
        disp = F.one_hot(torch.where(keep, pos_te, capacity),
                         capacity + 1)[..., :capacity].to(x.dtype)
        comb = disp * weights.to(x.dtype)[..., None]
        return einsum("gtec,gtd->gecd", disp, xt), comb
    # overflow pairs land in the per-expert spill slot (index `capacity`),
    # dropped afterwards
    pos_k = torch.take_along_dim(pos_te, idx, dim=2)           # (G, tg, k)
    keep_k = pos_k < capacity
    pos_k = torch.where(keep_k, pos_k, capacity)
    slot = (idx * (capacity + 1) + pos_k).reshape(G, tg * K)
    src = xt[:, :, None, :].expand(G, tg, K, d).reshape(G, tg * K, d)
    xin = torch.zeros(G, E * (capacity + 1), d, dtype=x.dtype,
                      device=x.device)
    xin.scatter_add_(1, slot[..., None].expand(G, tg * K, d), src)
    xin = xin.reshape(G, E, capacity + 1, d)[:, :, :capacity]
    w_k = (torch.take_along_dim(weights, idx, dim=2)
           * keep_k).to(x.dtype)                              # (G, tg, k)
    return xin, {"slot": slot, "w_k": w_k}


def _combine(eout, comb, dispatch: str, capacity: int):
    """Expert outputs (G, e, c, d) back to tokens (G, tg, d)."""
    G, E, _, d = eout.shape
    if dispatch == "einsum":
        return einsum("gecd,gtec->gtd", eout, comb)
    slot, w_k = comb["slot"], comb["w_k"]
    tg, K = w_k.shape[1], w_k.shape[2]
    pad = torch.zeros(G, E, 1, d, dtype=eout.dtype, device=eout.device)
    flat = torch.cat([eout, pad], dim=2).reshape(G, E * (capacity + 1), d)
    gathered = torch.take_along_dim(flat, slot[..., None], dim=1) \
        .reshape(G, tg, K, d)
    return einsum("gtkd,gtk->gtd", gathered, w_k)


def load_balance_stats(p, x: torch.Tensor, cfg) -> dict[str, torch.Tensor]:
    """Router entropy and load diagnostics (for logging)."""
    m = cfg.moe
    xt = rms_norm(x, p["ln"]).reshape(-1, cfg.d_model)
    logits = einsum("td,de->te", xt.float(), p["router"])
    load = torch.softmax(logits, dim=-1).mean(0)
    return {"router_entropy": -(load * torch.log(load + 1e-9)).sum(),
            "max_load": load.max() * m.n_experts}
