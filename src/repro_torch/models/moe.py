"""Mixture-of-Experts FFN: top-k routing with static capacity, shared
experts, and DeepSeek-V3's aux-loss-free sigmoid routing with a learned
bias.

Counterpart of ``repro.models.moe``, with the same two dispatches: the
scatter dispatch in (token, k) pair space (the default) and the one-hot
einsum dispatch, kept for the equivalence test.  Capacity and routing
positions are computed within each of ``groups`` token groups (JAX reads
the count from ``rule['moe_groups']``, one group per data shard; the port
takes it as an argument until distribution is ported).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import PRec, einsum, rms_norm
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
              groups: int = 1) -> torch.Tensor:
    """x: (b, s, d).  Static-capacity top-k dispatch, group-local: tokens
    split into ``groups`` groups (one group when that does not divide the
    tokens), positions and capacity computed within each group; pairs past
    an expert's capacity are dropped.  ``dispatch='scatter'`` adds tokens
    into per-expert buffers and gathers them back; ``'einsum'`` builds the
    one-hot dispatch and combine tensors.  The two are numerically the
    same."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    xn = rms_norm(x, p["ln"])
    t = b * s
    G = groups if t % groups == 0 else 1
    tg = t // G
    E, K = m.n_experts, m.top_k
    xt = xn.reshape(G, tg, d)
    weights, khot, idx = _route(p, xt.reshape(t, d), m)
    weights = weights.reshape(G, tg, E)
    khot = khot.reshape(G, tg, E)
    idx = idx.reshape(G, tg, K)

    # floor 8: tiny decode groups otherwise drop colliding tokens
    capacity = max(min(8, tg), int(m.capacity_factor * K * tg / E))
    # position of each token within its expert's group-local buffer
    pos_te = (khot.cumsum(dim=1) - khot).long()               # (G, tg, e)

    if dispatch == "einsum":
        keep = (pos_te < capacity) & (khot > 0)
        disp = F.one_hot(torch.where(keep, pos_te, capacity),
                         capacity + 1)[..., :capacity].to(x.dtype)
        comb = disp * weights.to(x.dtype)[..., None]
        xin = einsum("gtec,gtd->gecd", disp, xt)
    else:
        # overflow pairs land in the per-expert spill slot (index
        # `capacity`), dropped afterwards
        pos_k = torch.take_along_dim(pos_te, idx, dim=2)       # (G, tg, k)
        keep_k = pos_k < capacity
        pos_k = torch.where(keep_k, pos_k, capacity)
        slot = (idx * (capacity + 1) + pos_k).reshape(G, tg * K)
        src = xt[:, :, None, :].expand(G, tg, K, d).reshape(G, tg * K, d)
        xin = torch.zeros(G, E * (capacity + 1), d, dtype=x.dtype,
                          device=x.device)
        xin.scatter_add_(1, slot[..., None].expand(G, tg * K, d), src)
        xin = xin.reshape(G, E, capacity + 1, d)[:, :, :capacity]

    xin = xin.transpose(0, 1)                                 # (e, G, c, d)
    gt = einsum("egcd,edf->egcf", xin, p["w_gate"])
    u = einsum("egcd,edf->egcf", xin, p["w_up"])
    h = F.silu(gt) * u
    eout = einsum("egcf,efd->egcd", h, p["w_out"]).transpose(0, 1)
    eout = eout.to(x.dtype)
    if dispatch == "einsum":
        out = einsum("gecd,gtec->gtd", eout, comb)
    else:
        pad = torch.zeros(G, E, 1, d, dtype=eout.dtype, device=x.device)
        flat = torch.cat([eout, pad], dim=2).reshape(G, E * (capacity + 1), d)
        gathered = torch.take_along_dim(flat, slot[..., None], dim=1) \
            .reshape(G, tg, K, d)
        w_k = (torch.take_along_dim(weights, idx, dim=2)
               * keep_k).to(x.dtype)                          # (G, tg, k)
        out = einsum("gtkd,gtk->gtd", gathered, w_k)
    out = out.reshape(b, s, d)
    if m.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg)
    return out


def load_balance_stats(p, x: torch.Tensor, cfg) -> dict[str, torch.Tensor]:
    """Router entropy and load diagnostics (for logging)."""
    m = cfg.moe
    xt = rms_norm(x, p["ln"]).reshape(-1, cfg.d_model)
    logits = einsum("td,de->te", xt.float(), p["router"])
    load = torch.softmax(logits, dim=-1).mean(0)
    return {"router_entropy": -(load * torch.log(load + 1e-9)).sum(),
            "max_load": load.max() * m.n_experts}
