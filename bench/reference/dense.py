"""Plain reference of a dense decoder (granite-8b's family): pre-norm
blocks of grouped-query causal attention with rotary embedding and a
SwiGLU MLP, RMS norms with zero-centred gains, a tied embedding and
head, the loss on the first s - 1 positions.

The parameter tree is laid out as the program takes it: ``embed`` (the
vocabulary padded to a multiple of 128), ``final_ln``, and one stage of
blocks [attention, MLP], each leaf stacking the layers on its first
axis.  Each layer is recomputed in the backward, so the reference holds
one layer's activations at a time.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import CausalAttention, Ops, head_loss, rms_norm, rotary


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab"] // 128) * 128


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(path, shape, init, scale) of every leaf, in the order the
    weights are drawn: ``normal`` leaves N(0, 1) times ``scale`` (one
    over the square root of the fan-in), ``zeros`` gains."""
    n, d, h, kv = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], \
        cfg["n_kv_heads"]
    hd, ff = cfg["head_dim"], cfg["d_ff"]
    a, m = "stages[0].blocks[0].", "stages[0].blocks[1]."
    return [
        ("embed", (padded_vocab(cfg), d), "normal", d ** -0.5),
        ("final_ln", (d,), "zeros", 0.0),
        (a + "ln", (n, d), "zeros", 0.0),
        (a + "wq", (n, d, h, hd), "normal", d ** -0.5),
        (a + "wk", (n, d, kv, hd), "normal", d ** -0.5),
        (a + "wv", (n, d, kv, hd), "normal", d ** -0.5),
        (a + "wo", (n, h, hd, d), "normal", (h * hd) ** -0.5),
        (m + "ln", (n, d), "zeros", 0.0),
        (m + "w_gate", (n, d, ff), "normal", d ** -0.5),
        (m + "w_up", (n, d, ff), "normal", d ** -0.5),
        (m + "w_out", (n, ff, d), "normal", ff ** -0.5),
    ]


def _layer(x, ln1, wq, wk, wv, wo, ln2, wg, wu, wd, theta: float,
           ops: Ops):
    xn = rms_norm(x, ln1)
    q = rotary(ops.einsum("bsd,dnh->bsnh", xn, wq), theta)
    k = rotary(ops.einsum("bsd,dnh->bsnh", xn, wk), theta)
    v = ops.einsum("bsd,dnh->bsnh", xn, wv)
    g = q.shape[2] // k.shape[2]          # query head n reads kv head n // g
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    o = CausalAttention.apply(*(ops.r(t).transpose(1, 2).contiguous()
                                for t in (q, k, v))).transpose(1, 2)
    x = x + ops.einsum("bsnh,nhd->bsd", o, wo)
    xn = rms_norm(x, ln2)
    hid = F.silu(ops.einsum("bsd,df->bsf", xn, wg)) \
        * ops.einsum("bsd,df->bsf", xn, wu)
    return x + ops.einsum("bsf,fd->bsd", hid, wd)


def loss(params, tokens, labels, ops: Ops, cfg: dict, train: dict):
    """The training loss of one microbatch (tokens, labels (b, s))."""
    blocks = params["stages"][0]["blocks"]
    at, mlp = blocks[0], blocks[1]
    x = params["embed"][tokens]
    for i in range(cfg["n_layers"]):
        x = checkpoint(_layer, x, at["ln"][i], at["wq"][i], at["wk"][i],
                       at["wv"][i], at["wo"][i], mlp["ln"][i],
                       mlp["w_gate"][i], mlp["w_up"][i], mlp["w_out"][i],
                       cfg["rope_theta"], ops, use_reentrant=False)
    return head_loss(x[:, :-1], params["final_ln"], params["embed"],
                     labels[:, :-1], cfg["vocab"], train["z_loss"], ops)
