"""Plain reference of Zamba2 as published (zamba2-7b's family, arXiv:
2411.15242; ``Zamba2ForCausalLM`` in ``transformers``'
``models/zamba2/modeling_zamba2.py``): a stack of Mamba-2 layers with B
and C in groups, and before each layer that the configuration's
``hybrid_layer_ids`` lists, an invocation of one of ``n_mem_blocks``
weight-shared transformer blocks in turn.

With e the tokens' embedding and h = e, layer i is

- at invocation j of block k = j mod n_mem_blocks: u = concat(h, e);
  a = RMSNorm(u); q, k, v = a·W (heads of ``head_dim`` over 2·d), rotary
  over the whole head; o = causal softmax(q·kᵀ·(head_dim/2)^-1/2)·v, then
  o·W_o (to d); m = RMSNorm(o); [g | w] = m·W_gate|up + (m·A_j)·B_j;
  t = (gelu(g) ⊙ w)·W_down (exact erf GELU); τ = t·L_j; x = h + τ (no
  residual inside the block);
- elsewhere x = h;
- then h ← h + Mamba2(RMSNorm(x)): the input projection to z, x, B, C
  (G groups of N each) and dt; a causal depthwise conv with bias and
  SiLU over x|B|C; dt = softplus(dt + dt_bias), A = −exp(A_log); the
  SSD scan, each head with its group's B and C; y + D·x; y·SiLU(z)
  RMS-normalised within each group; the output projection.

Then the final RMS norm, the tied head and the loss on the first s − 1
positions.  Every norm takes ``norm_eps``.  Float32 throughout, products
through ``Ops``; each layer is recomputed in the backward, and so are
each group's scan and each row's shared block inside it, so that a
layer's transient fits beside the optimizer's state.

The parameter tree is laid out as the program takes it: ``embed``,
``final_ln``, a stage of Mamba-2 layers from each invocation to the next
(each leaf stacking its stage's layers on its first axis, so that no
leaf, and no temporary of the optimizer's step over it, holds more than
one stage), ``shared`` (one entry a block) and ``adapters`` (one entry
an invocation).

Where it departs from ``modeling_zamba2.py``:

- gains are stored centred on zero (``x / rms(x) · (1 + gain)``), where
  the published ones are stored as they multiply;
- the head is the embedding (``tie_word_embeddings``, the config's
  default) and the embedding's rows are padded to a multiple of 128, the
  padding never read;
- dt is not clamped at ``time_step_min``: the published naive path
  clamps it, the fused path it runs on a card (``time_step_limit`` null)
  does not;
- the softmax scale is folded into q in float32 (by sqrt(2)), since the
  blocked attention of ``common`` scales by 1/sqrt(head_dim);
- the shared block runs one row of the batch at a time; the scan in the
  paper's minimal chunked form (``ssm.ssd``) on each group's heads;
- the in-projection is held as three weights (z|x, B|C, dt) and the
  MLP's gate|up as two, the published fused ones split by columns.

Initial values: projections N(0, 1/fan_in), the conv N(0, 1/width), the
adapters' two factors N(0, 1/d) and N(0, 1/rank), A = −a with a uniform
in [1, 16], dt's bias the inverse softplus of a step log-uniform in
[1e-3, 1e-1], D = 1, gains 0.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import CausalAttention, Ops, causal_conv, rms_norm, rotary
from .ssm import ssd


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab"] // 128) * 128


def _sizes(cfg: dict) -> tuple[int, int, int, int, int, int]:
    """(d, d_inner, Mamba heads, groups, state, conv width)."""
    s = cfg["ssm"]
    d = cfg["d_model"]
    din = s["expand"] * d
    return d, din, din // s["headdim"], s["n_groups"], s["d_state"], \
        s["conv_width"]


def stages(cfg: dict) -> list[tuple[int, int]]:
    """(first layer, layers) of each stage: the layers from each
    invocation to the next, and those before the first."""
    cuts = sorted({0, *cfg["hybrid_layer_ids"], cfg["n_layers"]})
    return [(a, b - a) for a, b in zip(cuts, cuts[1:])]


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(path, shape, init, scale) of every leaf in drawing order:
    ``normal`` N(0, 1) times ``scale``, ``zeros``, ``ones``, and the two
    uniform draws ``a_log`` and ``dt_bias`` (module docstring)."""
    d, din, h, G, N, w = _sizes(cfg)
    gn = G * N
    H, hd, ff, r = cfg["n_heads"], cfg["head_dim"], cfg["d_ff"], \
        cfg["adapter_rank"]
    out = [
        ("embed", (padded_vocab(cfg), d), "normal", d ** -0.5),
        ("final_ln", (d,), "zeros", 0.0),
    ]
    for s, (_, n) in enumerate(stages(cfg)):
        b = f"stages[{s}].blocks[0]."
        out += [
            (b + "A_log", (n, h), "a_log", 0.0),
            (b + "D", (n, h), "ones", 0.0),
            (b + "conv_b", (n, din + 2 * gn), "zeros", 0.0),
            (b + "conv_w", (n, w, din + 2 * gn), "normal", w ** -0.5),
            (b + "dt_bias", (n, h), "dt_bias", 0.0),
            (b + "gate_ln", (n, din), "zeros", 0.0),
            (b + "ln", (n, d), "zeros", 0.0),
            (b + "w_in_bc", (n, d, 2 * gn), "normal", d ** -0.5),
            (b + "w_in_dt", (n, d, h), "normal", d ** -0.5),
            (b + "w_in_zx", (n, d, 2 * din), "normal", d ** -0.5),
            (b + "w_out", (n, din, d), "normal", din ** -0.5),
        ]
    for k in range(cfg["n_mem_blocks"]):
        a, m = f"shared[{k}].attn.", f"shared[{k}].mlp."
        out += [
            (a + "ln", (2 * d,), "zeros", 0.0),
            (a + "wq", (2 * d, H, hd), "normal", (2 * d) ** -0.5),
            (a + "wk", (2 * d, H, hd), "normal", (2 * d) ** -0.5),
            (a + "wv", (2 * d, H, hd), "normal", (2 * d) ** -0.5),
            (a + "wo", (H, hd, d), "normal", (H * hd) ** -0.5),
            (m + "ln", (d,), "zeros", 0.0),
            (m + "w_gate", (d, ff), "normal", d ** -0.5),
            (m + "w_up", (d, ff), "normal", d ** -0.5),
            (m + "w_out", (ff, d), "normal", ff ** -0.5),
        ]
    for j in range(len(cfg["hybrid_layer_ids"])):
        p = f"adapters[{j}]."
        out += [
            (p + "a_in", (d, r), "normal", d ** -0.5),
            (p + "a_out", (r, 2 * ff), "normal", r ** -0.5),
            (p + "linear", (d, d), "normal", d ** -0.5),
        ]
    return out


def _attention(u, p: dict, cfg: dict, ops: Ops):
    """The shared block's attention over u = concat(h, e), back to d."""
    eps = cfg["norm_eps"]
    a = rms_norm(u, p["ln"], eps)
    fold = math.sqrt(2.0)           # (hd / 2)^-1/2 = sqrt(2) · hd^-1/2
    q = rotary(ops.einsum("bsd,dnh->bsnh", a, p["wq"]), cfg["rope_theta"])
    k = rotary(ops.einsum("bsd,dnh->bsnh", a, p["wk"]), cfg["rope_theta"])
    v = ops.einsum("bsd,dnh->bsnh", a, p["wv"])
    q, k, v = (ops.r(t).transpose(1, 2).contiguous() for t in (q * fold, k, v))
    o = CausalAttention.apply(q, k, v).transpose(1, 2)
    return ops.einsum("bsnh,nhd->bsd", o, p["wo"])


def _shared_rows(h, e, p: dict, a: dict, cfg: dict, ops: Ops):
    """τ of one invocation: the block with the invocation's adapter, then
    its linear; one row of the batch at a time, each recomputed in the
    layer's backward on its own."""
    return torch.cat([checkpoint(_shared, h[i:i + 1], e[i:i + 1], p, a, cfg,
                                 ops, use_reentrant=False)
                      for i in range(h.shape[0])])


def _shared(h, e, p: dict, a: dict, cfg: dict, ops: Ops):
    o = _attention(torch.cat([h, e], dim=-1), p["attn"], cfg, ops)
    m = rms_norm(o, p["mlp"]["ln"], cfg["norm_eps"])
    ff = cfg["d_ff"]
    low = ops.einsum("bsd,dr->bsr", m, a["a_in"])
    g = ops.einsum("bsd,df->bsf", m, p["mlp"]["w_gate"]) + \
        ops.einsum("bsr,rf->bsf", low, a["a_out"][:, :ff])
    w = ops.einsum("bsd,df->bsf", m, p["mlp"]["w_up"]) + \
        ops.einsum("bsr,rf->bsf", low, a["a_out"][:, ff:])
    t = ops.einsum("bsf,fd->bsd", F.gelu(g) * w, p["mlp"]["w_out"])
    return ops.einsum("bsd,de->bse", t, a["linear"])


def _mamba(x, p: dict, cfg: dict, ops: Ops):
    """Mamba2(RMSNorm(x)), without the residual."""
    d, din, h, G, N, _ = _sizes(cfg)
    eps = cfg["norm_eps"]
    bsz, L, _ = x.shape
    P = cfg["ssm"]["headdim"]
    xn = rms_norm(x, p["ln"], eps)
    zx = ops.einsum("bsd,de->bse", xn, p["w_in_zx"])
    z, xin = zx[..., :din], zx[..., din:]
    bc = ops.einsum("bsd,de->bse", xn, p["w_in_bc"])
    dt = F.softplus(ops.einsum("bsd,dh->bsh", xn, p["w_in_dt"])
                    + p["dt_bias"])
    u = F.silu(causal_conv(torch.cat([xin, bc], dim=-1), p["conv_w"],
                           p["conv_b"]))
    xin = u[..., :din]
    B = u[..., din:din + G * N].reshape(bsz, L, G, N)
    C = u[..., din + G * N:].reshape(bsz, L, G, N)
    xh = xin.reshape(bsz, L, h, P)
    A = -torch.exp(p["A_log"])
    X, Ad = xh * dt[..., None], A * dt
    hg, Q = h // G, min(cfg["ssm"]["chunk"], L)
    y = torch.cat([checkpoint(ssd, X[:, :, g * hg:(g + 1) * hg],
                              Ad[:, :, g * hg:(g + 1) * hg], B[:, :, g],
                              C[:, :, g], Q, use_reentrant=False)
                   for g in range(G)], dim=2)
    y = (y + p["D"][:, None] * xh).reshape(bsz, L, G, din // G)
    gated = y * F.silu(z).reshape(bsz, L, G, din // G)
    y = rms_norm(gated, p["gate_ln"].reshape(G, din // G), eps)
    return ops.einsum("bse,ed->bsd", y.reshape(bsz, L, din), p["w_out"])


def _layer(h, e, mamba: dict, shared, adapter, cfg: dict, ops: Ops):
    x = h if shared is None else \
        h + _shared_rows(h, e, shared, adapter, cfg, ops)
    return h + _mamba(x, mamba, cfg, ops)


def hidden(params, tokens, ops: Ops, cfg: dict):
    """The last layer's output (b, s, d), before the final norm."""
    ids = list(cfg["hybrid_layer_ids"])
    e = params["embed"][tokens]
    h = e
    for s, (first, n) in enumerate(stages(cfg)):
        stack = params["stages"][s]["blocks"][0]
        for i in range(n):
            shared = adapter = None
            if first + i in ids:
                j = ids.index(first + i)
                shared = params["shared"][j % cfg["n_mem_blocks"]]
                adapter = params["adapters"][j]
            mamba = {key: t[i] for key, t in stack.items()}
            h = checkpoint(_layer, h, e, mamba, shared, adapter, cfg, ops,
                           use_reentrant=False)
    return h


def _head_chunk(x, final_ln, embed, labels, vocab: int, eps: float,
                ops: Ops):
    """Sums over the rows of one chunk: (cross-entropy, lse²)."""
    h = rms_norm(x, final_ln, eps)
    logits = ops.einsum("nd,vd->nv", h, embed[:vocab])
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[:, None])[:, 0]
    return (lse - ll).sum(), lse.square().sum()


def logits(params, tokens, ops: Ops, cfg: dict):
    """The tied head's logits over the vocabulary, (b, s, vocab)."""
    x = rms_norm(hidden(params, tokens, ops, cfg), params["final_ln"],
                 cfg["norm_eps"])
    return ops.einsum("bsd,vd->bsv", x, params["embed"][:cfg["vocab"]])


def loss(params, tokens, labels, ops: Ops, cfg: dict, train: dict,
         rows: int = 2048):
    """The training loss of one microbatch (tokens, labels (b, s)): the
    mean cross-entropy plus ``z_loss`` times the mean squared log-sum-exp
    over the first s − 1 positions, the head in row chunks, each
    recomputed in the backward."""
    x = hidden(params, tokens, ops, cfg)[:, :-1]
    xf = x.reshape(-1, x.shape[-1])
    lf = labels[:, :-1].reshape(-1)
    ce = zz = 0.0
    for i in range(0, xf.shape[0], rows):
        c, z = checkpoint(_head_chunk, xf[i:i + rows], params["final_ln"],
                          params["embed"], lf[i:i + rows], cfg["vocab"],
                          cfg["norm_eps"], ops, use_reentrant=False)
        ce, zz = ce + c, zz + z
    n = xf.shape[0]
    return ce / n + train["z_loss"] * zz / n
