"""Plain reference of a Mamba-2 language model (mamba2-2.7b's family):
pre-norm Mamba-2 blocks [arXiv:2405.21060] with the SSD scan in the
paper's own minimal chunked form (``ssd_minimal_discrete``: the
diagonal blocks as masked products, the chunk states, and the
recurrence between chunks through the segment sums), RMS norms with
zero-centred gains, a tied embedding and head, the loss on the first
s - 1 positions.

The parameter tree is laid out as the program takes it: ``embed``,
``final_ln`` and one stage of Mamba-2 blocks, each leaf stacking the
layers on its first axis.  Initial values follow the paper's
reference code: A = -a with a uniform in [1, 16] (``A_log`` = log a),
``dt_bias`` the inverse softplus of a step log-uniform in [1e-3, 1e-1],
D = 1.  Each layer is recomputed in the backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Ops, causal_conv, head_loss, rms_norm


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab"] // 128) * 128


def _sizes(cfg: dict) -> tuple[int, int, int, int, int]:
    s = cfg["ssm"]
    d = cfg["d_model"]
    din = s["expand"] * d
    return d, din, din // s["headdim"], s["d_state"] * s["n_groups"], \
        s["conv_width"]


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(path, shape, init, scale) of every leaf in drawing order:
    ``normal`` N(0, 1) times ``scale``, ``zeros``, ``ones``, and the two
    uniform draws ``a_log`` and ``dt_bias`` (module docstring)."""
    n = cfg["n_layers"]
    d, din, h, gn, w = _sizes(cfg)
    b = "stages[0].blocks[0]."
    return [
        ("embed", (padded_vocab(cfg), d), "normal", d ** -0.5),
        ("final_ln", (d,), "zeros", 0.0),
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


def segsum(x):
    """out[..., i, j] = x[..., j+1] + ... + x[..., i] for j <= i, -inf
    above the diagonal."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    low = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~low, 0.0)
    out = torch.cumsum(x, dim=-2)
    diag = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~diag, float("-inf"))


def ssd(X, A, B, C, chunk: int):
    """The paper's minimal SSD: X (b, L, h, p) the inputs times their
    step, A (b, L, h) the log-decays, B and C (b, L, n) shared by the
    heads.  Returns Y (b, L, h, p), starting from a zero state."""
    b, L, h, p = X.shape
    c = L // chunk
    X = X.reshape(b, c, chunk, h, p)
    B = B.reshape(b, c, chunk, -1)
    C = C.reshape(b, c, chunk, -1)
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)        # (b, h, c, l)
    a_cum = torch.cumsum(A, dim=-1)
    # 1. the diagonal blocks: within each chunk
    decay = torch.exp(segsum(A))                              # (b,h,c,l,s)
    scores = torch.einsum("bcln,bcsn->bcls", C, B)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", decay * scores[:, None], X)
    # 2. each chunk's state, from its own inputs
    to_end = torch.exp(a_cum[..., -1:] - a_cum)               # (b, h, c, l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", B, to_end, X)
    # 3. the recurrence between chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    # 4. each chunk's output from the state it starts with
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", C, states,
                         torch.exp(a_cum))
    return (y_diag + y_off).reshape(b, L, h, p)


def _layer(x, ln, w_zx, w_bc, w_dt, dt_bias, conv_w, conv_b, a_log, dd,
           gate_ln, w_out, cfg: dict, ops: Ops):
    d, din, h, gn, _ = _sizes(cfg)
    bsz, L, _ = x.shape
    P = cfg["ssm"]["headdim"]
    xn = rms_norm(x, ln)
    zx = ops.einsum("bsd,de->bse", xn, w_zx)
    z, xin = zx[..., :din], zx[..., din:]
    bc = ops.einsum("bsd,de->bse", xn, w_bc)
    dt = F.softplus(ops.einsum("bsd,dh->bsh", xn, w_dt) + dt_bias)
    u = F.silu(causal_conv(torch.cat([xin, bc], dim=-1), conv_w, conv_b))
    xin, B, C = u[..., :din], u[..., din:din + gn], u[..., din + gn:]
    xh = xin.reshape(bsz, L, h, P)
    A = -torch.exp(a_log)
    y = ssd(xh * dt[..., None], A * dt, B, C, min(cfg["ssm"]["chunk"], L))
    y = (y + dd[:, None] * xh).reshape(bsz, L, din)
    y = rms_norm(y * F.silu(z), gate_ln)
    return x + ops.einsum("bse,ed->bsd", y, w_out)


def loss(params, tokens, labels, ops: Ops, cfg: dict, train: dict):
    """The training loss of one microbatch (tokens, labels (b, s))."""
    p = params["stages"][0]["blocks"][0]
    x = params["embed"][tokens]
    for i in range(cfg["n_layers"]):
        x = checkpoint(_layer, x, p["ln"][i], p["w_in_zx"][i],
                       p["w_in_bc"][i], p["w_in_dt"][i], p["dt_bias"][i],
                       p["conv_w"][i], p["conv_b"][i], p["A_log"][i],
                       p["D"][i], p["gate_ln"][i], p["w_out"][i], cfg, ops,
                       use_reentrant=False)
    return head_loss(x[:, :-1], params["final_ln"], params["embed"],
                     labels[:, :-1], cfg["vocab"], train["z_loss"], ops)
