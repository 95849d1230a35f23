"""Mamba-2 block via the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060].

Counterpart of ``repro.models.mamba2``, in plain PyTorch as the JAX
package computes it outside any kernel: within a chunk the dual quadratic
(attention-like) form, across chunks a loop carrying the (heads, headdim,
state) recurrent state in float32; decode is the one-step recurrence.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import PRec, einsum, rms_norm


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


def mamba2_recs(cfg) -> dict[str, PRec]:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    din = s.d_inner(d)
    h = s.n_heads(d)
    gn = s.n_groups * s.d_state
    conv_ch = din + 2 * gn
    return {
        "ln": PRec((d,), ("embed",), init="zeros"),
        "w_in_zx": PRec((d, 2 * din), ("embed", "inner")),
        "w_in_bc": PRec((d, 2 * gn), ("embed", None)),
        "w_in_dt": PRec((d, h), ("embed", "heads")),
        "dt_bias": PRec((h,), ("heads",), init="zeros"),
        "conv_w": PRec((s.conv_width, conv_ch), ("conv", "inner"),
                       scale=s.conv_width ** -0.5),
        "conv_b": PRec((conv_ch,), ("inner",), init="zeros"),
        "A_log": PRec((h,), ("heads",), init="zeros"),
        "D": PRec((h,), ("heads",), init="ones"),
        "gate_ln": PRec((din,), ("inner",), init="zeros"),
        "w_out": PRec((din, d), ("inner", "embed"), scale=din ** -0.5),
    }


def _causal_conv(u, w, b, state=None):
    """Depthwise causal conv, width W.  u: (b, s, ch), w: (W, ch).
    state: (b, W-1, ch) carry for decode.  Returns (out, new_state)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros(u.shape[:1] + (W - 1,) + u.shape[2:],
                          dtype=u.dtype, device=u.device)
    else:
        pad = state
    dt = torch.promote_types(pad.dtype, u.dtype)
    full = torch.cat([pad.to(dt), u.to(dt)], dim=1)
    out = sum(full[:, i:i + u.shape[1]] * w[i] for i in range(W)) + b
    new_state = full[:, -(W - 1):] if W > 1 else pad
    return F.silu(out), new_state


def _split_proj(p, xn, s: SSMConfig, d):
    din = s.d_inner(d)
    gn = s.n_groups * s.d_state
    zx = einsum("bsd,de->bse", xn, p["w_in_zx"])
    z, xin = zx[..., :din], zx[..., din:]
    bc = einsum("bsd,de->bse", xn, p["w_in_bc"])
    dt = F.softplus(einsum("bsd,dh->bsh", xn, p["w_in_dt"]).float()
                    + p["dt_bias"].float())
    return z, xin, bc, dt, gn


def mamba2_apply(p, x, cfg, cache=None, pos=None):
    """Returns (delta_x, new_cache); cache = {'ssm': (b,h,p,n), 'conv':
    (b, W-1, ch)}.  Training/prefill runs the chunked SSD scan (the length
    must be a multiple of the chunk, or shorter than one); decode the
    one-step recurrence."""
    s: SSMConfig = cfg.ssm
    b, L, d = x.shape
    h, P, N = s.n_heads(d), s.headdim, s.d_state
    xn = rms_norm(x, p["ln"])
    z, xin, bc, dt, gn = _split_proj(p, xn, s, d)

    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, p["conv_w"], p["conv_b"],
        None if cache is None else cache["conv"])
    din = s.d_inner(d)
    xin, bc = conv_out[..., :din], conv_out[..., din:]
    B = bc[..., :gn].reshape(b, L, s.n_groups, N)[:, :, 0]     # g=1: (b,L,N)
    C = bc[..., gn:].reshape(b, L, s.n_groups, N)[:, :, 0]
    xh = xin.reshape(b, L, h, P)
    A = -torch.exp(p["A_log"].float())                          # (h,)
    l_t = A[None, None, :] * dt                                 # (b,L,h)
    Dp = p["D"].float()[:, None]

    if cache is not None and L == 1:  # ---- decode: one recurrent step ----
        st = cache["ssm"]                                       # (b,h,P,N)
        a = torch.exp(l_t[:, 0])                                # (b,h)
        dx = dt[:, 0][..., None] * xh[:, 0].float()             # (b,h,P)
        st = st * a[..., None, None] + einsum(
            "bhp,bn->bhpn", dx, B[:, 0].float())
        y = einsum("bhpn,bn->bhp", st, C[:, 0].float())
        y = y + Dp * xh[:, 0].float()
        y = y.reshape(b, 1, h * P).to(x.dtype)
        cache = {"ssm": st, "conv": conv_state}
    else:  # ---------------- chunked SSD ------------------------------
        Q = min(s.chunk, L)
        assert L % Q == 0, (L, Q)
        nc = L // Q
        xc = xh.reshape(b, nc, Q, h, P)
        Bc = B.reshape(b, nc, Q, N)
        Cc = C.reshape(b, nc, Q, N)
        dtc = dt.reshape(b, nc, Q, h)
        Lcum = l_t.reshape(b, nc, Q, h).cumsum(dim=2)            # (b,nc,Q,h)
        mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                     device=x.device))
        state = (torch.zeros(b, h, P, N, dtype=torch.float32,
                             device=x.device) if cache is None
                 else cache["ssm"])
        ys = []
        for c in range(nc):
            xq, Bq, Cq = xc[:, c], Bc[:, c], Cc[:, c]
            dtq, Lq = dtc[:, c], Lcum[:, c]
            scores = einsum("bln,bmn->blm", Cq, Bq).float()
            gamma = torch.exp(torch.clamp(
                Lq[:, :, None, :] - Lq[:, None, :, :], -60.0, 0.0))
            gamma = torch.where(mask[None, :, :, None], gamma, 0.0)
            M = scores[..., None] * gamma * dtq[:, None, :, :]  # (b,l,m,h)
            xf = xq.float()
            y_intra = einsum("blmh,bmhp->blhp", M, xf)
            y_inter = einsum("blh,bln,bhpn->blhp", torch.exp(Lq),
                             Cq.float(), state)
            w = dtq * torch.exp(Lq[:, -1:, :] - Lq)              # (b,l,h)
            s_chunk = einsum("blh,blhp,bln->bhpn", w, xf, Bq.float())
            state = state * torch.exp(Lq[:, -1])[..., None, None] + s_chunk
            ys.append(y_intra + y_inter)
        y = torch.stack(ys, dim=1).reshape(b, L, h, P)
        y = y + Dp * xh.float()
        y = y.reshape(b, L, h * P).to(x.dtype)
        if cache is not None:
            cache = {"ssm": state, "conv": conv_state}

    y = y * F.silu(z)
    y = rms_norm(y, p["gate_ln"])
    return einsum("bse,ed->bsd", y, p["w_out"]), cache


def mamba2_cache_shape(cfg, batch: int):
    """Cache shapes and types: the ssm state in float32, the conv window
    in bfloat16."""
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    h, P, N = s.n_heads(d), s.headdim, s.d_state
    conv_ch = s.d_inner(d) + 2 * s.n_groups * s.d_state
    return {"ssm": ((batch, h, P, N), torch.float32),
            "conv": ((batch, s.conv_width - 1, conv_ch), torch.bfloat16)}
