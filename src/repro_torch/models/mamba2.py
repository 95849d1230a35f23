"""Mamba-2 block via the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060].

Counterpart of ``repro.models.mamba2``: within a chunk the dual
quadratic (attention-like) form, across chunks a loop carrying the
(heads, headdim, state) recurrent state in float32, which the JAX package
computes in plain ``jnp`` and the port on the card in the SSD kernels
(``kernels/ssd_scan.py``; on the CPU the same plain loop); decode is the
one-step recurrence.
B and C come in ``n_groups`` groups (Mamba-2's ``ngroups``): head h reads
group h // (heads / n_groups), and the gated norm normalises each group's
d_inner / n_groups channels on their own.  One group keeps the (b, L, N)
operands and the whole-width norm the port has always used.
Under a sharding rule the chunked scan runs on plain tensors, each rank
on its own rows of the batch and its own heads, where the heads split
evenly over the mesh dim ``act_heads`` names, else with every head
(:func:`~repro_torch.models.common.on_replicas`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import obs
from ..kernels import ssd_scan
from .common import PRec, constrain, einsum, on_replicas, rms_norm


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
    return z, xin, bc, _step_sizes(p, xn), gn


def _step_sizes(p, xn):
    """dt, (b, s, h): softplus of the dt projection plus its bias, in
    float32."""
    return F.softplus(einsum("bsd,dh->bsh", xn, p["w_in_dt"]).float()
                      + p["dt_bias"].float())


def _inner_sharded(p, xn, s: SSMConfig, d: int, rule):
    """:func:`_split_proj` and the causal conv of a training forward under
    ``rule``, with the inner dim kept on its `model` shards: z and x each
    from their own columns of ``w_in_zx`` (where slicing the projection's
    output would gather both halves of it on every rank), x's conv on
    each rank's channels (:func:`~repro_torch.models.common.on_replicas`
    keeping the channel split; the conv is depthwise), B and C's conv on
    their few shared channels: the unsharded path's operations, channel
    for channel.  Returns (z, x after the conv, B|C after the conv, dt,
    gn)."""
    din = s.d_inner(d)
    gn = s.n_groups * s.d_state
    axis = rule.get("act_inner")
    # gathered over the embed split once, where each projection's
    # contraction would gather (and keep for its backward) a copy of it
    xn = constrain(xn, rule, ("batch", "seq", None))

    def inner(w, lo, hi):
        """Columns ``lo:hi`` of a weight's last (inner) dim, split over
        `model` again."""
        cols = w[..., lo:hi]
        return constrain(cols, rule, (None,) * (cols.ndim - 1) + ("inner",))
    zx = p["w_in_zx"]
    z = einsum("bsd,de->bse", xn, inner(zx, 0, din))
    xin = einsum("bsd,de->bse", xn, inner(zx, din, 2 * din))
    bc = einsum("bsd,de->bse", xn, p["w_in_bc"])
    cw, cb = p["conv_w"], p["conv_b"]
    keep = (axis, {0: 2, 1: 1, 2: 0}, (2, 2)) if isinstance(axis, str) \
        else None
    xin, _ = on_replicas(_causal_conv, xin, inner(cw, 0, din),
                         inner(cb, 0, din), rows=(0,), keep=keep)
    bc, _ = on_replicas(_causal_conv, bc, cw[:, din:], cb[din:], rows=(0,))
    return z, xin, bc, _step_sizes(p, xn), gn


def _gate_norm(y, gain, groups: int, eps: float):
    """The gated output's RMS norm, each of ``groups`` runs of channels
    on its own."""
    if groups == 1:
        return rms_norm(y, gain, eps)
    *lead, din = y.shape
    return rms_norm(y.reshape(*lead, groups, din // groups),
                    gain.reshape(groups, din // groups),
                    eps).reshape(*lead, din)


def mamba2_apply(p, x, cfg, cache=None, pos=None, rule=None):
    """Returns (delta_x, new_cache); cache = {'ssm': (b,h,p,n), 'conv':
    (b, W-1, ch)}.  Training/prefill runs the chunked SSD scan (the length
    must be a multiple of the chunk, or shorter than one); decode the
    one-step recurrence."""
    s: SSMConfig = cfg.ssm
    b, L, d = x.shape
    h, P, N = s.n_heads(d), s.headdim, s.d_state
    G = s.n_groups
    if G > 1 and _head_split(rule) is not None:
        raise NotImplementedError(
            "mamba2_apply: B and C in groups with the heads split over a "
            "mesh: each rank would need its own heads' groups")
    eps = cfg.norm_eps
    xn = rms_norm(x, p["ln"], eps)
    din = s.d_inner(d)
    if rule is not None and cache is None and isinstance(xn, DTensor):
        z, xin, bc, dt, gn = _inner_sharded(p, xn, s, d, rule)
    else:
        z, xin, bc, dt, gn = _split_proj(p, xn, s, d)
        conv_in = torch.cat([xin, bc], dim=-1)
        conv_out, conv_state = _causal_conv(
            conv_in, p["conv_w"], p["conv_b"],
            None if cache is None else cache["conv"])
        xin, bc = conv_out[..., :din], conv_out[..., din:]
    B = bc[..., :gn].reshape(b, L, G, N)        # (b, L, N) for one group
    C = bc[..., gn:].reshape(b, L, G, N)
    if G == 1:
        B, C = B[:, :, 0], C[:, :, 0]
    xh = xin.reshape(b, L, h, P)
    if rule is not None:
        xh = constrain(xh, rule, ("batch", None, "act_heads", None))
    A = -torch.exp(p["A_log"].float())                          # (h,)
    Dp = p["D"].float()[:, None]

    if cache is not None and L == 1:  # ---- decode: one recurrent step ----
        st = cache["ssm"]                                       # (b,h,P,N)
        a = torch.exp(A[None, :] * dt[:, 0])                    # (b,h)
        dx = dt[:, 0][..., None] * xh[:, 0].float()             # (b,h,P)
        if G == 1:
            st = st * a[..., None, None] + einsum(
                "bhp,bn->bhpn", dx, B[:, 0].float())
            y = einsum("bhpn,bn->bhp", st, C[:, 0].float())
        else:                                   # each head its group's
            grp = ssd_scan.heads_of_groups(h, G, x.device)
            st = st * a[..., None, None] + einsum(
                "bhp,bhn->bhpn", dx, B[:, 0][:, grp].float())
            y = einsum("bhpn,bhn->bhp", st, C[:, 0][:, grp].float())
        y = y + Dp * xh[:, 0].float()
        y = y.reshape(b, 1, h * P).to(x.dtype)
        cache = {"ssm": st, "conv": conv_state}
    else:  # ---------------- chunked SSD ------------------------------
        Q = min(s.chunk, L)
        assert L % Q == 0, (L, Q)
        state = (torch.zeros(b, h, P, N, dtype=torch.float32,
                             device=x.device) if cache is None
                 else cache["ssm"])

        def scan(xh, B, C, dt, A, Dp, state):
            l_t = A[None, None, :] * dt                         # (b,L,h)
            # on each rank's rows and heads under a rule: DTensor has no
            # sharding strategy for the scan's three-operand einsums on
            # every torch version, and each head scans alone (B and C are
            # shared)
            return on_replicas(lambda *a: _ssd(*a, Q), xh, B, C, dt, l_t,
                               Dp, state, rows=(0, 1, 2, 3, 4, 6),
                               keep=_head_split(rule))
        # every use of dt inside the span, so that its gradients are
        # summed in the order they are without it
        y, state = obs.layer("layer.scan", scan, xh, B, C, dt, A, Dp, state)
        y = y.reshape(b, L, h * P).to(x.dtype)
        if cache is not None:
            cache = {"ssm": _rows_only(state), "conv": conv_state}

    y = y * F.silu(z)
    y = _gate_norm(y, p["gate_ln"], G, eps)
    out = einsum("bse,ed->bsd", y, p["w_out"])
    if rule is not None:
        out = constrain(out, rule, ("batch", "seq", "act_embed"))
    return out, cache


def _head_split(rule):
    """``on_replicas``' ``keep`` for :func:`_ssd` under ``rule``: xh, dt,
    l_t, Dp and the state stay split on their head dim over the mesh dim
    that ``act_heads`` names, and so do y and the final state; B and C
    are shared by every head.  None without a rule or such a mesh dim."""
    axis = None if rule is None else rule.get("act_heads")
    if not isinstance(axis, str):
        return None
    return axis, {0: 2, 3: 2, 4: 2, 5: 0, 6: 1}, (2, 1)


def _rows_only(t):
    """A DTensor state gathered on every mesh dim but its rows' split:
    the placements the cache has always had."""
    if not isinstance(t, DTensor):
        return t
    want = tuple(p if p == Shard(0) else Replicate() for p in t.placements)
    return t if tuple(t.placements) == want else \
        t.redistribute(t.device_mesh, want)


def _ssd(xh, B, C, dt, l_t, Dp, state, Q: int):
    """The chunked SSD scan: xh (b, L, h, P), B and C (b, L, N), or
    (b, L, G, N) in groups, dt and
    the log-decays l_t (b, L, h), ``Dp`` (h, 1), the carried state
    (b, h, P, N) in float32.  Within a chunk of ``Q`` the dual quadratic
    form, across chunks the recurrence.  Returns y (b, L, h, P) in
    float32 and the final state.  On the card the SSD kernels run it
    (:func:`repro_torch.kernels.ssd_scan.ssd_scan`); on the CPU, and in
    float64, the plain chunk loop (:func:`~repro_torch.kernels.ssd_scan.plain`:
    float64 operands stay float64, narrower ones compute in float32)."""
    return ssd_scan.ssd_scan(xh, B, C, dt, l_t, Dp, state, Q)


def mamba2_cache_shape(cfg, batch: int):
    """Cache shapes and types: the ssm state in float32, the conv window
    in bfloat16."""
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    h, P, N = s.n_heads(d), s.headdim, s.d_state
    conv_ch = s.d_inner(d) + 2 * s.n_groups * s.d_state
    return {"ssm": ((batch, h, P, N), torch.float32),
            "conv": ((batch, s.conv_width - 1, conv_ch), torch.bfloat16)}
