"""Feed-forward blocks: SwiGLU / GeGLU (gated) and plain GELU (whisper).

Counterpart of ``repro.models.mlp``; GELU is the tanh approximation, as
``jax.nn.gelu(approximate=True)`` there, except in ``geglu_erf``, the
gated exact (erf) GELU of Zamba2's shared MLP (``hidden_act`` "gelu"),
which :func:`adapted_apply` runs with its per-invocation adapter."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import PRec, constrain, einsum, layer_norm, rms_norm


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_ACTS = {"swiglu": F.silu, "geglu": _gelu, "gelu": _gelu, "relu": F.relu,
         "geglu_erf": F.gelu}
#: the gated activations: a gate and an up projection
GATED = ("swiglu", "geglu", "geglu_erf")


def mlp_recs(cfg, d_ff: int | None = None) -> dict[str, PRec]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    recs = {
        "w_out": PRec((ff, d), ("ff", "embed"), scale=ff ** -0.5),
        "ln": PRec((d,), ("embed",), init="zeros"),
    }
    if cfg.act in GATED:
        recs["w_gate"] = PRec((d, ff), ("embed", "ff"))
        recs["w_up"] = PRec((d, ff), ("embed", "ff"))
    else:
        recs["w_up"] = PRec((d, ff), ("embed", "ff"))
        recs["b_up"] = PRec((ff,), ("ff",), init="zeros")
        recs["b_out"] = PRec((d,), ("embed",), init="zeros")
    if cfg.norm == "layernorm":
        recs["ln"] = PRec((d,), ("embed",), init="ones")
        recs["ln_b"] = PRec((d,), ("embed",), init="zeros")
    return recs


def norm(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """The block's pre-norm: RMS norm (epsilon ``cfg.norm_eps``), or layer
    norm with ``ln_b``."""
    return (rms_norm(x, p["ln"], cfg.norm_eps) if cfg.norm == "rmsnorm"
            else layer_norm(x, p["ln"], p["ln_b"]))


def mlp_apply(p, x: torch.Tensor, cfg, rule=None) -> torch.Tensor:
    xn = norm(p, x, cfg)
    act = _ACTS[cfg.act]
    if cfg.act in GATED:
        g = einsum("bsd,df->bsf", xn, p["w_gate"])
        u = einsum("bsd,df->bsf", xn, p["w_up"])
        h = act(g) * u
    else:
        h = act(einsum("bsd,df->bsf", xn, p["w_up"]) + p["b_up"])
    if rule is not None:
        h = constrain(h, rule, ("batch", None, "act_ff"))
    out = einsum("bsf,fd->bsd", h, p["w_out"])
    if "b_out" in p:
        out = out + p["b_out"]
    if rule is not None:
        out = constrain(out, rule, ("batch", "seq", "act_embed"))
    return out


def adapted_apply(p, a, x: torch.Tensor, cfg) -> torch.Tensor:
    """Zamba2's shared MLP at one invocation: the pre-norm, then the gate
    and up projections each plus its part of the invocation's low-rank
    adapter ``a`` (``a_in`` (d, r), ``a_out`` (r, 2·ff): gate columns
    first), the gated activation and the down projection.  No residual."""
    xn = norm(p, x, cfg)
    ff = p["w_gate"].shape[-1]
    low = einsum("bsd,dr->bsr", xn, a["a_in"])
    g = einsum("bsd,df->bsf", xn, p["w_gate"]) + \
        einsum("bsr,rf->bsf", low, a["a_out"][:, :ff])
    u = einsum("bsd,df->bsf", xn, p["w_up"]) + \
        einsum("bsr,rf->bsf", low, a["a_out"][:, ff:])
    return einsum("bsf,fd->bsd", _ACTS[cfg.act](g) * u, p["w_out"])
