"""Feed-forward blocks: SwiGLU / GeGLU (gated) and plain GELU (whisper).

Counterpart of ``repro.models.mlp``; GELU is the tanh approximation, as
``jax.nn.gelu(approximate=True)`` there."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import PRec, constrain, einsum, layer_norm, rms_norm


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_ACTS = {"swiglu": F.silu, "geglu": _gelu, "gelu": _gelu, "relu": F.relu}


def mlp_recs(cfg, d_ff: int | None = None) -> dict[str, PRec]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    recs = {
        "w_out": PRec((ff, d), ("ff", "embed"), scale=ff ** -0.5),
        "ln": PRec((d,), ("embed",), init="zeros"),
    }
    if cfg.act in ("swiglu", "geglu"):
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
    """The block's pre-norm: RMS norm, or layer norm with ``ln_b``."""
    return (rms_norm(x, p["ln"]) if cfg.norm == "rmsnorm"
            else layer_norm(x, p["ln"], p["ln_b"]))


def mlp_apply(p, x: torch.Tensor, cfg, rule=None) -> torch.Tensor:
    xn = norm(p, x, cfg)
    act = _ACTS[cfg.act]
    if cfg.act in ("swiglu", "geglu"):
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
