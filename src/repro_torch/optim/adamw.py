"""AdamW with fp32 master weights, decoupled weight decay, global-norm
clipping, and optional int8 block-quantized optimizer state (absmax
linear quantization over the trailing axis; the second moment in the
sqrt domain).

Counterpart of ``repro.optim.adamw``, with the same arithmetic in the same
order.  The state is a tree shaped like JAX's (``step``, ``m``, ``v``,
``master``; ``{"q", "scale"}`` leaves when quantized), so checkpoints and
:func:`repro_torch.convert.adamw_state` map it leaf for leaf.
:func:`adamw_update` writes the new values into the parameter and state
tensors it is given, under ``torch.no_grad()``, and returns them: at full
width a second copy of the state would not fit beside the first.

DTensor leaves (a sharded step) take the same arithmetic: each moment
keeps its parameter's placements, and a quantized moment's per-row
``scale`` the parameter's placements with the last dim replicated
(``launch.cell.opt_specs``); the row maxima over a sharded last dim are
exact, so ``q`` equals the unsharded one for equal inputs.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..models.common import distribute, leaves, tmap


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_fp32: bool = True       # keep an fp32 copy of bf16 params
    quantize_state: bool = False   # int8 m/v (block absmax over last axis)


# ----------------------------------------------------------------------
# int8 state (de)quantization
# ----------------------------------------------------------------------
def _quantize(x: torch.Tensor, sqrt_domain: bool = False) -> dict:
    """Symmetric absmax int8 over the trailing axis.  ``sqrt_domain``
    quantizes sqrt(x) for the non-negative second moment: linear absmax
    rounds small v entries to zero, which sends the update to m/eps."""
    xf = x.float()
    if sqrt_domain:
        xf = torch.sqrt(torch.clamp(xf, min=0.0))
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _dequantize(d: dict, sqrt_domain: bool = False) -> torch.Tensor:
    x = d["q"].float() * d["scale"]
    return torch.square(x) if sqrt_domain else x


def _is_q(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _moment_zeros(p: torch.Tensor, quantize: bool):
    if quantize:
        return {"q": torch.zeros_like(p, dtype=torch.int8),
                "scale": _like_rows(p, torch.full(
                    p.shape[:-1] + (1,) if p.dim() else (1,), 1e-12,
                    dtype=torch.float32, device=_local_device(p)))}
    return torch.zeros_like(p, dtype=torch.float32)


def _local_device(p: torch.Tensor) -> torch.device:
    return p.to_local().device if isinstance(p, DTensor) else p.device


def _like_rows(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` (one entry a row of ``p``) placed as ``p`` is, with ``p``'s
    last dim replicated: the rows' ``scale``."""
    if not isinstance(p, DTensor):
        return t
    return distribute(t, p.device_mesh, [
        Replicate() if pl.is_shard(p.dim() - 1) or not p.dim() else pl
        for pl in p.placements])


def _up_to(template, tree) -> list:
    """The subtrees of ``tree`` at the leaves of ``template``, in
    :func:`~repro_torch.models.common.leaves` order (JAX's
    ``flatten_up_to``: a quantized moment stays one ``{q, scale}``)."""
    if isinstance(template, dict):
        return [x for k in sorted(template) for x in _up_to(template[k],
                                                             tree[k])]
    if isinstance(template, (list, tuple)):
        return [x for t, s in zip(template, tree) for x in _up_to(t, s)]
    return [tree]


# ----------------------------------------------------------------------
def global_norm(tree) -> torch.Tensor:
    parts = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(parts)))


def adamw_init(params, cfg: OptConfig) -> dict:
    """Zero moments (int8 ones when ``cfg.quantize_state``), step 0 and,
    with ``cfg.master_fp32``, float32 copies of the parameters, each on
    its parameter's device — or, for DTensor parameters, its mesh and
    placements (the step replicated, a ``scale`` with the last dim
    replicated)."""
    first = leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=_local_device(first))
    if isinstance(first, DTensor):                   # replicated, P()
        step = distribute(step, first.device_mesh,
                          [Replicate()] * first.device_mesh.ndim)
    state = {
        "step": step,
        "m": tmap(lambda p: _moment_zeros(p, cfg.quantize_state), params),
        "v": tmap(lambda p: _moment_zeros(p, cfg.quantize_state), params),
    }
    if cfg.master_fp32:
        state["master"] = tmap(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


@torch.no_grad()
def adamw_update(grads, params, state: dict, cfg: OptConfig, lr):
    """One AdamW step, in place: the parameter and state tensors are
    overwritten with the new values.  Returns ``(params, state,
    {"grad_norm": ...})``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0) \
        if cfg.clip_norm else 1.0
    state["step"] += 1
    t = state["step"].to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    masters = state.get("master", params)

    flat_g = leaves(grads)
    for g, p, pm, m, v in zip(flat_g, leaves(params), leaves(masters),
                              _up_to(grads, state["m"]),
                              _up_to(grads, state["v"])):
        g = g.float() * scale
        mf = _dequantize(m) if _is_q(m) else m
        vf = _dequantize(v, sqrt_domain=True) if _is_q(v) else v
        mf = cfg.b1 * mf + (1.0 - cfg.b1) * g
        vf = cfg.b2 * vf + (1.0 - cfg.b2) * torch.square(g)
        upd = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        # trust cap: bounds the update when quantized v underestimates
        upd = torch.clamp(upd, -3.0, 3.0)
        pnew = pm.float() * (1.0 - lr * cfg.weight_decay) - lr * upd
        del g, upd
        for old, new, sqrt_domain in ((m, mf, False), (v, vf, True)):
            if _is_q(old):
                for key, t in _quantize(new, sqrt_domain).items():
                    old[key].copy_(t)
            else:
                old.copy_(new)
        if pm is not p:
            pm.copy_(pnew)
        p.copy_(pnew)
    return params, state, {"grad_norm": gnorm}
