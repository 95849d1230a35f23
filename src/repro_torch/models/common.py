"""Model substrate: parameter records, random initialisation, norms, RoPE.

Counterpart of ``repro.models.common``.  Parameters are declared once as a
tree (nested dicts and lists) of :class:`PRec` (shape, logical axis names,
init scale); :func:`materialize` turns the record tree into tensors on a
device, drawn from an explicit ``torch.Generator``.

The JAX module's sharding layer (``rules``, ``spec_of``, ``spec_tree``,
``abstract_tree``, ``shardings``, ``with_sharding``, ``constrain``) is not
here: it waits for the port's distribution slice (ROADMAP.md Queue 1,
item 5), and the port's modules take no ``rule`` argument.  The axis names
stay on the records for it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class PRec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]       # logical axis name per dim
    scale: float | None = None         # None -> fan-in 1/sqrt(shape[-2])
    dtype: torch.dtype | None = None   # None -> builder default
    init: str = "normal"               # normal | zeros | ones | fill

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def is_rec(x) -> bool:
    return isinstance(x, PRec)


def tmap(f: Callable, tree, *rest):
    """Apply ``f`` to every leaf of ``tree`` (a :class:`PRec`, tensor or
    array; dicts and lists are the inner nodes), with the matching leaves
    of ``rest`` as further arguments; returns a tree of the same shape."""
    if isinstance(tree, dict):
        return {k: tmap(f, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tmap(f, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return f(tree, *rest)


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flattening order (dict keys sorted,
    lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def take(tree, i: int):
    """Layer ``i`` of a stacked tree: every leaf indexed on its first axis
    (views, so writes reach the stack)."""
    return tmap(lambda t: t[i], tree)


def materialize(recs, generator: torch.Generator | None = None,
                default_dtype: torch.dtype = torch.bfloat16,
                device: torch.device | str | None = None):
    """Tensors for a record tree, on ``device`` (the generator's by
    default), random leaves drawn from ``generator`` one leaf after
    another in the tree's order (a tree of constants, such as a cache,
    needs none).

    The JAX rules: ``zeros``, ``ones`` and ``fill`` (value in ``scale``)
    are constants; ``normal`` draws N(0, 1) times ``scale``, or
    ``shape[-2] ** -0.5`` (fan-in: the heads axis for ``wq``) when
    ``scale`` is None.  A leaf of three or more axes (the stacked layers)
    is drawn one slice of its first axis at a time, so the float32
    temporary is one layer's, not the whole stack's.  The values differ
    from JAX's; tests carry JAX's across through
    :func:`repro_torch.convert.lm_params`."""
    dev = torch.device(device if device is not None else
                       generator.device if generator is not None else "cpu")

    def one(r: PRec) -> torch.Tensor:
        dt = r.dtype or default_dtype
        if r.init == "zeros":
            return torch.zeros(r.shape, dtype=dt, device=dev)
        if r.init == "ones":
            return torch.ones(r.shape, dtype=dt, device=dev)
        if r.init == "fill":
            return torch.full(r.shape, r.scale, dtype=dt, device=dev)
        if generator is None:
            raise ValueError(f"materialize: a {r.init} leaf {r.shape} "
                             "needs a generator")
        fan_in = r.shape[-2] if len(r.shape) >= 2 else max(1, r.shape[-1])
        scale = r.scale if r.scale is not None else fan_in ** -0.5
        if len(r.shape) < 3:
            return (torch.randn(r.shape, generator=generator, device=dev)
                    * scale).to(dt)
        out = torch.empty(r.shape, dtype=dt, device=dev)
        for i in range(r.shape[0]):
            out[i] = torch.randn(r.shape[1:], generator=generator,
                                 device=dev) * scale
        return out

    return tmap(one, recs)


def nbytes(tree) -> int:
    """Bytes of the tensors of a tree."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


# ----------------------------------------------------------------------
# Numerics (JAX's order of casts: statistics in float32, result in x's type)
# ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """RMS norm with a zero-centred gain: ``x / rms(x) * (1 + gamma)``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         scale: float = 1.0) -> torch.Tensor:
    """Rotary embedding over the last dim of x: (..., seq, heads, hd);
    ``positions`` (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = (theta ** (-torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)) * scale
    ang = positions.float()[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def pad_heads(n: int, tp: int = 16) -> int:
    """Pad head counts up to TP divisibility (Megatron-style GQA padding;
    llama4 40→48 Q heads, 8→16 KV heads at tp=16)."""
    return -(-n // tp) * tp


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's type promotion: operands of mixed
    floating types (bf16 weights against float32 activations) are cast to
    the promoted type first, where torch would refuse them."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t if t.dtype == dt else t.to(dt) for t in ops))


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"``/``"float32"`` (an ``ArchConfig.act_dtype``) as a
    torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]

