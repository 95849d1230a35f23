"""Parameters drawn from the seed, on the device, in the type they are
trained in.

A configuration's family (``bench/reference/<family>.py``) states the
layout: every leaf's path, shape and initial rule.  All ``normal``
leaves are views of one buffer filled by a few ``normal_`` calls of one
generator on the device, each leaf then scaled in place; the two uniform
rules of Mamba-2's scan (``a_log``, ``dt_bias``) share a second buffer.
The same seed on the same device gives the same values, so the
reference draws its own copy after the program's run has freed its.
"""
from __future__ import annotations

import math

import torch

#: at most this many elements per ``normal_`` call
CALL = 1 << 30


def stream(seed: int, k: int) -> int:
    """The seed of stream ``k`` (weights 0, traffic 1) of a run's seed."""
    return (int(seed) * 8 + k) % (1 << 63)


def _fill(buf: torch.Tensor, how: str, g: torch.Generator) -> None:
    for i in range(0, buf.numel(), CALL):
        part = buf[i:i + CALL]
        if how == "normal":
            part.normal_(generator=g)
        else:
            part.uniform_(generator=g)


def _set(tree: dict, path: str, value) -> None:
    """Put ``value`` at ``path`` ("a.b[0].c") of a nested dict/list."""
    node = tree
    parts = path.replace("]", "").replace("[", ".").split(".")
    for key, nxt in zip(parts[:-1], parts[1:]):
        key = int(key) if key.isdigit() else key
        want = [] if nxt.isdigit() else {}
        if isinstance(node, list):
            while len(node) <= key:
                node.append(None)
            if node[key] is None:
                node[key] = want
        elif key not in node:
            node[key] = want
        node = node[key]
    last = parts[-1]
    if isinstance(node, list):
        last = int(last)
        while len(node) <= last:
            node.append(None)
    node[last] = value


def draw(layout, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The parameter tree of ``layout`` (``[(path, shape, init,
    scale)]``) from ``seed``."""
    g = torch.Generator(device=device).manual_seed(stream(seed, 0))
    normal = [(p, s, sc) for p, s, init, sc in layout if init == "normal"]
    uniform = [(p, s, init) for p, s, init, _ in layout
               if init in ("a_log", "dt_bias")]
    n = sum(math.prod(s) for _, s, _ in normal)
    buf = torch.empty(n, dtype=dtype, device=device)
    _fill(buf, "normal", g)
    nu = sum(math.prod(s) for _, s, _ in uniform)
    ubuf = torch.empty(nu, dtype=torch.float32, device=device)
    _fill(ubuf, "uniform", g)
    tree: dict = {}
    off = 0
    for path, shape, scale in normal:
        k = math.prod(shape)
        leaf = buf[off:off + k].view(shape)
        leaf.mul_(scale)
        _set(tree, path, leaf)
        off += k
    off = 0
    for path, shape, init in uniform:
        k = math.prod(shape)
        u = ubuf[off:off + k].view(shape)
        if init == "a_log":                  # a uniform in [1, 16]
            val = torch.log(1.0 + 15.0 * u)
        else:                                # dt log-uniform in [1e-3, 1e-1]
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1)
                                                 - math.log(1e-3)))
            val = dt + torch.log(-torch.expm1(-dt))
        _set(tree, path, val.to(dtype))
        off += k
    for path, shape, init, _ in layout:
        if init in ("zeros", "ones"):
            fill = torch.zeros if init == "zeros" else torch.ones
            _set(tree, path, fill(shape, dtype=dtype, device=device))
    return tree


def shapes(tree, prefix: str = "") -> dict[str, tuple]:
    """path → shape of every leaf (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(shapes(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(shapes(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tuple(tree.shape)}
