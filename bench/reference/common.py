"""The plain reference's shared pieces: norms, rotary embedding, causal
attention in blocks, the loss in row chunks, AdamW, and the driver that
follows a training run's first steps.

Everything here is float32 PyTorch with TF32 off, written from the
published equations; it imports nothing of the program under test.  A
``Ops`` object carries the precision of the products: ``"fp32"`` for the
reference, ``"fp8"`` for the control, which rounds both operands of every
product to float8 e4m3 (one scale per tensor, its largest magnitude at
448) and multiplies the rounded values in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -2.0 ** 30
E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _RoundFp8(torch.autograd.Function):
    """Forward: the tensor rounded to float8 e4m3 under one scale.  The
    gradient passes unchanged (the products' operands are what is
    rounded)."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp(min=1e-30)
        s = amax / E4M3_MAX
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


class Ops:
    """Products at one precision: ``"fp32"`` or ``"fp8"``."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.precision = precision

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundFp8.apply(x) if self.precision == "fp8" else x

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(eq, self.r(a), self.r(b))


def rms_norm(x, gain, eps: float = 1e-6):
    """``x / rms(x) * (1 + gain)``: the gain is stored centred on zero."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + gain)


def rotary(x, theta: float):
    """Rotary embedding of x (b, s, heads, d) at positions 0..s-1, the
    rotation of the two halves of the head dim (frequencies
    theta^(-i / (d/2)))."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


class CausalAttention(torch.autograd.Function):
    """softmax(q kᵀ / sqrt(d), causal) v for q, k, v (b, h, s, d), in
    blocks of query rows, so that no (s, s) score matrix of every head
    is held at once; the backward recomputes each block's probabilities
    from the saved log-sum-exp."""

    @staticmethod
    def _rows(h: int, s: int) -> int:
        rows = max(64, (1 << 28) // max(1, h * s))
        return min(s, 1 << (rows.bit_length() - 1))

    @staticmethod
    def forward(ctx, q, k, v):
        b, h, s, d = q.shape
        scale = 1.0 / math.sqrt(d)
        out = torch.empty_like(q)
        lse = torch.empty(b, h, s, dtype=q.dtype, device=q.device)
        n = CausalAttention._rows(h, s)
        for i in range(0, s, n):
            j = min(s, i + n)
            sc = torch.matmul(q[:, :, i:j], k[:, :, :j].transpose(-1, -2)) \
                * scale
            mask = torch.arange(i, j, device=q.device)[:, None] >= \
                torch.arange(j, device=q.device)[None]
            sc = torch.where(mask, sc, NEG)
            lse[:, :, i:j] = torch.logsumexp(sc, dim=-1)
            p = torch.exp(sc - lse[:, :, i:j, None])
            out[:, :, i:j] = torch.matmul(p, v[:, :, :j])
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        b, h, s, d = q.shape
        scale = 1.0 / math.sqrt(d)
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        dsum = (g * out).sum(-1)
        n = CausalAttention._rows(h, s)
        for i in range(0, s, n):
            j = min(s, i + n)
            sc = torch.matmul(q[:, :, i:j], k[:, :, :j].transpose(-1, -2)) \
                * scale
            mask = torch.arange(i, j, device=q.device)[:, None] >= \
                torch.arange(j, device=q.device)[None]
            p = torch.where(mask, torch.exp(sc - lse[:, :, i:j, None]), 0.0)
            gi = g[:, :, i:j]
            dv[:, :, :j] += torch.matmul(p.transpose(-1, -2), gi)
            dp = torch.matmul(gi, v[:, :, :j].transpose(-1, -2))
            ds = p * (dp - dsum[:, :, i:j, None]) * scale
            dq[:, :, i:j] = torch.matmul(ds, k[:, :, :j])
            dk[:, :, :j] += torch.matmul(ds.transpose(-1, -2), q[:, :, i:j])
        return dq, dk, dv


def _head_chunk(x, final_ln, embed, labels, vocab: int, ops: Ops):
    """Sums over the rows of one chunk: (cross-entropy, lse²)."""
    h = rms_norm(x, final_ln)
    logits = ops.einsum("nd,vd->nv", h, embed[:vocab])
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[:, None])[:, 0]
    return (lse - ll).sum(), lse.square().sum()


def head_loss(x, final_ln, embed, labels, vocab: int, z_loss: float,
              ops: Ops, rows: int = 2048):
    """Mean cross-entropy plus ``z_loss`` times the mean squared
    log-sum-exp of the tied head's logits, over x (b, n, d) and labels
    (b, n); only the first ``vocab`` rows of the embedding are tokens.
    Computed in row chunks, each recomputed in the backward."""
    xf = x.reshape(-1, x.shape[-1])
    lf = labels.reshape(-1)
    ce = zz = 0.0
    for i in range(0, xf.shape[0], rows):
        c, z = checkpoint(_head_chunk, xf[i:i + rows], final_ln, embed,
                          lf[i:i + rows], vocab, ops, use_reentrant=False)
        ce, zz = ce + c, zz + z
    n = xf.shape[0]
    return ce / n + z_loss * zz / n


def lr_at(step: int, train: dict) -> float:
    """Linear warm-up to the peak, then a cosine to a tenth of it."""
    peak, warm = train["lr"], train["warmup_steps"]
    if step < warm:
        return peak * step / max(1.0, warm)
    prog = min(1.0, (step - warm) / max(1.0, train["total_steps"] - warm))
    return peak * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * prog)))


def leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves(tree[k], f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def layer_slices(tree) -> list[tuple[str, torch.Tensor]]:
    """Each weight as the published model holds it: a leaf under
    ``stages`` stacks its layers on the first axis and is cut into one
    tensor a layer, ``name@layer``; the others stay whole."""
    out = []
    for name, t in leaves(tree):
        if name.startswith("stages"):
            out += [(f"{name}@{i}", t[i]) for i in range(t.shape[0])]
        else:
            out.append((name, t))
    return out


def slice_norms(tree) -> dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.detach().float()))
            for n, t in layer_slices(tree)}


def adamw(params, grads, m, v, step: int, train: dict) -> None:
    """One AdamW step in place on float32 leaves: global-norm clipping,
    bias-corrected moments, the update bounded to ±3, decoupled weight
    decay."""
    gn = math.sqrt(sum(float(g.square().sum()) for _, g in leaves(grads)))
    scale = min(1.0, train["clip_norm"] / (gn + 1e-12))
    t = step + 1
    bc1, bc2 = 1.0 - train["b1"] ** t, 1.0 - train["b2"] ** t
    lr = lr_at(step, train)
    for (_, p), (_, g), (_, mm), (_, vv) in zip(leaves(params),
                                                leaves(grads), leaves(m),
                                                leaves(v)):
        g = g * scale
        mm.mul_(train["b1"]).add_(g, alpha=1.0 - train["b1"])
        vv.mul_(train["b2"]).add_(g.square(), alpha=1.0 - train["b2"])
        upd = ((mm / bc1) / (torch.sqrt(vv / bc2) + train["eps"])) \
            .clamp(-3.0, 3.0)
        p.mul_(1.0 - lr * train["weight_decay"]).sub_(upd, alpha=lr)


def _tmap(f, tree):
    if isinstance(tree, dict):
        return {k: _tmap(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tmap(f, v) for v in tree]
    return f(tree)


def follow(loss, params0, batches: list[dict], train: dict,
           microbatches: int, steps: int, ops: Ops) -> dict:
    """The first ``steps`` training steps from the parameters
    ``params0`` (a tree, any float type; left as it is) on ``batches``
    (one dict of ``tokens`` and ``labels`` (b, s) a step), each step's
    gradient the mean over ``microbatches`` slices of the batch's rows.
    Returns each step's loss, the norm of each layer slice's step-0
    gradient after clipping (as the optimizer takes it), and the norm of
    each slice's change over the steps.  ``loss(params, tokens, labels,
    ops)`` is a family's loss of one microbatch."""
    no_tf32()
    params = _tmap(lambda t: t.detach().float().clone().requires_grad_(),
                   params0)
    m = _tmap(lambda t: torch.zeros_like(t, requires_grad=False), params)
    v = _tmap(lambda t: torch.zeros_like(t, requires_grad=False), params)
    losses, grad = [], None
    k = microbatches
    for step in range(steps):
        batch = batches[step]
        b = batch["tokens"].shape[0]
        total = 0.0
        for i in range(k):
            rows = slice(i * (b // k), (i + 1) * (b // k))
            value = loss(params, batch["tokens"][rows],
                         batch["labels"][rows], ops)
            value.backward()
            total += float(value.detach())
            del value
        grads = _tmap(lambda p: p.grad if p.grad is not None
                      else torch.zeros_like(p), params)
        with torch.no_grad():
            for _, g in leaves(grads):
                g.div_(k)
            losses.append(total / k)
            if step == 0:
                gn = math.sqrt(sum(float(g.square().sum())
                                   for _, g in leaves(grads)))
                scale = min(1.0, train["clip_norm"] / (gn + 1e-12))
                grad = {n: x * scale for n, x in slice_norms(grads).items()}
            adamw(params, grads, m, v, step, train)
        for _, p in leaves(params):
            p.grad = None
        del grads
    del m, v
    with torch.no_grad():
        change = {}
        for (n, p), (_, p0) in zip(layer_slices(params),
                                   layer_slices(params0)):
            change[n] = float(torch.linalg.vector_norm(p - p0.float()))
    return {"loss": losses, "grad": grad, "change": change}


def causal_conv(u, w, b):
    """Depthwise causal convolution of u (b, s, ch) with w (width, ch)
    and bias b (ch,): out[t] = b + sum_j w[j] u[t + j - width + 1]."""
    width = w.shape[0]
    y = F.conv1d(u.transpose(1, 2), w.t()[:, None, :], b,
                 padding=width - 1, groups=u.shape[-1])
    return y[..., :u.shape[1]].transpose(1, 2)
