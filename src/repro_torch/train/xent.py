"""The softmax cross-entropy's two row sums on a slice of the vocab, with
the logits kept in their own type.

JAX's ``_xent`` upcasts the logits to float32 and takes ``logsumexp`` and
the label's logit; XLA fuses the upcast, the ``exp`` and the one-hot
into the gradient, so no float32 copy of the logits exists there.  Eager
PyTorch would keep three or four (the upcast, the ``exp`` its backward
saves, the zeros and the scatter of ``gather``'s backward).  Here one
:class:`torch.autograd.Function` does the slice's work in float32 chunks
of rows: its forward sums ``exp(t - m)`` and picks the label's logit, it
saves only the logits, the row max and the labels, and its backward
writes ``g_s·exp(t - m)`` plus ``g_l`` at the label into one buffer of
the logits' type, cast once per chunk.  Bf16 and float32 logits sum in
float32, as JAX's do; float64 logits, which no model produces, stay in
float64, so that the float64 checks of the sharded loss can hold it to
1e-12.

The logits are a (b, s, V) tensor walked by batch row and chunk of
sequence rows, never reshaped.  The labels (b, n) cover its first n
positions; the rest take no part and get a zero gradient in the same
buffer.  So the loss takes the model's whole logits, where a caller's
``[:, :-1]`` slice would cost a second logit-sized gradient (the
slice's backward pads the Function's into a fresh buffer)."""
from __future__ import annotations

import torch

#: the float32 transient one chunk of rows of the loss holds, as
#: ``kernels.flash_attention.BACKWARD_TRANSIENT_BYTES`` bounds the
#: attention backward's (forward and backward hold one chunk at a time)
CHUNK_BYTES = 256 << 20


def acc_type(dtype: torch.dtype) -> torch.dtype:
    """The type the loss sums in: float32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _chunks(t: torch.Tensor, n: int):
    """``(i, rows)`` index pairs that cover the first ``n`` of ``t``'s
    (b, s) rows, one batch row at a time, each chunk at most
    ``CHUNK_BYTES`` in float32."""
    b, _, v = t.shape
    step = max(1, CHUNK_BYTES // (4 * v))
    for i in range(b):
        for j in range(0, n, step):
            yield i, slice(j, min(j + step, n))


class SliceSums(torch.autograd.Function):
    """``(Σ_v exp(t - m), t[label - offset])`` per row of the first n
    positions of logits ``t`` (b, s, V) in their own type, for a slice of
    the vocab whose first column is ``offset``; ``labels`` and ``m`` are
    (b, n), n ≤ s, ``m`` the row max over the whole vocab in
    :func:`acc_type`, detached (:func:`row_max`).  A label outside the
    slice picks 0; an empty slice gives zeros and an empty gradient; the
    positions past n get a zero gradient.  Both sums in
    :func:`acc_type`."""

    @staticmethod
    def forward(ctx, t, m, labels, offset: int):
        acc = m.dtype
        j = labels.long() - offset
        n = j.shape[1]
        s = torch.zeros(j.shape, dtype=acc, device=t.device)
        pick = torch.zeros_like(s)
        if t.shape[-1]:
            for i, r in _chunks(t, n):
                x = t[i, r] - m[i, r, None]
                s[i, r] = x.exp_().sum(-1)
                del x
            col, inside = _columns(j, t.shape[-1])
            pick = torch.where(inside, torch.gather(
                t[:, :n], -1, col[..., None])[..., 0].to(acc), 0.0)
        ctx.save_for_backward(t, m, j)
        return s, pick

    @staticmethod
    def backward(ctx, g_s, g_l):
        t, m, j = ctx.saved_tensors
        n = j.shape[1]
        grad = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        grad[:, n:].zero_()
        if t.shape[-1]:
            col, inside = _columns(j, t.shape[-1])
            g_l = torch.where(inside, g_l, 0.0)
            for i, r in _chunks(t, n):
                x = t[i, r] - m[i, r, None]
                x.exp_().mul_(g_s[i, r, None])
                x.scatter_add_(-1, col[i, r, None], g_l[i, r, None])
                grad[i, r] = x
                del x
        return grad, None, None, None


def _columns(j: torch.Tensor, v: int):
    """Labels ``j`` shifted to a slice of ``v`` columns: each clamped
    into the slice, and whether it fell inside."""
    return j.clamp(0, v - 1), (j >= 0) & (j < v)


def row_max(t: torch.Tensor) -> torch.Tensor:
    """The row max of logits ``t`` in :func:`acc_type`, detached; -inf
    where the slice is empty (a short vocab's last ranks), so the max
    over ranks is the row's."""
    t = t.detach()
    if t.shape[-1] == 0:
        return t.new_full(t.shape[:-1], float("-inf"), dtype=acc_type(
            t.dtype))
    return t.amax(-1).to(acc_type(t.dtype))


def lse_and_label(t: torch.Tensor, labels: torch.Tensor):
    """``(logsumexp(t, -1), t[..., labels])`` of the first n positions of
    logits ``t`` (b, s, V) on the whole vocab, for ``labels`` (b, n), in
    :func:`acc_type`; the max of a row that is not finite shifts by 0, as
    ``torch.logsumexp`` does."""
    m = row_max(t[:, :labels.shape[1]])
    m = torch.where(torch.isfinite(m), m, 0.0)
    s, pick = SliceSums.apply(t, m, labels, 0)
    return m + torch.log(s), pick
