"""The one generator of training traffic: a pool of token batches made
on the device from the seed, from the parameters of a workload file.

The rule is the synthetic language of the program's data pipeline
(``SyntheticLM``): a row starts at a random token, and each next token
is ``(31 * previous + 7) mod vocab``, or, with probability ``noise``, a
fresh random token, so the text has bigrams a model can learn.  The
pipeline draws it on the host one position at a time; here it is
vectorised: each position is an affine map of the one before, and a
prefix scan of the maps (log2(seq) rounds of composition) gives every
position at once.  ``labels`` are the tokens shifted by one.
"""
from __future__ import annotations

import torch

from .weights import stream

MUL, ADD = 31, 7


def _scan(a: torch.Tensor, b: torch.Tensor, v: int):
    """Inclusive prefix composition of the maps x -> a x + b (mod v)
    along the last dim: afterwards map t is map_t o ... o map_0."""
    s = 1
    while s < a.shape[-1]:
        a2 = a.clone()
        b2 = b.clone()
        a2[..., s:] = (a[..., s:] * a[..., :-s]) % v
        b2[..., s:] = (a[..., s:] * b[..., :-s] + b[..., s:]) % v
        a, b = a2, b2
        s *= 2
    return a, b


def pool(workload: dict, vocab: int, seed: int, device) -> dict:
    """``{"tokens", "labels"}``, each (pool, global_batch, seq) int64."""
    g = torch.Generator(device=device).manual_seed(stream(seed, 1))
    n, b, s = workload["pool"], workload["global_batch"], workload["seq"]
    rows = n * b
    first = torch.randint(0, vocab, (rows, 1), generator=g, device=device)
    noise = torch.rand((rows, s - 1), generator=g, device=device) \
        < workload["noise"]
    fresh = torch.randint(0, vocab, (rows, s - 1), generator=g,
                          device=device)
    a = torch.where(noise, 0, MUL).to(torch.int64)
    c = torch.where(noise, fresh, ADD).to(torch.int64)
    a, c = _scan(a, c, vocab)
    toks = torch.cat([first, (a * first + c) % vocab], dim=1)
    return {"tokens": toks.view(n, b, s),
            "labels": torch.roll(toks, -1, dims=1).view(n, b, s)}


def sequential(first, noise, fresh, vocab: int):
    """The pipeline's rule one position at a time (for the tests)."""
    toks = [first[:, 0]]
    for t in range(noise.shape[1]):
        nxt = (toks[-1] * MUL + ADD) % vocab
        toks.append(torch.where(noise[:, t], fresh[:, t], nxt))
    return torch.stack(toks, dim=1)


def batch(pool_: dict, i: int) -> dict:
    """Step ``i``'s batch: the pool's entry ``i`` modulo its size."""
    k = i % pool_["tokens"].shape[0]
    return {"tokens": pool_["tokens"][k], "labels": pool_["labels"][k]}
