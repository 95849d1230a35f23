"""Serving engine: KV-cache trees, prefill and decode steps, a batched
generate loop, and a request-queue driver (bucketed batching).

Counterpart of ``repro.serve.engine``.  The engine runs eager, on the
device its parameters are on: no ``jax.jit`` counterpart and no
``torch.compile`` of the model.  Causal prefill runs on the flash kernel
(:mod:`repro_torch.models.attention`).  Greedy decoding at temperature 0 is JAX's; above 0 the engine samples
with the caller's ``torch.Generator``: reproducible, but not JAX's random
stream.
"""
from __future__ import annotations

import dataclasses
import queue
import time

import torch

from ..models.common import dtype_of, materialize


def make_caches(model, batch: int, max_len: int, device=None):
    """Zero-init cache tree mirroring the model's stage structure on
    ``device`` (the CPU by default); entries default to the model's
    activation dtype."""
    return materialize(model.cache_recs(batch, max_len),
                       default_dtype=dtype_of(model.cfg.act_dtype),
                       device=device)


@dataclasses.dataclass
class Request:
    uid: int
    tokens: list[int]
    max_new: int = 16
    result: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Static-batch generation engine: prefill, then one decode step per
    new token, on the device of ``params``."""

    def __init__(self, model, params, max_len: int):
        self.model, self.params, self.max_len = model, params, max_len
        self.device = params["embed"].device

    def prefill(self, batch, caches):
        return self.model.prefill(self.params, batch, caches)

    def decode(self, caches, tokens, pos: int):
        return self.model.decode_step(self.params, caches, tokens, pos)

    def _sample(self, logits, temperature: float,
                generator: torch.Generator | None):
        if temperature == 0.0:
            return torch.argmax(logits[:, -1], dim=-1)[:, None]
        probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)

    @torch.inference_mode()
    def generate(self, tokens: torch.Tensor, n_new: int,
                 temperature: float = 0.0,
                 generator: torch.Generator | None = None,
                 extras: dict | None = None) -> torch.Tensor:
        """tokens: (b, s0) integer prompt.  Returns (b, n_new) generated
        ids.  Sampling above temperature 0 draws from ``generator`` (one
        seeded with 0 on the engine's device when None)."""
        b, s0 = tokens.shape
        if s0 + n_new > self.max_len:
            raise ValueError(f"a prompt of {s0} tokens and {n_new} new ones "
                             f"exceed max_len={self.max_len}")
        if temperature != 0.0 and generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        tokens = tokens.to(self.device)
        caches = make_caches(self.model, b, self.max_len, self.device)
        logits, caches = self.prefill({"tokens": tokens, **(extras or {})},
                                      caches)
        tok = self._sample(logits, temperature, generator)
        out = [tok]
        for i in range(1, n_new):
            logits, caches = self.decode(caches, tok, s0 + i - 1)
            tok = self._sample(logits, temperature, generator)
            out.append(tok)
        return torch.cat(out, dim=1)


class BatchedServer:
    """Request-queue driver: buckets queued requests into fixed batch
    slots, left-pads each bucket's prompts with token 0 to its longest,
    runs the Engine per bucket.  A stand-in for continuous batching at
    the driver level."""

    def __init__(self, engine: Engine, batch_size: int = 4,
                 max_wait_s: float = 0.0):
        self.engine = engine
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        self._queue: queue.Queue[Request] = queue.Queue()
        self._served: list[int] = []    # batch sizes actually used

    def submit(self, req: Request):
        self._queue.put(req)

    def drain(self) -> list[Request]:
        """Serve everything currently queued; returns completed requests."""
        done = []
        while not self._queue.empty():
            bucket: list[Request] = []
            t0 = time.perf_counter()
            while (len(bucket) < self.batch_size
                   and (not self._queue.empty()
                        or time.perf_counter() - t0 < self.max_wait_s)):
                try:
                    bucket.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            if not bucket:
                break
            s_max = max(len(r.tokens) for r in bucket)
            n_new = max(r.max_new for r in bucket)
            toks = torch.tensor([[0] * (s_max - len(r.tokens)) + r.tokens
                                 for r in bucket], dtype=torch.long)
            gen = self.engine.generate(toks, n_new).cpu()
            self._served.append(len(bucket))
            for i, r in enumerate(bucket):
                r.result = gen[i, :r.max_new].tolist()
                r.done = True
                done.append(r)
        return done
