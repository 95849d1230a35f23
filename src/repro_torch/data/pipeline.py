"""Deterministic synthetic token pipeline.

Counterpart of ``repro.data.pipeline``, the port's own copy (that module
imports no JAX, but the port imports nothing of the JAX package).  Batches
are numpy arrays, bit-identical to JAX's for each (seed, step, host
slice); the trainer makes tensors of them on its device.

Every batch is a pure function of (seed, step, host_slice): restarts replay
identically (the fault-tolerance contract — see DESIGN.md §5), and each host
materializes only its slice of the global batch (sharded host loading).
A background :class:`Prefetcher` hides host-side latency (straggler
mitigation at the input layer).
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    """Markov-ish synthetic LM data with a learnable structure (tokens are
    correlated with their predecessors) so training losses actually fall."""

    def __init__(self, vocab: int, seq: int, global_batch: int,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0):
        assert global_batch % n_hosts == 0
        self.vocab, self.seq = vocab, seq
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seed, self.n_hosts, self.host_id = seed, n_hosts, host_id

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Tokens for `step`, this host's slice. tokens[t+1] depends on
        tokens[t] (affine map + noise mod vocab) -> learnable bigrams."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s, v = self.local_batch, self.seq, self.vocab
        first = rng.integers(0, v, size=(b, 1))
        noise = (rng.random(size=(b, s - 1)) < 0.1)
        rand = rng.integers(0, v, size=(b, s - 1))
        toks = np.empty((b, s), np.int64)
        toks[:, :1] = first
        for t in range(1, s):
            nxt = (toks[:, t - 1] * 31 + 7) % v
            toks[:, t] = np.where(noise[:, t - 1], rand[:, t - 1], nxt)
        return {"tokens": toks[:, :].astype(np.int32),
                "labels": np.roll(toks, -1, axis=1).astype(np.int32)}


class Prefetcher:
    """Background-thread batch prefetch with a bounded queue."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self._src = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._src.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
