"""Batched serving on the PyTorch/CUDA port: a small model served through
the Engine + BatchedServer request loop — prefill (causal attention on the
flash kernel), KV-cached decode, bucketed request batching, throughput
report.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

The reduced granite-8b config with random weights from seed 0, on
the card unless ``--device cpu`` is named (there the flash wrapper runs
its plain version).  The engine runs eagerly, so the second wave's
throughput differs from the first's only by warm-up (the kernels' first
load, the allocator).
"""
import argparse
import time

import torch

from repro_torch import configs
from repro_torch import device as _device
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import attention
from repro_torch.models.common import dtype_of, materialize
from repro_torch.models.lm import LM
from repro_torch.serve import BatchedServer, Engine, Request

PROMPTS = [[7, 3, 9], [1, 2], [5, 5, 5, 5], [11, 12, 13],
           [2], [8, 1, 6, 4, 2], [9, 9], [3, 1, 4, 1, 5]]


def wave(server: BatchedServer, first_uid: int) -> tuple:
    """Serve PROMPTS once: (requests done, seconds)."""
    t0 = time.perf_counter()
    for i, p in enumerate(PROMPTS):
        server.submit(Request(uid=first_uid + i, tokens=p, max_new=12))
    done = server.drain()
    return done, time.perf_counter() - t0


def flash_against_plain(cfg, batch: int, seq: int, dev) -> float:
    """The model's flash call (``attention.flash``: kv heads broadcast,
    rows rounded to the kernel's blocks) on seeded unit-normal operands
    at a bucket's prefill shape and the model's activation type, held
    against the plain attention (``kernels.ref.attention``) at the
    reference tolerance for bfloat16, rtol = atol = 2e-2.  Returns the
    max abs error."""
    g = torch.Generator().manual_seed(0)
    dt = dtype_of(cfg.act_dtype)
    q = torch.randn(batch, seq, cfg.n_heads, cfg.head_dim, generator=g)
    k, v = (torch.randn(batch, seq, cfg.n_kv_heads, cfg.head_dim,
                        generator=g) for _ in range(2))
    q, k, v = (t.to(dev, dt) for t in (q, k, v))
    rep = cfg.n_heads // cfg.n_kv_heads
    with torch.no_grad():
        out = attention.flash(q, k, v, q_offset=0).float()
        want = ref.attention(*(t.repeat_interleave(n, 2).transpose(1, 2)
                               for t, n in ((q, 1), (k, rep), (v, rep)))
                             ).transpose(1, 2).float()
    torch.testing.assert_close(out, want, rtol=2e-2, atol=2e-2)
    return float((out - want).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    cfg = configs.reduced(configs.get_config("granite-8b"))
    model = LM(cfg)
    params = materialize(model.param_recs(),
                         torch.Generator(dev).manual_seed(0))
    engine = Engine(model, params, max_len=128)
    server = BatchedServer(engine, batch_size=4)

    counts = fa.flash_attention.launches_by_route
    before = dict(counts)
    done, dt = wave(server, 0)
    tok = sum(len(r.result) for r in done)
    print(f"served {len(done)} requests / {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s incl. warm-up) on {dev}")
    for r in done:
        print(f"  req {r.uid}: prompt {r.tokens} -> {r.result}")

    # the second wave runs on the warmed-up engine (steady state)
    again, dt = wave(server, 100)
    tok = sum(len(r.result) for r in again)
    print(f"steady state: {tok} tokens in {dt:.2f}s ({tok / dt:.1f} tok/s)")
    if [r.result for r in again] != [r.result for r in done]:
        raise RuntimeError("the second wave's greedy tokens differ from the "
                           "first's")
    launched = {r: counts[r] - before[r] for r in counts if counts[r] >
                before[r]}
    route = (f"flash attention {launched} (launches by route)" if launched
             else "plain PyTorch attention (cpu, no launch)")
    print(f"route: {route}")
    if dev.type == "cuda" and not launched:
        raise RuntimeError("serving on the card never launched the flash "
                           "kernel")
    err = flash_against_plain(cfg, server.batch_size,
                              max(len(p) for p in PROMPTS), dev)
    print(f"flash kernel == plain attention at the prefill's shape on {dev} "
          f"(max abs err {err:.3g}; rtol 2e-2, atol 2e-2)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
