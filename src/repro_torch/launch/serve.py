"""Serving launcher: a reduced-config engine behind the batched request
driver, with random weights from a seed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --requests 8 --max-new 16 [--device cpu] [--seed 0]

Counterpart of ``repro.launch.serve``, with ``--device`` (the card unless
``cpu`` is named) and ``--seed`` (parameters and prompts, each from its
own ``torch.Generator``).
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import configs
from .. import device as _device
from ..models.common import materialize
from ..models.lm import LM
from ..serve import BatchedServer, Engine, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-8b", choices=configs.ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = configs.reduced(configs.get_config(args.arch))
    model = LM(cfg)
    params = materialize(model.param_recs(),
                         torch.Generator(dev).manual_seed(args.seed))
    engine = Engine(model, params, max_len=args.max_len)
    server = BatchedServer(engine, batch_size=args.batch_size)
    prompts = torch.Generator().manual_seed(args.seed)

    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = torch.randint(0, cfg.vocab, (1 + i % 7,),
                               generator=prompts).tolist()
        server.submit(Request(uid=i, tokens=prompt, max_new=args.max_new))
    done = server.drain()
    dt = time.perf_counter() - t0
    toks = sum(len(r.result) for r in done)
    print(f"[serve] {args.arch} (reduced) on {dev}: {len(done)} requests, "
          f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s), "
          f"batches={server._served}")
    for r in done[:3]:
        print(f"  req {r.uid}: {r.tokens} -> {r.result[:8]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
