"""Training launcher: a reduced config trained end to end (synthetic data
pipeline, optimizer, checkpoints, watchdog), with random weights from a
seed.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --steps 100 --batch 8 --seq 128 [--ckpt-dir DIR] [--device cpu] \\
        [--seed 0]

Counterpart of ``repro.launch.train``, with ``--device`` (the card unless
``cpu`` is named) and ``--seed`` (the parameters' ``torch.Generator`` and
the data pipeline's seed).
"""
from __future__ import annotations

import argparse

import torch

from .. import configs
from .. import device as _device
from ..data import SyntheticLM
from ..models.lm import LM
from ..optim import OptConfig
from ..train import TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-8b", choices=configs.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log", default=None, help="JSONL metrics path")
    ap.add_argument("--quantize-opt", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = configs.reduced(configs.get_config(args.arch))
    model = LM(cfg)
    data = SyntheticLM(vocab=cfg.vocab, seq=args.seq,
                       global_batch=args.batch, seed=args.seed)
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, quantize_state=args.quantize_opt),
        microbatches=args.microbatches,
        warmup_steps=max(1, args.steps // 10), total_steps=args.steps)
    trainer = Trainer(model, data, tcfg, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, log_path=args.log,
                      device=dev)
    _, _, step = trainer.run(
        args.steps, generator=torch.Generator(dev).manual_seed(args.seed))
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    print(f"[train] {args.arch} reduced on {dev}: step {step}, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"stragglers={trainer.watchdog.straggler_steps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
