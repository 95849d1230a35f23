"""End-to-end training on the PyTorch/CUDA port: train a ~100M-parameter
granite-family model for a few hundred steps with the full production
substrate — synthetic data pipeline, AdamW + cosine schedule, grad
accumulation, async checkpoints, watchdog, resume — with causal
attention on the flash kernel under autograd.

The default invocation is small (~10M params, 120 steps); pass --full for
the 100M x 300-step run.  It trains on the card unless ``--device cpu``
is named (there the flash wrapper runs its plain version).

    PYTHONPATH=src python examples/torch_train_100m.py [--full] [--steps N]
        [--device cpu] [--ckpt-dir DIR]

Checkpoints go to ``build/examples/train_100m`` under the repository by
default; re-running resumes from the latest one.
"""
import argparse
import dataclasses
import pathlib
import time

import torch

from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import attention
from repro_torch.models.common import dtype_of
from repro_torch.models.lm import LM
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, Trainer

ROOT = pathlib.Path(__file__).resolve().parent.parent


def build_cfg(full: bool):
    base = configs.get_config("granite-8b")
    if full:     # ~100M params
        return dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=2048, vocab=32768, tp=1)
    return dataclasses.replace(       # ~10M params
        base, n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
        head_dim=32, d_ff=1024, vocab=8192, tp=1)


def flash_against_plain(cfg, batch: int, seq: int, dev) -> float:
    """The model's flash call (``attention.flash``: kv heads broadcast,
    rows rounded to the kernel's blocks) on seeded unit-normal operands
    at a microbatch's shape and the model's activation type, held
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
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir",
                    default=str(ROOT / "build" / "examples" / "train_100m"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    steps = args.steps or (300 if args.full else 120)

    cfg = build_cfg(args.full)
    model = LM(cfg)
    n = cfg.param_count()
    print(f"model: {n / 1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model} ff={cfg.d_ff} v={cfg.vocab})")

    data = SyntheticLM(vocab=cfg.vocab, seq=256 if args.full else 128,
                       global_batch=16 if args.full else 8)
    tcfg = TrainConfig(
        opt=OptConfig(lr=3e-3, weight_decay=0.01),
        microbatches=2, warmup_steps=steps // 10, total_steps=steps)
    pathlib.Path(args.ckpt_dir).parent.mkdir(parents=True, exist_ok=True)
    trainer = Trainer(model, data, tcfg, ckpt_dir=args.ckpt_dir,
                      ckpt_every=50,
                      log_path=f"{args.ckpt_dir}_metrics.jsonl",
                      device=args.device)
    counts = fa.flash_attention.launches_by_route
    before = dict(counts)
    t0 = time.perf_counter()
    trainer.run(steps, generator=torch.Generator(trainer.device)
                .manual_seed(0))
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    dt = time.perf_counter() - t0
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    if not losses:
        print(f"nothing to do: the checkpoint in {args.ckpt_dir} is at "
              f"step {steps} already")
        return 0
    k = max(1, len(losses) // 10)
    print(f"loss: first-{k}-avg {sum(losses[:k]) / k:.3f} -> "
          f"last-{k}-avg {sum(losses[-k:]) / k:.3f} over {len(losses)} "
          f"steps on {trainer.device} in {dt:.2f} s (host clock, "
          "checkpoints included)")
    print(f"stragglers flagged: {trainer.watchdog.straggler_steps}")
    print(f"checkpoints in {args.ckpt_dir} (resume by re-running)")
    launched = {r: counts[r] - before[r] for r in counts if counts[r] >
                before[r]}
    route = (f"flash attention {launched} (launches by route)" if launched
             else "plain PyTorch attention (cpu, no launch)")
    print(f"route: {route}")
    if trainer.device.type == "cuda" and not launched:
        raise RuntimeError("training on the card never launched the flash "
                           "kernel")
    err = flash_against_plain(cfg, data.global_batch // tcfg.microbatches,
                              data.seq, trainer.device)
    print(f"flash kernel == plain attention at a microbatch's shape on "
          f"{trainer.device} (max abs err {err:.3g}; rtol 2e-2, atol 2e-2)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
