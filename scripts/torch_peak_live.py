"""What is alive at the peak of one recorded training step of the port,
on fake tensors on the host (nothing is allocated, no device touched):
the peak of live bytes, the argument bytes, the host seconds of the
capture and the largest allocations alive at the peak
(``graph_analysis.GraphCapture.live_at_peak``: op, shape and dtype,
forward or backward; the first ``TOP``).

``cell``: a production ``train_4k`` cell cut to ``--layers`` layers, as
rank 0 of the fake 256-rank ``pod16x16`` group, as the dry run runs it
(``launch.dryrun.capture_cell``; the dry run itself keeps the full
depth).  ``step``: the unsharded train step of ``chip_smoke.py``'s 10b
(``TRAIN_ARCH`` at ``tp=1``, the batch, sequence and microbatches of its
``TRAIN``), ``--layers`` layers, bf16 parameters and AdamW's float32
state, in one process.

    PYTHONPATH=src python scripts/torch_peak_live.py cell --arch gemma-7b --layers 2
    PYTHONPATH=src python scripts/torch_peak_live.py step --layers 8

A cell needs a process without a default process group."""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

import torch

from repro_torch import configs

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import TRAIN, TRAIN_ARCH  # noqa: E402

#: the largest allocations alive at the peak that are printed
TOP = 12


def cell_capture(arch: str, layers: int):
    from repro_torch.launch import cell, dryrun
    from repro_torch.launch.mesh import make_production_mesh
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
    c = cell.build_cell(arch, "train_4k", cfg=cfg)
    with dryrun.fake_world(256):
        mesh = make_production_mesh(multi_pod=False, device="cpu")
        return dryrun.capture_cell(c, mesh)


def step_capture(layers: int):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import train
    from repro_torch.core import graph_analysis
    from repro_torch.models import common, lm
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH), tp=1,
                              n_layers=layers)
    model = lm.LM(cfg)
    tcfg = train.TrainConfig(microbatches=TRAIN["microbatches"])
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = common.tmap(
            lambda r: torch.empty(r.shape, dtype=r.dtype or torch.bfloat16),
            model.param_recs())
        opt = adamw_init(params, tcfg.opt)
        tokens = torch.zeros(TRAIN["batch"], TRAIN["seq"], dtype=torch.long)
        _, cap = graph_analysis.capture(
            train.make_train_step(model, tcfg), params, opt,
            {"tokens": tokens, "labels": tokens}, 0)
    return cap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["cell", "step"])
    ap.add_argument("--arch", default=TRAIN_ARCH, choices=configs.ARCH_IDS,
                    help="the cell's architecture (step: always 10b's)")
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if args.what == "cell":
        arch, cap = args.arch, cell_capture(args.arch, args.layers)
    else:
        arch, cap = TRAIN_ARCH, step_capture(args.layers)
    print(f"{args.what} {arch}, {args.layers} layers: peak "
          f"{cap.peak_bytes / 2 ** 30:.3f} GiB ({cap.peak_bytes / 1e9:.2f} "
          f"GB), arguments {cap.argument_bytes / 2 ** 30:.3f} GiB; capture "
          f"{cap.seconds:.1f} s ({time.perf_counter() - t0:.1f} s in all), "
          f"{cap.n_dispatched} ops dispatched")
    for label, n in cap.live_at_peak[:TOP]:
        print(f"  {n / 2 ** 30:8.3f} GiB  {label}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
