"""Time one stencil kernel over CTA tiles and shapes on the card.

    python -m repro_torch.tune.sweep stencil3d7pt --shape 512 512 512 \\
        --tile 8 64 --tile 16 32 [--shape ...] [--seed 0]

Prints one line per (shape, tile): the kernel's median time
(:func:`repro_torch.tune.measure.time_cuda`), its share of the bound
(:func:`repro_torch.tune.stencil.bound_seconds`), and the advisor's pick
marked ``*``; and per shape the time of one ``torch.Tensor.copy_`` moving
the same bytes (each input read once, the output written once), the
practical streaming rate the kernel competes with.  With no ``--tile`` it
times the advisor's tile only.  It runs on the card only.
"""
from __future__ import annotations

import argparse

import torch

from ..core import blocking
from . import measure, stencil


def sweep(name: str, shapes, tiles, seed: int = 0) -> list[dict]:
    fam = stencil.family(name)
    wrapper = getattr(fam.module, name)
    rows = []
    for shape in shapes:
        args = stencil.make_inputs(name, shape, "cuda", seed)
        bound = stencil.bound_seconds(name, args)
        src = torch.empty(bound.bytes // 8, device="cuda")  # half the bytes
        dst = torch.empty_like(src)
        t_copy = measure.time_cuda(lambda: dst.copy_(src))
        pick = blocking.stencil_cta_tile(fam.module.RADIUS, shape)
        for tile in tiles or [(pick.bj, pick.bi)]:
            run = measure.time_cuda(lambda: wrapper(*args, tile=tile))
            rows.append({"shape": tuple(shape), "tile": tuple(tile),
                         "advisor": tuple(tile) == (pick.bj, pick.bi),
                         "ms": run.wall_s * 1e3,
                         "bound_ms": bound.seconds * 1e3,
                         "copy_ms": t_copy.wall_s * 1e3})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("family", choices=sorted(stencil.FAMILIES))
    ap.add_argument("--shape", nargs=3, type=int, action="append",
                    required=True, metavar=("M", "N", "N"))
    ap.add_argument("--tile", nargs=2, type=int, action="append",
                    metavar=("BJ", "BI"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs a CUDA card")
    print(f"{torch.cuda.get_device_name(0)}; {args.family}")
    for r in sweep(args.family, args.shape, args.tile, args.seed):
        print(f"{str(r['shape']):18s} tile {str(r['tile']):10s}"
              f"{'*' if r['advisor'] else ' '} {r['ms']:9.4f} ms  "
              f"{r['bound_ms'] / r['ms']:6.1%} of the bound "
              f"{r['bound_ms']:.4f} ms; copy_ of the same bytes "
              f"{r['copy_ms']:.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
