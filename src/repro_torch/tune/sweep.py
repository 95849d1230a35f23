"""Time one stencil kernel over launch plans and shapes on the card.

    python -m repro_torch.tune.sweep stencil3d7pt --shape 512 512 512 \\
        --tile 32 64 --tile 16 64 [--points 4 8] [--stages 5 8] \\
        [--chunk 64 512] [--shape ...] [--seed 0]

A plan is a CTA tile ``(bj, bi)``, the points (rows) each thread owns,
the ring's stages (``csrc/stencil_ring.cuh``) and the output planes each
CTA marches through (its k chunk).  The sweep takes every ``--tile`` with
every ``--points``, ``--stages`` and ``--chunk``; without ``--tile`` the
advisor's tile, without ``--points`` the advisor's points per thread, and
without ``--stages`` or ``--chunk`` what the advisor's rules give the plan
(:func:`repro_torch.core.blocking.ring_plan`).  Plans
the kernel cannot take are listed as refused.

Prints one line per (shape, plan): the kernel's median time
(:func:`repro_torch.tune.measure.time_cuda`), its share of the bound
(:func:`repro_torch.tune.stencil.bound_seconds`), the plan's CTAs per SM
and bytes in flight per SM, and the advisor's plan marked ``*``; and per
shape the time of one ``torch.Tensor.copy_`` moving the same bytes (each
input read once, the output written once), the practical streaming rate
the kernel competes with.  It runs on the card only.
"""
from __future__ import annotations

import argparse

import torch

from ..core import blocking
from . import measure, stencil


def copy_yardstick(nbytes: int) -> measure.TimedRun:
    """One ``torch.Tensor.copy_`` on the card that reads and writes
    ``nbytes`` in all (half each way)."""
    src = torch.empty(nbytes // 8, device="cuda")
    dst = torch.empty_like(src)
    return measure.time_cuda(lambda: dst.copy_(src))


def plans(name: str, shape, tiles=None, points=None, stages=None,
          chunks=None):
    """The plans to time on ``shape``: (launch tuple, StencilPlan or the
    refusal message)."""
    mod = stencil.family(name).module
    pick = blocking.stencil_cta_tile(mod.RADIUS, tuple(shape), mod.OWN)
    out = []
    for bj, bi in tiles or [(pick.bj, pick.bi)]:
        for c in points or [pick.c]:
            for s in stages or [None]:
                for k in chunks or [None]:
                    try:
                        p = (blocking.ring_plan(mod.RADIUS, shape, bj, bi, c,
                                                mod.OWN, k) if s is None else
                             blocking.make_plan(mod.RADIUS, shape, bj, bi, c,
                                                s, k, mod.OWN))
                        if p is None:
                            raise ValueError("no stage count fits")
                        out.append((p.launch, p))
                    except ValueError as e:
                        out.append(((bj, bi, c, s, k), str(e)))
    return pick, out


def sweep(name: str, shapes, tiles=None, points=None, stages=None,
          chunks=None, seed: int = 0) -> list[dict]:
    fam = stencil.family(name)
    wrapper = getattr(fam.module, name)
    rows = []
    for shape in shapes:
        args = stencil.make_inputs(name, shape, "cuda", seed)
        bound = stencil.bound_seconds(name, args)
        t_copy = copy_yardstick(bound.bytes)
        pick, todo = plans(name, shape, tiles, points, stages, chunks)
        for launch, p in todo:
            row = {"shape": tuple(shape), "plan": launch,
                   "advisor": launch == pick.launch,
                   "bound_ms": bound.seconds * 1e3,
                   "copy_ms": t_copy.wall_s * 1e3}
            if isinstance(p, str):
                row["refused"] = p
            else:
                run = measure.time_cuda(lambda: wrapper(*args, tile=p))
                row.update(ms=run.wall_s * 1e3, ctas=p.ctas,
                           ctas_per_sm=p.ctas_per_sm,
                           in_flight_per_sm=p.in_flight_per_sm,
                           smem_bytes=p.smem_bytes, threads=p.threads)
            rows.append(row)
        del args
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("family", choices=sorted(stencil.FAMILIES))
    ap.add_argument("--shape", nargs=3, type=int, action="append",
                    required=True, metavar=("M", "N", "N"))
    ap.add_argument("--tile", nargs=2, type=int, action="append",
                    metavar=("BJ", "BI"))
    ap.add_argument("--points", nargs="+", type=int,
                    help="points (rows) per thread")
    ap.add_argument("--stages", nargs="+", type=int, help="ring stages")
    ap.add_argument("--chunk", nargs="+", type=int,
                    help="output planes per CTA (the march's k chunk)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs a CUDA card")
    print(f"{torch.cuda.get_device_name(0)}; {args.family}")
    for r in sweep(args.family, args.shape, args.tile, args.points,
                   args.stages, args.chunk, args.seed):
        head = (f"{str(r['shape']):18s} plan {str(r['plan']):22s}"
                f"{'*' if r['advisor'] else ' '}")
        if "refused" in r:
            print(f"{head} refused: {r['refused']}")
            continue
        print(f"{head} {r['ms']:9.4f} ms  {r['bound_ms'] / r['ms']:6.1%} of "
              f"the bound {r['bound_ms']:.4f} ms; {r['threads']} threads, "
              f"{r['ctas']} CTAs, {r['ctas_per_sm']} CTA/SM, {r['in_flight_per_sm'] / 1024:.0f}"
              f" KiB in flight/SM; copy_ of the same bytes "
              f"{r['copy_ms']:.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
