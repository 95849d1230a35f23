#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Phases, each fatal on failure (non-zero exit, no result line), each
followed by its seconds:
  1. device  — name, count, torch/CUDA versions, ``nvidia-smi`` name and
               power limit, SM count and L2 size against the machine file;
  2. build   — the five CUDA sources from ``src/repro_torch/csrc`` with
               nvcc for sm_90a, in parallel; build seconds, the ptxas
               report (registers, spills) of every kernel instantiation
               (the head-dim-256 ones and every stencil instantiation must
               not spill), the advisor's stencil plans (shared bytes,
               threads) against each stencil library's
               ``repro_<kernel>_limits`` at the main-path and ragged
               shapes, the count of HGMMA
               (tensor-core) instructions in each flash library's SASS
               (``cuobjdump -sass``, positive for both tensor-core
               libraries), and the launch limits of every wgmma and bf16x3
               instantiation as the library states them against
               ``launch_limits``, at the instantiated head dims and at 112
               (padded to 128);
  3. check   — each kernel against its plain PyTorch version on the card,
               at the reference tolerances: the stencils at ragged shapes,
               at the ring's edges (N below one tile, M <= 2r, M below
               the stages) and at the main-path shape, each printing its
               launch plan (boundaries bit-exact); the
               bf16x3 split pass bit-exact against ``plain_split``; flash
               attention on all three routes — bf16 on the tensor cores
               ("wgmma"), f32 on the tensor cores as three bf16 passes
               ("bf16x3"), and both types off those sets on the CUDA cores
               ("simt": blocks (64, 32), head_dim 100) — at head_dim
               32/64/96/128/256 and 40/112/136 (padded), causal and full,
               the decode shape (1, 32, 128, 4096), padded q blocks
               (16, 32), and every feasible candidate of the seq-256 tune
               spaces, in both types; each case prints the route whose
               launch counter moved, and the worst error is kept per
               (route, dtype);
  4. main    — the stencil case study at full size: the 7-point stencil at
               (512, 512, 512) and the long-range stencil at the paper's §3
               size (130, 1015, 1015), fp32.  Per stencil: ECM and Roofline
               prediction on the H100 machine file, a run through the
               ``ops`` wrappers, the launch plan (tile, points per thread,
               stages, CTAs and bytes in flight per SM), CUDA-event
               timing, a ``copy_`` of the same bytes, the plain version's
               and (7-point) ``conv3d``'s times, and the HBM bound;
  5. tune    — ``tune flash_attention`` at granite-8b's attention (32
               heads, head_dim 128, bf16, causal, batch 1, seq 4096):
               predict every candidate, measure the top 4 and the default
               in spawned children, derive calibration and write it to a
               copy of the machine file under ``build/``; then one launch
               at the chosen blocks in this process, held against the
               plain version and timed beside the plain version, SDPA
               (the yardstick only) and the bound.  The chosen blocks
               must take the wgmma route, and its counter must move;
  6. f32     — ``tune flash_attention`` at the same attention in float32
               (top 4 and the default measured in spawned children, no
               calibration written); the chosen blocks must take the
               bf16x3 route: one launch held against the plain version,
               timed with its split pass (the split also alone), beside
               the plain version, SDPA in f32, the three-pass bound and
               the FP32 floor; then the CUDA-core route at the same shape
               at (64, 32), a pair off the bf16x3 set, held and timed;
  7. models  — gemma-7b's attention (16 heads of 256) and zamba2-7b's (32
               heads of 112, run at 128 with zero columns) at the same
               length, in bf16 and f32: one launch at ``default_config``,
               which must take the dtype's tensor-core route, held against
               the plain version and timed beside the CUDA-core kernel at
               the pair it took before (``force_simt=True``, held too),
               the plain version, SDPA (the yardstick only) and the bound
               at the real head dim (and at the padded one); then ``tune
               flash_attention`` at gemma-7b's attention in bf16 (top 4 and
               the default measured in spawned children), whose choice
               must take the wgmma route.
     Launch counters are zeroed just before each main path (4, 5, 6, and
     each model and type of 7) and must be positive just after it (in 6:
     bf16x3, its split, simt);
  8. a JSON line naming each ported kernel (flash attention once per
     route, and once per route, model and type of 7), then the card's
     line, then ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX or of the JAX package ``repro``; it needs the
repository's ``src/repro_torch`` beside it and a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
# ragged shapes and the ring's edges: N not a multiple of 4, N below one
# tile, M <= 2r, M below the ring's stages
RAGGED = [(12, 37, 37), (20, 45, 45), (3, 9, 9), (12, 5, 5), (2, 33, 33),
          (8, 64, 64), (4, 40, 40)]
MAIN = {"stencil3d7pt": (512, 512, 512), "longrange3d": (130, 1015, 1015)}
# tolerances of the reference's own kernel tests (tests/test_kernels.py):
# the kernel contracts a*b+c into FMAs and the plain version does not
TOL = {"stencil3d7pt": dict(rtol=2e-5, atol=1e-6),
       "longrange3d": dict(rtol=2e-4, atol=1e-5)}
REPLACES = {"stencil3d7pt": "src/repro/kernels/stencil3d7pt.py:77",
            "longrange3d": "src/repro/kernels/longrange3d.py:91",
            "flash_attention": "src/repro/kernels/flash_attention.py:150"}
# the kernels line's entry per flash route
FA_ENTRY = {"wgmma": "flash_attention", "simt": "flash_attention_simt",
            "bf16x3": "flash_attention_bf16x3"}
# the tensor-core route of each type
TC_ROUTE = {torch.float32: "bf16x3", torch.bfloat16: "wgmma"}
# flash attention: the reference's tolerances (tests/test_kernels.py)
FA_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
# granite-8b's attention (src/repro/configs/granite_8b.py: 32 heads of
# 128) at the train_4k length, bf16, causal, batch 1
GRANITE = {"batch": 1, "heads": 32, "seq_q": 4096, "seq_kv": 4096,
           "head_dim": 128, "causal": True, "dtype": "bfloat16"}
GRANITE_F32 = {**GRANITE, "dtype": "float32"}
# the CUDA-core route's pair at the granite shape in f32: off the bf16x3
# set (block_kv 32), the fastest simt pair measured at this shape
SIMT_BLOCKS = (64, 32)
# gemma-7b (src/repro/configs/gemma_7b.py: 16 heads of 256, kv 16) and
# zamba2-7b (src/repro/configs/zamba2_7b.py: 32 heads of 112, kv 32) at
# the same length; the tensor-core routes pad 112 to 128
REAL_MODELS = {"gemma-7b": {**GRANITE, "heads": 16, "head_dim": 256},
               "zamba2-7b": {**GRANITE, "heads": 32, "head_dim": 112}}
# the pair each took on the CUDA cores before their head dims had a
# tensor-core route: default_config's (64, 64) row, its block_kv halved
# at 256 until the fp32-staged tiles fit a CTA
SIMT_BEFORE = {"gemma-7b": (64, 32), "zamba2-7b": (64, 64)}
TC_KERNEL = re.compile(r"_ZN\w*?(flash_attention_(?:wgmma|bf16x3)_kernel)"
                       r"ILi(\d+)ELi(\d+)ELi(\d+)E\w*")
STENCIL_KERNEL = re.compile(r"_ZN\w*?(stencil3d7pt|longrange3d)_kernel"
                            r"ILi(\d+)E\w*")
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers")


class SmokeError(RuntimeError):
    pass


_PHASE = {"name": "", "t0": 0.0, "start": time.perf_counter()}


def phase(name: str) -> None:
    """Print the last phase's seconds, then the next phase's heading."""
    now = time.perf_counter()
    if _PHASE["name"]:
        print(f"  [{_PHASE['name']}: {now - _PHASE['t0']:.1f} s]")
    _PHASE.update(name=name, t0=now)
    print(f"\n=== {name} ===", flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def compare(name: str, got, want, halo: int) -> tuple[float, float]:
    """Max abs and max rel error of ``got`` against ``want`` (rel over
    ``max(|want|, atol)``), within tolerance, and a bit-exact boundary of
    width ``halo``; raises SmokeError otherwise."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise SmokeError(f"{name}: shape {tuple(got.shape)} or non-finite "
                         "values")
    err = (got - want).abs()
    bad = err > TOL[name]["atol"] + TOL[name]["rtol"] * want.abs()
    if bad.any():
        raise SmokeError(f"{name} {tuple(got.shape)}: {int(bad.sum())} "
                         f"values outside {TOL[name]}, max abs err "
                         f"{err.max().item():.3e}")
    inner = torch.zeros_like(got, dtype=torch.bool)
    M, N, _ = got.shape
    if M > 2 * halo and N > 2 * halo:
        inner[halo:-halo, halo:-halo, halo:-halo] = True
    if not torch.equal(got[~inner], want[~inner]):
        raise SmokeError(f"{name} {tuple(got.shape)}: boundary not a "
                         "bit-exact copy")
    rel = err / want.abs().clamp_min(TOL[name]["atol"])
    return err.max().item(), rel.max().item()


def check_kernel(name: str, shape, fam, stencil, ops) -> float:
    """The kernel (through its ops wrapper) against its plain version on
    the same inputs on the card; returns the max abs error."""
    args = stencil.make_inputs(name, shape, "cuda", SEED)
    got = fam.op(*args)
    want = fam.module.plain(*args)
    torch.cuda.synchronize()
    err, rel = compare(name, got, want, fam.module.RADIUS)
    plan = ops.plan(fam.module, args[0])
    print(f"  {name:13s} {str(shape):17s} plan {plan.launch} max abs err "
          f"{err:.3e}  max rel err {rel:.3e}  ok")
    return err


def conv3d_yardstick(a, coeffs):
    """One ``torch.nn.functional.conv3d`` computing the 7-point interior
    (timed only, as the library's figure; the port never calls it)."""
    cW, cE, cN, cS, cF, cB, s = coeffs
    w = torch.zeros(1, 1, 3, 3, 3, device=a.device, dtype=a.dtype)
    w[0, 0, 1, 1, 0], w[0, 0, 1, 1, 2] = cW, cE
    w[0, 0, 1, 0, 1], w[0, 0, 1, 2, 1] = cN, cS
    w[0, 0, 0, 1, 1], w[0, 0, 2, 1, 1] = cF, cB
    w[0, 0, 1, 1, 1] = s
    x = a.view(1, 1, *a.shape)
    return lambda: torch.nn.functional.conv3d(x, w)


def main_path(name: str, fam, stencil, measure) -> dict:
    shape = MAIN[name]
    pred = stencil.predict_seconds(name, shape, "H100")
    print(f"  {name} {shape} fp32, predicted on the H100 machine file at "
          f"{pred.cores} cores:")
    print(f"    ECM {pred.ecm.notation()}  overlapped "
          f"{[(n, round(c, 3)) for n, c in pred.ecm.overlapped]}")
    print(f"    ECM {pred.ecm_s * 1e3:.4f} ms   Roofline "
          f"{pred.roofline_s * 1e3:.4f} ms (bottleneck "
          f"{pred.roofline.bottleneck})")
    args = stencil.make_inputs(name, shape, "cuda", SEED)
    out = fam.op(*args)                      # the run through ops
    t_kernel = measure.time_cuda(lambda: fam.op(*args))
    torch.cuda.synchronize()
    if out.shape != shape or not torch.isfinite(out).all():
        raise SmokeError(f"{name}: main-path output not finite {shape}")
    return {"pred": pred, "args": args, "out": out, "t_kernel": t_kernel}


def report(name: str, run: dict, stencil, measure, h100, card: str, ops,
           sweep) -> dict:
    """Plain-version, ``copy_`` and library timings, the bound, the launch
    plan, and the kernels-line entry for one main-path run (launches are
    filled in by the caller)."""
    fam, args, pred = stencil.family(name), run["args"], run["pred"]
    plan = ops.plan(fam.module, args[0])
    err, rel = compare(name, run["out"], fam.module.plain(*args),
                       fam.module.RADIUS)
    t_plain = measure.time_cuda(lambda: fam.module.plain(*args), iters=3)
    lib_ms = None
    if name == "stencil3d7pt":
        conv = conv3d_yardstick(args[0], args[1])
        ref = conv()
        lib_err = (ref[0, 0] - run["out"][1:-1, 1:-1, 1:-1]).abs().max().item()
        if lib_err > 1e-4:
            raise SmokeError(f"conv3d yardstick disagrees by {lib_err:.3e}")
        lib_ms = measure.time_cuda(conv).wall_s * 1e3
    bound = stencil.bound_seconds(name, args, h100)
    ms = run["t_kernel"].wall_s * 1e3
    bound_ms = bound.seconds * 1e3
    copy_ms = sweep.copy_yardstick(bound.bytes).wall_s * 1e3
    print(f"  {name} {MAIN[name]} on {card}:")
    print(f"    plan     tile ({plan.bj}, {plan.bi}), {plan.c} points per "
          f"thread, {plan.stages} stages ({plan.ahead} planes in flight), "
          f"chunks of {plan.chunk} planes, {plan.ctas} CTAs of "
          f"{plan.threads} threads, {plan.smem_bytes} B shared, "
          f"{plan.ctas_per_sm} CTA/SM, {plan.in_flight_per_sm} B in flight "
          f"per SM, {plan.words_per_point:.3f} words fetched per point")
    print(f"    kernel   {ms:.4f} ms  ({bound.bytes / (ms / 1e3) / 1e12:.3f}"
          f" TB/s effective, {bound_ms / ms:.1%} of the bound)")
    print(f"    copy_    {copy_ms:.4f} ms for the same bytes "
          f"({bound_ms / copy_ms:.1%} of the bound)")
    print(f"    bound    {bound_ms:.4f} ms by {bound.by}  (bytes: "
          f"{bound.bytes / 1e9:.3f} GB at {h100.hbm_bandwidth / 1e12:.2f} "
          f"TB/s, {bound.bytes_s * 1e3:.4f} ms; ops at "
          f"{h100.peak_flops['FP32'] / 1e12:.0f} TFLOP/s fp32, "
          f"{bound.ops_s * 1e3:.4f} ms)")
    print(f"    plain    {t_plain.wall_s * 1e3:.4f} ms")
    print(f"    library  " + (f"{lib_ms:.4f} ms (conv3d, cudnn tf32 off)"
                               if lib_ms is not None else "none"))
    print(f"    predicted ECM {pred.ecm_s * 1e3:.4f} ms "
          f"(measured/predicted {ms / (pred.ecm_s * 1e3):.3f}), Roofline "
          f"{pred.roofline_s * 1e3:.4f} ms "
          f"(measured/predicted {ms / (pred.roofline_s * 1e3):.3f})")
    print(f"    main-path max abs err vs plain {err:.3e}, max rel err "
          f"{rel:.3e}")
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": err, "ms": ms,
            "plain_ms": t_plain.wall_s * 1e3, "bound_ms": bound_ms,
            "bound_by": bound.by,
            "library_ms": lib_ms, "copy_ms": copy_ms,
            "plan": {"tile": [plan.bj, plan.bi], "c": plan.c,
                     "stages": plan.stages, "chunk": plan.chunk,
                     "ctas": plan.ctas, "ctas_per_sm": plan.ctas_per_sm,
                     "in_flight_per_sm": plan.in_flight_per_sm}}


def fa_compare(what: str, got, want, dtype) -> float:
    """Max abs error of a flash result against the plain version, within
    the reference tolerance ``|got - want| <= tol + tol * |want|``."""
    tol = FA_TOL[dtype]
    if got.shape != want.shape or got.dtype != dtype \
            or not torch.isfinite(got.float()).all():
        raise SmokeError(f"flash_attention {what}: shape, dtype or "
                         "non-finite values")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    if bad.any():
        raise SmokeError(f"flash_attention {what}: {int(bad.sum())} values "
                         f"outside {tol}, max abs err {err.max().item():.3e}")
    return err.max().item()


def qkv(shape_q, skv: int, dtype, seed: int):
    """q, k, v normal from ``seed``, made on the card in fp32, rounded."""
    b, h, _, d = shape_q
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in (shape_q, (b, h, skv, d), (b, h, skv, d))]


def routed(fa, call):
    """``call()`` and the one flash route whose launch counter it moved."""
    n0 = dict(fa.flash_attention.launches_by_route)
    out = call()
    moved = [r for r, n in fa.flash_attention.launches_by_route.items()
             if n != n0[r]]
    if len(moved) != 1:
        raise SmokeError(f"flash_attention launched on {moved or 'no route'}"
                         ", not on one")
    return out, moved[0]


def check_split(fa) -> float:
    """The split kernel bit-exact against ``plain_split`` on the card, at
    the decode shape's q against 4096 keys, values spread over 40
    binades; returns the max abs difference of its halves (0)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def draw(shape):
        x = torch.randn(shape, generator=gen, device="cuda")
        e = torch.randint(-20, 20, shape, generator=gen, device="cuda")
        return x * torch.exp2(e.float())
    xs = [draw((1, 32, n, 128)) for n in (128, 4096, 4096)]
    n0 = fa.split_bf16x3.launches
    halves = fa.split_bf16x3(*xs)
    torch.cuda.synchronize()
    if fa.split_bf16x3.launches != n0 + 1:
        raise SmokeError("split_bf16x3 did not count one launch")
    err = 0.0
    for name, (hi, lo), x in zip("qkv", halves, xs):
        want = fa.plain_split(x)
        for got, w, part in ((hi, want[0], "hi"), (lo, want[1], "lo")):
            if not torch.equal(got.view(torch.int16), w.view(torch.int16)):
                raise SmokeError(f"split {name} {part} differs from "
                                 "plain_split")
            err = max(err, (got.float() - w.float()).abs().max().item())
    print(f"  bf16x3 split of q {tuple(xs[0].shape)}, k and v "
          f"{tuple(xs[1].shape)}: hi and lo bit-exact against plain_split")
    return err


def check_flash(fa, ops, space) -> dict[tuple[str, str], float]:
    """Every flash route against the plain version on the card; returns
    the max abs error per (route, dtype)."""
    worst: dict[tuple[str, str], float] = {}

    def case(what: str, call, want, dtype, expect: str) -> str:
        got, route = routed(fa, call)
        if route != expect:
            raise SmokeError(f"flash {what} ran on {route}, not {expect}")
        err = fa_compare(what, got, want, dtype)
        key = (route, str(dtype)[6:])
        worst[key] = max(worst.get(key, 0.0), err)
        return f"{route:6s} max abs err {err:.3e}  ok"

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        expect = TC_ROUTE[dtype]
        for d in (32, 40, 64, 96, 112, 128, 136, 256):
            for causal in (True, False):
                q, k, v = qkv((2, 4, 256, d), 512, dtype, seed=d)
                what = f"{name} d={d} causal={causal}"
                res = case(what, lambda: ops.flash_attention(
                    q, k, v, causal=causal), fa.plain(q, k, v, causal=causal),
                    dtype, expect)
                print(f"  flash (2, 4, 256, {d}) kv 512 {what:28s} {res}")
        q, k, v = qkv((1, 32, 128, 128), 4096, dtype, seed=1)
        res = case(f"decode {name}", lambda: ops.flash_attention(q, k, v),
                   fa.plain(q, k, v), dtype, expect)
        print(f"  flash decode (1, 32, 128, 128) kv 4096 (q_offset 3968) "
              f"{name}: {res}")
        q, k, v = qkv((2, 4, 96, 64), 256, dtype, seed=3)
        want = fa.plain(q, k, v)
        for bq in (16, 32):
            res = case(f"padded block_q={bq} {name}", lambda: fa.flash_attention(
                q, k, v, block_q=bq, block_kv=64), want, dtype, expect)
            print(f"  flash (2, 4, 96, 64) kv 256 {name} causal, blocks "
                  f"({bq}, 64) in a 64-row tile: {res}")
        # off every tensor-core set: the CUDA-core route
        q, k, v = qkv((2, 4, 256, 128), 512, dtype, seed=4)
        res = case(f"{name} blocks {SIMT_BLOCKS}", lambda: fa.flash_attention(
            q, k, v, block_q=SIMT_BLOCKS[0], block_kv=SIMT_BLOCKS[1]),
            fa.plain(q, k, v), dtype, "simt")
        print(f"  flash (2, 4, 256, 128) kv 512 {name} blocks {SIMT_BLOCKS}: "
              f"{res}")
        # a head dim off tc_head_dim (not a multiple of 8)
        q, k, v = qkv((2, 4, 256, 100), 512, dtype, seed=5)
        res = case(f"{name} d=100", lambda: ops.flash_attention(q, k, v),
                   fa.plain(q, k, v), dtype, "simt")
        print(f"  flash (2, 4, 256, 100) kv 512 {name} through ops: {res}")
    for dtype in ("float32", "bfloat16"):
        sp = space.resolve_space("flash_attention", "H100", batch=1,
                                 heads=4, seq_q=256, seq_kv=256,
                                 head_dim=128, causal=True, dtype=dtype)
        cands = sp.candidates()
        q, k, v = sp.inputs("cuda", seed=2)
        want = fa.plain(q, k, v)
        counts = dict.fromkeys(fa.SOURCES, 0)
        for c, pred in zip(cands, sp.predict(cands)):
            if not pred.feasible:
                continue
            bq, bkv = c.config["block_q"], c.config["block_kv"]
            case(f"candidate {bq}x{bkv} {dtype}", lambda: fa.flash_attention(
                q, k, v, block_q=bq, block_kv=bkv), want, q.dtype,
                sp.route(c))
            counts[sp.route(c)] += 1
        torch.cuda.synchronize()
        print(f"  flash: all {sum(counts.values())} feasible candidates of "
              f"{len(cands)} in the seq-256 {dtype} space launch and match, "
              f"by route {counts}")
    print("  worst max abs err per (route, dtype): " + ", ".join(
        f"{r} {t} {e:.3e}" for (r, t), e in sorted(worst.items())))
    return worst


def print_ratios(rep, fa, config) -> None:
    """measured / predicted of every measured candidate, with its route."""
    for c in rep.measured_outcomes:
        bq, bkv = c.params["block_q"], c.params["block_kv"]
        route = fa.route(bq, bkv, config["head_dim"], config["dtype"])
        meas = c.measured_s
        ratio = "-" if meas is None else f"{meas / c.predicted_s:.3f}"
        print(f"    ({bq}, {bkv}) {route:6s} predicted "
              f"{c.predicted_s * 1e3:.4f} ms, measured "
              + ("-" if meas is None else f"{meas * 1e3:.4f} ms")
              + f", measured/predicted {ratio}")


def tune_path(fa, space, tune_mod, measure, machine_mod, config: dict,
              expect: str, calibrate: bool) -> dict:
    """The tuner at ``config``, with calibration written to a copy of the
    machine file under build/ when ``calibrate``, and one launch at the
    chosen blocks, which must take the ``expect`` route; on bf16x3 the
    split pass is also timed alone."""
    rep = tune_mod.tune("flash_attention", "H100", config=config, top_k=4,
                        isolate=True, device="cuda")
    print("  " + rep.render().replace("\n", "\n  "))
    print_ratios(rep, fa, config)
    if rep.n_failed or rep.measured_chosen_s is None:
        raise SmokeError("tune flash_attention measured no candidate or "
                         "lost one")
    factor = None
    if calibrate:
        h100_yaml = tune_mod.machine_yaml_path("H100")
        cal_copy = ROOT / "build" / "chip_smoke" / h100_yaml.name
        cal_copy.parent.mkdir(parents=True, exist_ok=True)
        cal_copy.write_text(h100_yaml.read_text())
        tune_mod.apply_calibration(cal_copy, rep.calibration)
        factor = machine_mod.Machine.from_yaml(cal_copy).calibration_factor(
            "time", "flash_attention")
        print(f"  calibration written to {cal_copy.relative_to(ROOT)}; "
              f"reloaded: time[flash_attention] = {factor:.6g}")
    sp = space.resolve_space("flash_attention", "H100", **config)
    q, k, v = sp.inputs("cuda")
    bq, bkv = rep.chosen_params["block_q"], rep.chosen_params["block_kv"]
    route = fa.route(bq, bkv, config["head_dim"], q.dtype)
    if route != expect:
        raise SmokeError(f"the tuner chose ({bq}, {bkv}), which takes the "
                         f"{route} route, not {expect}")
    out, ran = routed(fa, lambda: fa.flash_attention(
        q, k, v, block_q=bq, block_kv=bkv))
    if ran != expect:
        raise SmokeError(f"the chosen blocks launched on {ran}")
    t_kernel = measure.time_cuda(
        lambda: fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv),
        warmup=1, iters=3, reps=5)
    run = {"report": rep, "qkv": (q, k, v), "out": out, "route": route,
           "blocks": (bq, bkv), "t_kernel": t_kernel, "factor": factor}
    if route == "bf16x3":
        run["t_split"] = measure.time_cuda(lambda: fa.split_bf16x3(q, k, v),
                                           warmup=1, iters=3, reps=5)
    torch.cuda.synchronize()
    return run


def simt_path(fa, space, measure) -> dict:
    """The same attention in float32 on the CUDA-core route, at
    :data:`SIMT_BLOCKS`, a pair off the bf16x3 set."""
    sp = space.resolve_space("flash_attention", "H100", **GRANITE_F32)
    q, k, v = sp.inputs("cuda")
    bq, bkv = SIMT_BLOCKS

    def call():
        return fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
    out, route = routed(fa, call)
    if route != "simt":
        raise SmokeError(f"f32 attention at {SIMT_BLOCKS} launched on "
                         f"{route}, not simt")
    t_kernel = measure.time_cuda(call, warmup=1, iters=3, reps=5)
    torch.cuda.synchronize()
    return {"report": None, "qkv": (q, k, v), "out": out, "route": route,
            "blocks": (bq, bkv), "t_kernel": t_kernel}


def flash_report(run: dict, fa, space, measure, h100, card: str,
                 yard: dict) -> dict:
    """Plain-version and SDPA timings (once per dtype, kept in ``yard``:
    every run of a dtype has the same seeded inputs), the bound, and the
    kernels-line entry for one flash main-path run (launches filled in by
    the caller)."""
    q, k, v = run["qkv"]
    rep, route = run["report"], run["route"]
    name = str(q.dtype)[6:]
    err = fa_compare(f"granite {name} {route}", run["out"], fa.plain(q, k, v),
                     q.dtype)
    if name not in yard:
        t_plain = measure.time_cuda(lambda: fa.plain(q, k, v), warmup=1,
                                    iters=2, reps=3)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True)
        # SDPA's causal mask is top-left aligned: it equals the kernel's
        # only at seq_q == seq_kv, which the granite shape has
        fa_compare(f"SDPA yardstick {name}", sdpa(), run["out"], q.dtype)
        yard[name] = (t_plain.wall_s * 1e3, measure.time_cuda(sdpa).wall_s
                      * 1e3)
    plain_ms, lib_ms = yard[name]
    bound = space.attention_bound(q, k, causal=True, machine=h100)
    ms = run["t_kernel"].wall_s * 1e3
    bq, bkv = run["blocks"]
    unit = ("bf16, one pass" if q.dtype == torch.bfloat16
            else "bf16, three passes")
    print(f"  flash_attention {tuple(q.shape)} {name} causal, route {route}"
          f", blocks ({bq}, {bkv}) on {card}:")
    print(f"    kernel   {ms:.4f} ms  ({bound.seconds * 1e3 / ms:.1%} of the "
          f"bound)")
    print(f"    bound    {bound.seconds * 1e3:.4f} ms by {bound.by} "
          f"({bound.ops_s * 1e3:.4f} ms of operations at "
          f"{h100.peak_flops['BF16'] / 1e12:.0f} TFLOP/s, {unit}; "
          f"{bound.bytes / 1e6:.1f} MB at {h100.hbm_bandwidth / 1e12:.2f} "
          f"TB/s, {bound.bytes_s * 1e3:.4f} ms)")
    entry = {"name": FA_ENTRY[route], "route": "cuda",
             "source": f"src/repro_torch/csrc/{fa.SOURCES[route]}.cu",
             "replaces": REPLACES["flash_attention"], "launches": 0,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound.seconds * 1e3, "bound_by": bound.by,
             "library_ms": lib_ms}
    if q.dtype == torch.float32:
        floor = space.attention_bound(q, k, causal=True, machine=h100,
                                      unit="FP32")
        entry["fp32_cores_bound_ms"] = floor.seconds * 1e3
        print(f"    FP32     {floor.seconds * 1e3:.4f} ms, the floor of the "
              f"CUDA cores at {h100.peak_flops['FP32'] / 1e12:.0f} TFLOP/s "
              f"({floor.seconds * 1e3 / ms:.1%} of it)")
    if "t_split" in run:
        split_ms = run["t_split"].wall_s * 1e3
        moved = fa.split_bytes(q.numel(), k.numel())
        split_bound = moved / h100.hbm_bandwidth * 1e3
        entry.update(split_ms=split_ms, split_bound_ms=split_bound)
        print(f"    split    {split_ms:.4f} ms of it, alone ({moved / 1e6:.1f}"
              f" MB, bound {split_bound:.4f} ms by bytes, "
              f"{split_bound / split_ms:.1%} of it); the attention kernel "
              f"{ms - split_ms:.4f} ms")
    print(f"    plain    {plain_ms:.4f} ms")
    print(f"    library  {lib_ms:.4f} ms (scaled_dot_product_attention, "
          "yardstick only)")
    if rep is not None:
        print(f"    tuner predicted {rep.predicted_chosen_s * 1e3:.4f} ms "
              f"(measured/predicted "
              f"{ms / (rep.predicted_chosen_s * 1e3):.3f})")
    print(f"    max abs err vs plain {err:.3e}")
    return entry


def model_path(model: str, dtype: str, fa, space, measure, h100,
               card: str) -> dict:
    """One model's attention in ``dtype`` at ``default_config``, which must
    launch on the dtype's tensor-core route; held against the plain
    version and timed beside the CUDA-core kernel at the pair it took
    before, the plain version, SDPA and the bound.  Returns the
    kernels-line entry (launches filled in by the caller)."""
    config = {**REAL_MODELS[model], "dtype": dtype}
    sp = space.resolve_space("flash_attention", "H100", **config)
    q, k, v = sp.inputs("cuda")
    d = config["head_dim"]
    expect = TC_ROUTE[q.dtype]
    bq, bkv = fa.default_config(config["seq_q"], config["seq_kv"], d,
                                q.dtype)
    if fa.route(bq, bkv, d, q.dtype) != expect:
        raise SmokeError(f"{model} {dtype}: default_config ({bq}, {bkv}) "
                         f"takes {fa.route(bq, bkv, d, q.dtype)}, not "
                         f"{expect}")

    def call():
        return fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
    sb = SIMT_BEFORE[model]

    def simt():
        return fa.flash_attention(q, k, v, block_q=sb[0], block_kv=sb[1],
                                  force_simt=True)
    out, ran = routed(fa, call)
    if ran != expect:
        raise SmokeError(f"{model} {dtype} at ({bq}, {bkv}) launched on "
                         f"{ran}, where route() says {expect}")
    want = fa.plain(q, k, v)
    err = fa_compare(f"{model} {dtype} {ran}", out, want, q.dtype)
    got_simt, ran_simt = routed(fa, simt)
    if ran_simt != "simt":
        raise SmokeError(f"force_simt=True launched on {ran_simt}")
    simt_err = fa_compare(f"{model} {dtype} simt", got_simt, want, q.dtype)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
    fa_compare(f"SDPA yardstick {model} {dtype}", sdpa(), out, q.dtype)
    del want, got_simt
    t_tc = measure.time_cuda(call, warmup=1, iters=3, reps=5).wall_s * 1e3
    t_simt = measure.time_cuda(simt, warmup=0, iters=1,
                               reps=3).wall_s * 1e3
    t_plain = measure.time_cuda(lambda: fa.plain(q, k, v), warmup=1,
                                iters=1, reps=3).wall_s * 1e3
    t_sdpa = measure.time_cuda(sdpa, warmup=1, iters=3, reps=5).wall_s * 1e3
    torch.cuda.synchronize()
    bound = space.attention_bound(q, k, causal=True, machine=h100)
    b_ms = bound.seconds * 1e3
    D = fa.tc_head_dim(d)
    print(f"  {model} {tuple(q.shape)} {dtype} causal on {card}:")
    print(f"    {ran:6s}   {t_tc:.4f} ms at default_config ({bq}, {bkv}), "
          f"{b_ms / t_tc:.1%} of the bound"
          + (f" ({b_ms * D / d / t_tc:.1%} of the head-dim-{D} work it "
             "does)" if D != d else ""))
    print(f"    simt     {t_simt:.4f} ms at {sb}, the pair it ran at before "
          f"({t_simt / t_tc:.1f}x the {ran} time)")
    print(f"    bound    {b_ms:.4f} ms by {bound.by} at head dim {d}")
    print(f"    plain    {t_plain:.4f} ms")
    print(f"    library  {t_sdpa:.4f} ms (scaled_dot_product_attention, "
          "yardstick only)")
    print(f"    max abs err vs plain: {ran} {err:.3e}, simt {simt_err:.3e}")
    return {"name": f"{FA_ENTRY[ran]}[{model}]", "route": "cuda",
            "source": f"src/repro_torch/csrc/{fa.SOURCES[ran]}.cu",
            "replaces": REPLACES["flash_attention"], "launches": 0,
            "max_abs_err": err, "ms": t_tc, "plain_ms": t_plain,
            "bound_ms": b_ms, "bound_by": bound.by, "library_ms": t_sdpa,
            "head_dim": d, "dtype": dtype, "blocks": [bq, bkv],
            "padded_bound_ms": b_ms * D / d, "simt_ms": t_simt,
            "simt_blocks": list(sb), "simt_max_abs_err": simt_err}


def sass_hgmma(_build, name: str) -> int:
    """HGMMA (wgmma) instructions in the SASS of a built library."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise SmokeError(f"cuobjdump -sass failed on {name}: "
                         f"{proc.stderr.strip()[-2000:]}")
    return sum("HGMMA" in ln for ln in proc.stdout.splitlines())


def tc_ptxas(info: dict) -> dict[tuple, tuple[int, int]]:
    """(registers, spill bytes stored) of every tensor-core kernel
    instantiation, keyed (kernel, D, BKV, NWG), from the ptxas report:
    a "Compiling entry function" line, then its spill line, then its
    register line."""
    out, key = {}, None
    for d in info.values():
        for ln in d["ptxas"]:
            m = TC_KERNEL.search(ln)
            if "Compiling" in ln:
                key = (m[1], *map(int, m.groups()[1:])) if m else None
            elif key and SPILL.search(ln):
                out[key] = (0, int(SPILL.search(ln)[1]))
            elif key and USED.search(ln):
                out[key] = (int(USED.search(ln)[1]), out[key][1])
    return out


def check_build(_build, fa, info: dict) -> dict[str, int]:
    """The ptxas report (no spill at head dim 256), the HGMMA counts, and
    the tensor-core libraries' launch limits against ``launch_limits``;
    returns the HGMMA count per flash library."""
    for name, d in info.items():
        print(f"  {name}: {d['seconds']:.1f} s")
        for ln in d["ptxas"]:
            print("    " + TC_KERNEL.sub(
                lambda m: f"{m[1]}<D={m[2]}, BKV={m[3]}, NWG={m[4]}>", ln))
    regs = tc_ptxas(info)
    new = {k: v for k, v in regs.items() if k[1] == 256}
    if not new:
        raise SmokeError("the ptxas report names no head-dim-256 kernel")
    for (kern, D, bkv, nwg), (n, spill) in sorted(new.items()):
        print(f"  {kern}<D={D}, BKV={bkv}, NWG={nwg}>: {n} registers, "
              f"{spill} bytes spilled")
        if spill:
            raise SmokeError(f"{kern}<D={D}, BKV={bkv}, NWG={nwg}> spills "
                             f"{spill} bytes")
    hgmma = {src: sass_hgmma(_build, src) for src in fa.SOURCES.values()}
    print(f"  HGMMA instructions in the SASS: {hgmma}")
    for route in TC_ROUTE.values():
        if hgmma[fa.SOURCES[route]] <= 0:
            raise SmokeError(f"the {route} library's SASS has no HGMMA "
                             "instruction")
    for route, dtype, compiled in (
            ("wgmma", torch.bfloat16, fa.compiled_wgmma_limits),
            ("bf16x3", torch.float32, fa.compiled_bf16x3_limits)):
        n = refused = 0
        for d in fa.WGMMA_HEAD_DIMS + (112,):
            for bkv in fa.WGMMA_BLOCK_KV:
                for bq in fa.WGMMA_BLOCK_Q:
                    if fa.route(bq, bkv, d, dtype) != route:
                        try:        # the library must refuse it too
                            compiled(bq, bkv, d)
                        except RuntimeError:
                            refused += 1
                            continue
                        raise SmokeError(f"the {route} library states "
                                         f"limits for ({bq}, {bkv}) d={d}, "
                                         "off its set")
                    lim = fa.launch_limits(bq, bkv, d, dtype)
                    got = compiled(bq, bkv, d)
                    if lim.route != route or \
                            got != (lim.smem_bytes, lim.threads):
                        raise SmokeError(
                            f"{route} ({bq}, {bkv}) d={d}: the library "
                            f"states {got}, launch_limits "
                            f"{(lim.smem_bytes, lim.threads)} on "
                            f"{lim.route}")
                    n += 1
        print(f"  {route} launch limits: the library and launch_limits "
              f"agree on all {n} (block_q, block_kv, head_dim) of the set, "
              f"at the instantiated head dims and at 112; {refused} off "
              "the set refused by both")
    return hgmma


def check_stencil_build(_build, ops, stencil, info: dict) -> None:
    """No stencil kernel instantiation spills, and the advisor's shared
    bytes and threads agree with each library's ``repro_<kernel>_limits``
    at the main-path and ragged shapes."""
    key, spills = None, {}
    for name in MAIN:
        for ln in info[name]["ptxas"]:
            m = STENCIL_KERNEL.search(ln)
            if "Compiling" in ln:
                key = f"{m[1]}<C={m[2]}>" if m else None
            elif key and SPILL.search(ln):
                spills[key] = int(SPILL.search(ln)[1])
    print(f"  stencil spill stores (bytes): {spills}")
    if len(spills) != 2 * 4 or any(spills.values()):
        raise SmokeError(f"a stencil kernel spills or is missing: {spills}")
    for name in MAIN:
        mod = stencil.family(name).module
        for shape in RAGGED + [MAIN[name]]:
            plan = ops.blocking.stencil_cta_tile(mod.RADIUS, shape, mod.OWN)
            got = _build.compiled_limits(name, plan.launch)
            if got != (plan.smem_bytes, plan.threads):
                raise SmokeError(f"{name} {shape} plan {plan.launch}: the "
                                 f"library states {got}, the advisor "
                                 f"{(plan.smem_bytes, plan.threads)}")
        print(f"  {name}: advisor and repro_{name}_limits agree at "
              f"{len(RAGGED) + 1} shapes; main-path plan "
              f"{ops.blocking.stencil_cta_tile(mod.RADIUS, MAIN[name], mod.OWN).launch}")


def smoke(out_path: str | None) -> int:
    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is False: this smoke "
                         "test runs on a CUDA card only")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        raise SmokeError(f"no src/repro_torch beside {__file__}: run it "
                         "from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch import tune as tune_mod
    from repro_torch.core import machine as machine_mod
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.tune import measure, space, stencil, sweep

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = nvidia_smi()
    props = torch.cuda.get_device_properties(0)
    h100 = machine_mod.load("H100")
    print(f"device {kind!r}, count {count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {card}")
    print(f"SMs {props.multi_processor_count} (machine file "
          f"{h100.extra['SM count']}), L2 "
          f"{getattr(props, 'L2_cache_size', 0)} B (machine file "
          f"{h100.levels[-1].size_bytes:.0f} B)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("2 build")
    t0 = time.perf_counter()
    info = _build.build_all()
    print(f"built {sorted(info)} in {time.perf_counter() - t0:.1f} s "
          "(parallel nvcc, sm_90a)")
    hgmma = check_build(_build, fa, info)
    check_stencil_build(_build, ops, stencil, info)

    phase("3 check against the plain versions on the card")
    max_err = {}
    for name in MAIN:
        fam = stencil.family(name)
        for shape in RAGGED + [MAIN[name]]:
            err = check_kernel(name, shape, fam, stencil, ops)
            max_err[name] = max(max_err.get(name, 0.0), err)
    split_err = check_split(fa)
    fa_err = check_flash(fa, ops, space)

    phase("4 main path at full size")
    # each family's kernel wrapper carries the family's name
    wrappers = {n: getattr(stencil.family(n).module, n) for n in MAIN}
    for w in wrappers.values():
        w.launches = 0
    runs = {name: main_path(name, stencil.family(name), stencil, measure)
            for name in MAIN}
    launches = {n: w.launches for n, w in wrappers.items()}
    print(f"  launches during the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise SmokeError(f"main path never launched the {name} kernel")
    entries, predicted = [], {}
    for name, run in runs.items():
        e = report(name, run, stencil, measure, h100, card, ops, sweep)
        e["launches"] = launches[name]
        e["max_abs_err"] = max(max_err[name], e["max_abs_err"])
        predicted[name] = {"ecm_ms": run["pred"].ecm_s * 1e3,
                           "roofline_ms": run["pred"].roofline_s * 1e3}
        entries.append(e)
        del run["args"], run["out"]
        torch.cuda.empty_cache()

    phase("5 tune flash_attention at granite-8b's attention")
    counts = fa.flash_attention.launches_by_route
    for r in counts:
        counts[r] = 0
    for w in wrappers.values():
        w.launches = 0
    fa_run = tune_path(fa, space, tune_mod, measure, machine_mod, GRANITE,
                       "wgmma", calibrate=True)
    fa_launches = dict(counts)
    print(f"  launches in this process during the tune path: {fa_launches} "
          "(the measuring runs are in spawned children)")
    if fa_launches["wgmma"] <= 0:
        raise SmokeError("tune path never launched the wgmma flash kernel")
    rep = fa_run["report"]
    predicted["flash_attention"] = {
        "tuner_predicted_ms": rep.predicted_chosen_s * 1e3,
        "candidates": [c.to_dict() for c in rep.measured_outcomes],
        "calibration": rep.calibration,
        "chosen": rep.chosen_params, "default": rep.default_params}
    flash_runs = {"wgmma": fa_run}
    launches.update({FA_ENTRY["wgmma"]: fa_launches["wgmma"]})

    phase("6 the same attention in float32: tune on bf16x3, then simt")
    for r in counts:
        counts[r] = 0
    fa.split_bf16x3.launches = 0
    flash_runs["bf16x3"] = tune_path(fa, space, tune_mod, measure,
                                     machine_mod, GRANITE_F32, "bf16x3",
                                     calibrate=False)
    flash_runs["simt"] = simt_path(fa, space, measure)
    fa_launches = dict(counts)
    split_launches = fa.split_bf16x3.launches
    print(f"  launches in this process during the f32 path: {fa_launches}, "
          f"split {split_launches} (the measuring runs are in spawned "
          "children)")
    for r in ("bf16x3", "simt"):
        if fa_launches[r] <= 0:
            raise SmokeError(f"f32 path never launched the {r} flash kernel")
        launches[FA_ENTRY[r]] = fa_launches[r]
    if split_launches <= 0:
        raise SmokeError("f32 path never launched the bf16x3 split kernel")
    rep = flash_runs["bf16x3"]["report"]
    predicted["flash_attention_f32"] = {
        "tuner_predicted_ms": rep.predicted_chosen_s * 1e3,
        "candidates": [c.to_dict() for c in rep.measured_outcomes],
        "calibration": rep.calibration,
        "chosen": rep.chosen_params, "default": rep.default_params}
    yard: dict = {}
    for route, run in flash_runs.items():
        e = flash_report(run, fa, space, measure, h100, card, yard)
        dtype = str(run["qkv"][0].dtype)[6:]
        e["launches"] = launches[e["name"]]
        e["max_abs_err"] = max(fa_err.get((route, dtype), 0.0),
                               e["max_abs_err"])
        if route == "bf16x3":
            e.update(split_launches=split_launches,
                     split_max_abs_err=split_err)
        if route == "simt":   # the same kernel in bf16, off the wgmma set
            e["max_abs_err_bfloat16"] = fa_err[("simt", "bfloat16")]
        entries.append(e)
        run.clear()
        torch.cuda.empty_cache()
    predicted["hgmma_in_sass"] = hgmma

    phase("7 gemma-7b's and zamba2-7b's attention on the tensor cores")
    for model in REAL_MODELS:
        for dtype in ("bfloat16", "float32"):
            for r in counts:
                counts[r] = 0
            fa.split_bf16x3.launches = 0
            e = model_path(model, dtype, fa, space, measure, h100, card)
            by_route = dict(counts)
            print(f"    launches: {by_route}, split "
                  f"{fa.split_bf16x3.launches}")
            route = TC_ROUTE[fa.torch_dtype(dtype)]
            split = fa.split_bf16x3.launches
            if by_route[route] <= 0 or by_route["simt"] <= 0 or \
                    (route == "bf16x3") != (split > 0):
                raise SmokeError(f"{model} {dtype} never launched {route} "
                                 "or simt, or its split pass is amiss")
            e["launches"] = by_route[route]
            e["simt_launches"] = by_route["simt"]
            if split:
                e["split_launches"] = split
            entries.append(e)
            torch.cuda.empty_cache()
    for r in counts:
        counts[r] = 0
    gemma = {**REAL_MODELS["gemma-7b"], "dtype": "bfloat16"}
    g_run = tune_path(fa, space, tune_mod, measure, machine_mod, gemma,
                      "wgmma", calibrate=False)
    print(f"  chosen {g_run['blocks']} in this process: "
          f"{g_run['t_kernel'].wall_s * 1e3:.4f} ms; launches {dict(counts)}")
    if counts["wgmma"] <= 0:
        raise SmokeError("the gemma-7b tune never launched wgmma")
    rep = g_run["report"]
    predicted["flash_attention_gemma_7b"] = {
        "tuner_predicted_ms": rep.predicted_chosen_s * 1e3,
        "candidates": [c.to_dict() for c in rep.measured_outcomes],
        "chosen": rep.chosen_params, "default": rep.default_params}
    g_run.clear()
    torch.cuda.empty_cache()

    phase("8 result")
    result = {"kernels": entries}
    if out_path:
        pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(out_path).write_text(json.dumps(
            {**result, "predicted": predicted, "card": card, "device": kind,
             "torch": torch.__version__, "cuda": torch.version.cuda,
             "build": info}, indent=2))
    print(f"  [total: {time.perf_counter() - _PHASE['start']:.1f} s]")
    print(json.dumps(result))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full results as JSON here")
    args = ap.parse_args()
    try:
        return smoke(args.out)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
