"""Look inside the stencil kernels on the card: their SASS, their time per
k step and a profiler trace.

    python -m repro_torch.tune.stencil_probe [--ms 64 128 256 512] [--n 512]
        [--no-profile] [--json FILE]

* **SASS** (``cuobjdump -sass`` of each built library): per kernel, the
  instructions of its outermost loop (the k march; inner loops that the
  compiler kept are counted once) by opcode: global loads and stores
  (LDG, STG), asynchronous copies (LDGSTS) and their waits (DEPBAR),
  shared loads and stores (LDS, STS), barriers (BAR).
* **Time per step**: each kernel through its ``ops`` wrapper at
  ``(M, N, N)`` for every ``M`` of ``--ms``; a least-squares line
  ``t = fixed + per_step * M`` splits the time a launch pays once from
  the time of one k step.
* **Profiler**: ``torch.profiler`` over a few launches of each kernel;
  says whether it recorded device time.

Together they say what a k step spends its time on: the copies' issue,
the shared reads or the wait at the barrier.

It runs on the card only.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import re
import subprocess

import torch

from ..kernels import _build
from . import measure, stencil

MAIN = {"stencil3d7pt": (512, 512, 512), "longrange3d": (130, 1015, 1015)}
OPS = ("LDG", "STG", "LDGSTS", "LDGDEPBAR", "DEPBAR", "LDS", "STS", "BAR",
       "SHFL", "FFMA", "FADD", "FMUL")
_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_TARGET = re.compile(r"(0x[0-9a-f]+)")


def sass(path: pathlib.Path) -> str:
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode:
        raise RuntimeError(f"cuobjdump -sass {path}: {proc.stderr[-2000:]}")
    return proc.stdout


def loop_counts(text: str) -> dict[str, dict]:
    """Per kernel function in ``cuobjdump -sass`` output: the opcode counts
    of the whole function and of its outermost loop (the widest span
    closed by a backward branch), and the number of backward branches."""
    funcs: dict[str, list[tuple[int, str, str]]] = {}
    name = None
    for ln in text.splitlines():
        m = _FUNC.search(ln)
        if m:
            name = m[1]
            funcs[name] = []
            continue
        m = _INSN.search(ln)
        if m and name:
            funcs[name].append((int(m[1], 16), m[2].split(".")[0], m[3]))
    out = {}
    for fname, insns in funcs.items():
        loops = []
        for addr, op, rest in insns:
            t = _TARGET.search(rest)
            if op == "BRA" and t and int(t[1], 16) <= addr:
                loops.append((int(t[1], 16), addr))
        lo, hi = max(loops, key=lambda s: s[1] - s[0]) if loops else (0, -1)

        def count(sel):
            c = collections.Counter(op for a, op, _ in insns if sel(a))
            return {k: c[k] for k in OPS if c[k]} | {"all": sum(c.values())}
        out[fname] = {"loop": count(lambda a: lo <= a <= hi),
                      "function": count(lambda a: True),
                      "backward_branches": len(loops)}
    return out


def per_step(name: str, ms, n: int) -> dict:
    """Kernel time at ``(M, n, n)`` for each ``M``, and the fitted fixed
    and per-step times."""
    fam = stencil.family(name)
    times = []
    for M in ms:
        args = stencil.make_inputs(name, (M, n, n), "cuda")
        times.append(measure.time_cuda(lambda: fam.op(*args)).wall_s)
        del args
        torch.cuda.empty_cache()
    k = len(ms)
    mx, my = sum(ms) / k, sum(times) / k
    sxx = sum((m - mx) ** 2 for m in ms)
    slope = sum((m - mx) * (t - my) for m, t in zip(ms, times)) / sxx \
        if sxx else 0.0
    return {"n": n, "ms": list(ms), "seconds": times,
            "per_step_s": slope, "fixed_s": my - slope * mx}


def profile(shape_m: int = 128, n: int = 512) -> dict:
    """``torch.profiler`` over three launches of each kernel: device time
    per kernel name, and whether any was recorded."""
    from torch.profiler import ProfilerActivity, profile as prof
    runs = {name: stencil.make_inputs(name, (shape_m, n, n), "cuda")
            for name in MAIN}
    for name, args in runs.items():
        stencil.family(name).op(*args)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for name, args in runs.items():
            for _ in range(3):
                stencil.family(name).op(*args)
        torch.cuda.synchronize()
    rows = {}
    for e in p.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0.0)
        if dev:
            rows[e.key] = {"device_us": dev, "count": e.count}
    return {"device_time_recorded": bool(rows), "kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ms", nargs="+", type=int, default=[64, 128, 256, 512])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--json", help="write the full results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    info = _build.build_all(tuple(MAIN))
    result: dict = {"card": smi, "sass": {}, "steps": {}}
    for name in MAIN:
        for ln in info[name]["ptxas"]:
            print(f"  {name}: {ln}")
        counts = loop_counts(sass(_build.library_path(name)))
        result["sass"][name] = counts
        for fname, c in counts.items():
            print(f"  {name} SASS {fname[:60]}: outer loop {c['loop']} "
                  f"({c['backward_branches']} backward branches); whole "
                  f"function {c['function']['all']} instructions")
    for name in MAIN:
        st = per_step(name, args.ms, args.n)
        result["steps"][name] = st
        print(f"  {name} at N={args.n}: " + ", ".join(
            f"M={m} {t * 1e3:.4f} ms" for m, t in zip(st["ms"],
                                                      st["seconds"]))
              + f"; per step {st['per_step_s'] * 1e6:.4f} us, fixed "
              f"{st['fixed_s'] * 1e6:.2f} us")
    if not args.no_profile:
        pr = profile(n=args.n)
        result["profile"] = pr
        print(f"  torch.profiler recorded device time: "
              f"{pr['device_time_recorded']}")
        for k, v in pr["kernels"].items():
            print(f"    {k[:70]}: {v['device_us']:.1f} us over {v['count']}")
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
