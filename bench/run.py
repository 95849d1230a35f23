"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It exits non-zero and prints no result
where no CUDA card is visible or fewer than the cell asks for.  Its last
line on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number the correctness check
compared, beside its limit.  The same numbers are the last lines on
standard error.  A run whose process holds ``jax``, ``jaxlib``, ``flax``
or the JAX package ``repro`` once the window has closed exits non-zero
and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: caches of the program and its libraries, at fixed paths in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "build/bench/torch_extensions",
          "TRITON_CACHE_DIR": "build/bench/triton",
          "CUDA_CACHE_PATH": "build/bench/cuda_cache"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    out, rec = harness.run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda", T_START,
                                log=lambda m: print(m, file=sys.stderr))
    found = harness.forbidden_modules()
    if found:
        print(f"modules loaded that a run may not load: {found}",
              file=sys.stderr)
        return 3
    v = rec["values"]
    print(f"worst slices: grad {v['grad_at']}, change {v['change_at']}; "
          f"left out of the change: {v['left_out']}", file=sys.stderr)
    print("losses: program " + " ".join(f"{x:.6f}" for x in
                                        rec["program"]["loss"])
          + "; reference " + " ".join(f"{x:.6f}" for x in
                                      rec["reference"]["loss"]),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
