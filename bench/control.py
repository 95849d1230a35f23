"""Readings the limits of ``correct`` are set from, on the chip at a
cell's own size (not part of a benchmark run):

    python3 bench/control.py --workload <cell> --seeds S [S ...] [--faults K]

For every seed: the program's first steps against the plain reference
(the lower readings, from sound runs).  For the first ``--faults``
seeds also the control, the reference computed with its products in
float8 e4m3 and put in the program's place, and the program with each
planted fault of ``bench/faults.py`` that needs a run.  One JSON line
per seed on standard output.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEVICE = "cuda"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import check, faults, harness
    cell = harness.load_cell(args.workload)
    n = cell.workload["checked_steps"]
    keep = ("loss_gap", "grad_gap", "change_gap", "grad_at", "change_at")

    def program(seed, fault=None):
        t0 = time.perf_counter()
        if fault is None:
            prog = harness.Program(cell, seed, DEVICE)
            rec = prog.checked_steps(n)
        else:
            with faults.FAULTS[fault]():
                prog = harness.Program(cell, seed, DEVICE)
                rec = prog.checked_steps(n)
        pool = prog.pool
        del prog
        harness.free(DEVICE)
        return rec, pool, time.perf_counter() - t0

    for i, seed in enumerate(args.seeds):
        row: dict = {"cell": cell.name, "seed": seed}
        rec, pool, row["program_s"] = program(seed)
        t0 = time.perf_counter()
        ref = harness.reference_record(cell, seed, pool, DEVICE)
        row["reference_s"] = time.perf_counter() - t0
        harness.free(DEVICE)
        r = check.readings(rec, ref)
        row["program"] = {k: r[k] for k in keep}
        row["losses"] = {"program": rec["loss"], "reference": ref["loss"]}
        if i < args.faults:
            t0 = time.perf_counter()
            ctl = harness.reference_record(cell, seed, pool, DEVICE,
                                           "fp8")
            row["control_s"] = time.perf_counter() - t0
            harness.free(DEVICE)
            r = check.readings(ctl, ref)
            row["control"] = {k: r[k] for k in keep}
            for fault in ("half_batch", "layer_grad_dropped"):
                frec, _, _ = program(seed, fault)
                r = check.readings(frec, ref)
                row[fault] = {k: r[k] for k in keep}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
