"""The port's command line: the ``tune`` subcommand of ``python -m repro``.

    python -m repro_torch tune {flash_attention|stencil3d7pt|longrange3d} \\
        -m H100 \\
        [--shape NAME VALUE]... [--top-k K] [--no-measure] [--warmup N] \\
        [--reps N] [--timeout-s S] [--no-isolate] \\
        [--apply-calibration [YAML]] [--device cuda|cpu] [--json]

It takes the JAX command's options, minus ``--cache-dir`` (the result
store is not ported), plus ``--device``.  The JAX command's ``analyze``,
``sweep``, ``blocking`` and ``machine validate`` run lint's preflight and
its text reports, and wait for them (ROADMAP.md Queue 1, item 7); their
library faces are :func:`repro_torch.core.analyze`,
:func:`~repro_torch.core.sweep` and
:func:`repro_torch.core.blocking.grid_search`.  Measurement runs on the card
unless ``--device cpu`` is given; ``--no-measure`` touches no device.
Exit codes: 0 success, 2 a bad request (unknown family, shape key or
machine).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from .core import api


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Kerncraft reproduction, PyTorch/CUDA port")
    sub = ap.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("tune",
                        help="model-driven autotuner: rank a kernel "
                             "family's configurations analytically, "
                             "measure the top-k on the device, derive "
                             "machine calibration factors")
    sp.add_argument("family",
                    help="kernel family: flash_attention, stencil3d7pt, "
                         "or longrange3d")
    sp.add_argument("-m", "--machine", required=True,
                    help="machine description: short name (H100), "
                         "bundled yaml name, or path")
    sp.add_argument("--shape", nargs=2, action="append", default=[],
                    metavar=("NAME", "VALUE"),
                    help="override a problem-shape value, e.g. --shape "
                         "seq_q 2048 (repeatable)")
    sp.add_argument("--top-k", type=int, default=4,
                    help="predicted-best candidates to measure, beyond "
                         "the shipped default (default 4)")
    meas = sp.add_mutually_exclusive_group()
    meas.add_argument("--measure", dest="measure", action="store_true",
                      default=True,
                      help="measure the shortlist on the device (default)")
    meas.add_argument("--no-measure", dest="measure", action="store_false",
                      help="stop after the analytic ranking")
    sp.add_argument("--warmup", type=int, default=1,
                    help="untimed invocations per candidate (default 1)")
    sp.add_argument("--reps", type=int, default=3,
                    help="timed samples per candidate; the reported wall "
                         "is the IQR-robust median (default 3)")
    sp.add_argument("--timeout-s", type=float, default=120.0,
                    help="per-candidate subprocess wall clock "
                         "(default 120)")
    sp.add_argument("--no-isolate", dest="isolate", action="store_false",
                    default=True,
                    help="time in-process instead of per-candidate "
                         "subprocesses (faster, no crash/timeout "
                         "protection)")
    sp.add_argument("--apply-calibration", nargs="?", const="auto",
                    default=None, metavar="YAML",
                    help="write the derived calibration factors into the "
                         "machine YAML (default: the file -m resolved to)")
    sp.add_argument("--device", default=None,
                    help="device to measure on: cuda (default) or cpu")
    sp.add_argument("--json", action="store_true",
                    help="emit the TuneReport as JSON")
    return ap


def cmd_tune(args) -> int:
    from . import tune as tune_mod
    machine = api.resolve_machine(args.machine)
    config = {}
    for name, value in args.shape:
        try:
            config[name] = int(value)
        except ValueError:
            config[name] = value        # dtype=..., causal=... stay strings
    rep = tune_mod.tune(args.family, machine, config=config or None,
                        top_k=args.top_k, measure=args.measure,
                        warmup=args.warmup, reps=args.reps,
                        timeout_s=args.timeout_s, isolate=args.isolate,
                        device=args.device,
                        session=api.get_session(machine))
    applied = None
    if args.apply_calibration is not None:
        if not rep.calibration:
            print("warning: no calibration derived (nothing measured "
                  "successfully); machine YAML left untouched",
                  file=sys.stderr)
        else:
            path = (tune_mod.machine_yaml_path(args.machine)
                    if args.apply_calibration == "auto"
                    else pathlib.Path(args.apply_calibration))
            tune_mod.apply_calibration(path, rep.calibration)
            applied = str(path)
    if args.json:
        payload = rep.to_dict()
        if applied:
            payload["calibration_written_to"] = applied
        print(json.dumps(payload, indent=2, sort_keys=True))
        return 0
    print(rep.render())
    if applied:
        print(f"calibration written to {applied}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return {"tune": cmd_tune}[args.command](args)
    except (ValueError, TypeError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
