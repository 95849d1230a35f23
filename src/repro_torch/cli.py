"""Kerncraft-style command line of the port (``python -m repro_torch``),
the counterpart of ``python -m repro``:

    python -m repro_torch analyze stencil_3d_long_range.c -m H100 \
        -p ecm -p roofline -D M 130 -D N 1015 --cores 132
    python -m repro_torch analyze trace:stencil3d7pt -m H100 -p ecm \
        -D M 130 -D N 100
    python -m repro_torch sweep stencil_3d7pt.c -m H100 \
        --param N --range 64 1024 8 -D M 512 --dense --workers 4 \
        --cache-dir build/cache --stats
    python -m repro_torch blocking stencil_3d_long_range.c -m H100 \
        -D M 130 -D N 1015 --grid 64 1024 8
    python -m repro_torch lint stencil_3d7pt.c -m H100 [--json|--sarif]
    python -m repro_torch analyze configs/hlo/granite-8b.hlo.gz -m H100 \
        -p hlo-roofline
    python -m repro_torch machine validate [PATH ...]
    python -m repro_torch cache stats --cache-dir build/cache
    python -m repro_torch fleet --all -m H100 [--cache-dir build/cache]
    python -m repro_torch tune {flash_attention|stencil3d7pt|longrange3d} \
        -m H100 [--shape NAME VALUE]... [--top-k K] [--no-measure] \
        [--no-isolate] [--apply-calibration [YAML]] [--device cuda|cpu] \
        [--cache-dir DIR] [--json]

It mirrors the paper's UX (``kerncraft -m machine.yml -p ECM kernel.c -D N
1000``) with the JAX command's subcommands, options, output and exit
codes: 0 success, 2 a bad request (unknown name, unreadable source), 3
lint found errors (``lint``, ``machine validate``, and the cross-rule
pre-flight of ``analyze``, ``sweep`` and ``blocking``).  ``--cache-dir``
serves results through the result store of :mod:`repro_torch.service`,
whose entries either package reads.  Only ``tune`` touches a device: it
measures on the card unless ``--device cpu`` is given, and
``--no-measure`` touches none.  HLO dumps (the bundled ones resolve as
``configs/hlo/<config>.hlo.gz`` from any directory) go through
``analyze`` and ``lint`` under ``-p hlo-roofline``; ``fleet`` prices
whole modules per op.  Two defaults of ``fleet`` differ from the JAX
command's: its machine is the port's card (``H100``, not IVY and V5E),
and its artifacts go under ``build/fleet``, never into the JAX harness's
``benchmarks/out``.  The blocking analysis and the tuner, which import
torch, load only for the subcommands that run them.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import pathlib
import sys

from .core import LoopKernel, api, reports


def _add_common(sp: argparse.ArgumentParser) -> None:
    sp.add_argument("kernel",
                    help="kernel source: .c file, HLO text/dump, or "
                         "trace:<module>[:attr] point-function reference")
    sp.add_argument("-m", "--machine", required=True,
                    help="machine description: short name (H100), "
                         "bundled yaml name, or path")
    sp.add_argument("-D", "--define", nargs=2, action="append", default=[],
                    metavar=("NAME", "VALUE"),
                    help="bind a symbolic constant (repeatable)")
    sp.add_argument("--frontend", default=None,
                    choices=["c", "builder", "trace", "hlo"],
                    help="force a frontend instead of auto-detection")
    sp.add_argument("--name", default=None, help="kernel name override")
    sp.add_argument("--cache-predictor", default="LC", choices=["LC", "SIM"],
                    help="traffic predictor: layer conditions or cache "
                         "simulator (default LC)")
    sp.add_argument("--incore", default="simple",
                    choices=["simple", "ports"],
                    help="in-core model: 'simple' aggregates the machine "
                         "file's per-kind port rates, 'ports' schedules "
                         "the lowered op stream against the machine's "
                         "ports: table (per-port occupation + latency "
                         "bound; default simple)")
    sp.add_argument("--sim-backend", default="auto",
                    choices=["auto", "scalar", "vector"],
                    help="cache-simulator engine (SIM only): 'vector' runs "
                         "the NumPy address-stream backend, 'scalar' the "
                         "per-access reference; 'auto' picks vector "
                         "whenever the machine supports it (default)")
    sp.add_argument("--sim-warmup-rows", type=int, default=2, metavar="ROWS",
                    help="inner rows simulated before the statistics reset "
                         "(SIM only, default 2)")
    sp.add_argument("--sim-measure-rows", type=int, default=1, metavar="ROWS",
                    help="inner rows measured after warm-up (SIM only, "
                         "default 1)")
    sp.add_argument("--cores", type=int, default=1)
    sp.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="serve through the disk-backed result cache "
                         "rooted at DIR (repro_torch.service): warm entries "
                         "skip all model computation, misses are "
                         "computed and published for every later run")
    sp.add_argument("--stats", action="store_true",
                    help="report cache statistics (hits/misses/disk "
                         "hits/coalesced); with --json they appear "
                         "under a 'stats' key")
    sp.add_argument("--json", action="store_true",
                    help="emit machine-readable results (reports.to_json)")


def _constants(args) -> dict | None:
    if not args.define:
        return None
    return {name: int(value) for name, value in args.define}


def _sim_kwargs(args) -> dict | None:
    """Simulation options for the SIM predictor; None when LC is active so
    session cache keys stay predictor-minimal."""
    if args.cache_predictor.upper() != "SIM":
        return None
    return {"backend": args.sim_backend,
            "warmup_rows": args.sim_warmup_rows,
            "measure_rows": args.sim_measure_rows}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="analytic performance modeling of loop kernels "
                    "(Kerncraft reproduction, PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("analyze",
                        help="run performance models over one kernel")
    _add_common(sp)
    sp.add_argument("-p", "--performance-model", action="append",
                    default=None, metavar="MODEL",
                    help="registered model name (repeatable; default ecm)")

    sp = sub.add_parser("sweep", help="evaluate models over a size sweep")
    _add_common(sp)
    sp.add_argument("-p", "--performance-model", action="append",
                    default=None, metavar="MODEL")
    sp.add_argument("--param", default="N",
                    help="symbol to sweep (default N)")
    sp.add_argument("--range", action="append", nargs="+", required=True,
                    metavar="ARG",
                    help="sweep axis: START STOP STEP (inclusive STOP, over "
                         "--param) or SYMBOL START STOP STEP; repeat the "
                         "flag for an N-dimensional grid (axes in flag "
                         "order, results flattened in C order)")
    sp.add_argument("--cores-range", nargs=3, type=int, default=None,
                    metavar=("START", "STOP", "STEP"),
                    help="batched cores axis (innermost grid axis): every "
                         "point is evaluated at its own core count through "
                         "the chip-level ECM saturation closed form")
    sp.add_argument("--dense", action="store_true",
                    help="require the compiled analytic sweep plan: the "
                         "grid is batched through vectorized LC/ECM closed "
                         "forms and the symbolic path runs once per LC "
                         "regime (results are identical; errors out for "
                         "predictors without a closed form, e.g. SIM)")
    sp.add_argument("--workers", type=int, default=0, metavar="N",
                    help="shard the sweep grid across N worker processes "
                         "(repro_torch.service worker pool, spawned; "
                         "results are "
                         "to_dict-identical to the sequential sweep and "
                         "back-filled into --cache-dir when given)")

    sp = sub.add_parser("blocking",
                        help="per-level LC blocking factors + model table")
    _add_common(sp)
    sp.add_argument("--symbol", default="N",
                    help="loop symbol to block (default N)")
    sp.add_argument("--safety", type=float, default=0.5,
                    help="usable fraction of each cache level (default 0.5)")
    sp.add_argument("-p", "--performance-model", default="ecm",
                    metavar="MODEL",
                    help="model scored by --grid (default ecm)")
    sp.add_argument("--grid", nargs=3, type=int, default=None,
                    metavar=("START", "STOP", "STEP"),
                    help="dense grid search over --symbol via the compiled "
                         "plan: score START..STOP inclusive and report the "
                         "best blocking factor")
    sp.add_argument("--grid2", nargs=4, default=None,
                    metavar=("SYMBOL", "START", "STOP", "STEP"),
                    help="second grid dimension for a 2D blocking search "
                         "(outer symbol first, whole grid batched)")
    sp.add_argument("--cores-range", nargs=3, type=int, default=None,
                    metavar=("START", "STOP", "STEP"),
                    help="cores axis for --grid: rank the saturated "
                         "performance min(single*n, sat) over the "
                         "(block x cores) grid and report n_sat per "
                         "candidate plus the saturation sweet spot")

    sp = sub.add_parser("lint",
                        help="static diagnostics: check kernel, machine, "
                             "and request before any model runs")
    sp.add_argument("kernel",
                    help="kernel source: .c file, HLO text/dump, or "
                         "trace:<module>[:attr] point-function reference")
    sp.add_argument("-m", "--machine", required=True,
                    help="machine description: short name (H100), "
                         "bundled yaml name, or path")
    sp.add_argument("-D", "--define", nargs=2, action="append", default=[],
                    metavar=("NAME", "VALUE"),
                    help="bind a symbolic constant (repeatable)")
    sp.add_argument("--frontend", default=None,
                    choices=["c", "builder", "trace", "hlo"],
                    help="force a frontend instead of auto-detection")
    sp.add_argument("--name", default=None, help="kernel name override")
    sp.add_argument("-p", "--performance-model", action="append",
                    default=None, metavar="MODEL",
                    help="model(s) the vetted request would run "
                         "(default: ecm for loop kernels, hlo-roofline "
                         "for HLO dumps)")
    sp.add_argument("--cache-predictor", default="LC", choices=["LC", "SIM"],
                    help="traffic predictor the request would use "
                         "(default LC)")
    sp.add_argument("--incore", default="simple",
                    choices=["simple", "ports"],
                    help="in-core model the request would use "
                         "(default simple)")
    sp.add_argument("--json", action="store_true",
                    help="emit the lint report as JSON")
    sp.add_argument("--sarif", action="store_true",
                    help="emit the lint report as SARIF 2.1.0")

    sp = sub.add_parser("machine", help="machine-description utilities")
    msub = sp.add_subparsers(dest="machine_command", required=True)
    vp = msub.add_parser("validate",
                         help="run the machine lint rules (M2xx) over "
                              "YAML descriptions")
    vp.add_argument("paths", nargs="*", metavar="PATH",
                    help="machine YAML files or bundled short names; "
                         "default: every file in repro_torch/machines/")
    vp.add_argument("--json", action="store_true",
                    help="emit one lint report per file as JSON")

    sp = sub.add_parser("fleet",
                        help="whole-model bottleneck reports over compiled "
                             "HLO modules: ranked top ops, bound-class mix "
                             "(MXU/VPU/HBM/ICI: on the H100 tensor-core, "
                             "CUDA-core, HBM and NVLink time), per-layer "
                             "attribution")
    sp.add_argument("--config", action="append", default=None,
                    metavar="NAME",
                    help="bundled config name (src/repro_torch/configs/hlo/"
                         "<NAME>.hlo.gz), an HLO dump path, or "
                         "graph:<arch>[:<shape>] (the port's own step, "
                         "captured on a fake 4-rank process group); "
                         "repeatable")
    sp.add_argument("--all", action="store_true",
                    help="analyze every config with a checked-in HLO dump "
                         "(default when no --config is given; overrides "
                         "--config)")
    sp.add_argument("-m", "--machine", action="append", default=None,
                    metavar="MACHINE",
                    help="machine description (repeatable; default: the "
                         "bundled card, H100)")
    sp.add_argument("--top", type=int, default=20, metavar="N",
                    help="ops ranked in the report (default 20)")
    sp.add_argument("--dtype", default="BF16",
                    help="peak-flops dtype for machines with a peak flops "
                         "table (default BF16)")
    sp.add_argument("--out", default="build/fleet", metavar="DIR",
                    help="write one JSON artifact per (config, machine) "
                         "as DIR/<config>__<machine>.json (default "
                         "build/fleet, which .gitignore lists; '-' "
                         "disables); scripts/fleet_gate.py --artifacts DIR "
                         "compares them against the goldens")
    sp.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="serve reports through the disk-backed result "
                         "cache rooted at DIR (kind 'fleet'; warm runs "
                         "skip the module walk entirely)")
    sp.add_argument("--json", action="store_true",
                    help="emit the full report payloads as JSON")

    sp = sub.add_parser("tune",
                        help="model-driven autotuner: rank a kernel "
                             "family's configurations analytically, "
                             "measure the top-k with real timers, derive "
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
                      help="measure the shortlist on the device "
                           "(default)")
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
                         "machine YAML (default: the file -m resolved "
                         "to); models apply them behind the opt-in "
                         "calibrated=True flag")
    sp.add_argument("--device", default=None,
                    help="device to measure on: cuda (default) or cpu")
    sp.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persist the TuneReport in the disk-backed "
                         "result cache (kind 'tune', keyed by the device "
                         "measured on; warm replays skip prediction and "
                         "measurement)")
    sp.add_argument("--json", action="store_true",
                    help="emit the TuneReport as JSON")

    sp = sub.add_parser("cache",
                        help="inspect or clear a disk-backed result cache")
    sp.add_argument("action", choices=["stats", "clear"],
                    help="'stats' reports entry counts/bytes per kind and "
                         "schema; 'clear' deletes every entry")
    sp.add_argument("--cache-dir", required=True, metavar="DIR",
                    help="cache root (the analyze/sweep --cache-dir)")
    sp.add_argument("--json", action="store_true",
                    help="emit the report as JSON")
    return ap


def _load(args):
    machine = api.resolve_machine(args.machine)
    kernel = api.load_kernel(args.kernel, _constants(args),
                             frontend=args.frontend, name=args.name)
    return machine, kernel


def _models(args) -> list[str]:
    return args.performance_model or ["ecm"]


def _service(args):
    """The AnalysisService for --cache-dir (None without it: the plain
    pooled-session path needs no service tier)."""
    if getattr(args, "cache_dir", None):
        from .service import AnalysisService
        return AnalysisService(cache_dir=args.cache_dir)
    return None


def _stats_payload(service, sess) -> dict:
    """The --stats payload: the service's three-tier counters when one is
    active, otherwise the session counters under the same shape."""
    if service is not None:
        return service.stats_dict()
    return {"session": sess.stats.to_dict(),
            "summary": {"hits": sess.stats.hits,
                        "misses": sess.stats.misses,
                        "disk_hits": 0, "coalesced": 0}}


def _print_stats(payload: dict) -> None:
    s = payload["summary"]
    print(f"stats: hits {s['hits']} | misses {s['misses']} | "
          f"disk hits {s['disk_hits']} | coalesced {s['coalesced']}")
    ses = payload["session"]
    print(f"  session: incore {ses['incore_hits']}/{ses['incore_misses']}"
          f" | volumes {ses['volume_hits']}/{ses['volume_misses']}"
          f" | results {ses['result_hits']}/{ses['result_misses']}"
          " (hits/misses)")
    svc = payload.get("service")
    if svc:
        print(f"  service: requests {svc['requests']} | memory hits "
              f"{svc['memory_hits']} | disk hits {svc['disk_hits']} | "
              f"computed {svc['computed']} | coalesced {svc['coalesced']}"
              f" | worker batches {svc['worker_batches']}")
    store = payload.get("store")
    if store:
        print(f"  store: lookups {store['lookups']} | hits {store['hits']}"
              f" | puts {store['puts']} | corrupt {store['skipped_corrupt']}"
              f" | stale {store['skipped_schema']}")


def _preflight(args, machine, kernel, **extra) -> None:
    """Cross-rule lint (X3xx) before any model runs: request combinations
    that are individually registered but jointly invalid — SIM under
    --dense, -p hlo-roofline on a loop kernel — exit 3 with a diagnostic
    instead of a deep traceback.  Unknown names still raise the ordinary
    registry ValueError (exit 2)."""
    from .core import lint as lint_mod
    lint_mod.lint_cross(kernel, machine, predictor=args.cache_predictor,
                        incore=args.incore, **extra).raise_if_errors()


def cmd_analyze(args) -> int:
    machine, kernel = _load(args)
    _preflight(args, machine, kernel, models=_models(args))
    service = _service(args)
    sess = api.get_session(machine)
    results = []
    for model in _models(args):
        if service is not None:
            res = service.analyze(kernel, machine, model,
                                  predictor=args.cache_predictor,
                                  cores=args.cores,
                                  sim_kwargs=_sim_kwargs(args),
                                  incore=args.incore)
        else:
            res = sess.analyze(kernel, model,
                               predictor=args.cache_predictor,
                               cores=args.cores,
                               sim_kwargs=_sim_kwargs(args),
                               incore=args.incore)
        results.append((model, res))
    if args.json:
        payload = []
        for _, r in results:
            d = r.to_dict()
            if args.cores > 1 and hasattr(r, "scaling_curve"):
                # the ECM multi-core saturation prediction, keyed only
                # under an explicit --cores so single-core payloads keep
                # their exact from_dict round-trip
                d["cores"] = args.cores
                d["performance_at_cores"] = r.performance_flops(args.cores)
                d["scaling_curve"] = r.scaling_curve(
                    max(args.cores, r.saturation_cores))
            payload.append(d)
        if args.stats:
            payload = {"results": payload,
                       "stats": _stats_payload(service, sess)}
        print(json.dumps(payload, indent=2, sort_keys=True))
        return 0
    kname = getattr(kernel, "name", args.kernel)
    defines = " ".join(f"-D {n} {v}" for n, v in args.define)
    backend = (f" --sim-backend {args.sim_backend}"
               if args.cache_predictor.upper() == "SIM" else "")
    incore = (f" --incore {args.incore}"
              if args.incore != "simple" else "")
    print(f"{kname}  -m {args.machine} "
          f"--cache-predictor {args.cache_predictor}{backend}{incore} "
          f"{defines}".rstrip())
    for model, res in results:
        print()
        print(reports.text_report(res, cores=args.cores))
    if args.stats:
        print()
        _print_stats(_stats_payload(service, sess))
    return 0


def _sweep_axes(args) -> dict[str, list[int]]:
    """Parse repeated ``--range`` specs into an ordered ``{symbol:
    values}`` grid: a 3-int spec sweeps ``--param``, a 4-element one
    names its own symbol (flag order = axis order)."""
    axes: dict[str, list[int]] = {}
    for spec in args.range:
        if len(spec) == 4 and not str(spec[0]).lstrip("-").isdigit():
            sym, nums = str(spec[0]), spec[1:]
            if not sym.isidentifier():
                raise ValueError(
                    f"--range symbol {sym!r} is not a valid identifier")
        elif len(spec) == 3:
            sym, nums = str(args.param), spec
        else:
            raise ValueError(
                "--range takes START STOP STEP (over --param) or "
                f"SYMBOL START STOP STEP, got {spec!r}")
        try:
            start, stop, step = (int(x) for x in nums)
        except ValueError:
            raise ValueError(
                f"--range expects integer START STOP STEP, got {spec!r}")
        if sym in axes:
            raise ValueError(f"duplicate --range axis {sym!r}")
        axes[sym] = list(range(start, stop + 1, step))    # STOP inclusive
    return axes


def cmd_sweep(args) -> int:
    machine, kernel = _load(args)
    axes = _sweep_axes(args)
    cores_axis = None
    if args.cores_range is not None:
        cs, ce, cstep = args.cores_range
        cores_axis = list(range(cs, ce + 1, cstep))       # STOP inclusive
    _preflight(args, machine, kernel, models=_models(args),
               compiled=True if args.dense else None,
               sweep_params=list(axes),
               cores_axis=cores_axis is not None)
    service = _service(args)
    models = _models(args)
    nd = len(axes) > 1 or cores_axis is not None
    if nd:
        param, values = dict(axes), None
    else:
        # single axis, scalar cores: the historical 1-D call, so service
        # cache keys stay byte-identical to pre-N-D runs
        param = next(iter(axes))
        values = axes[param]
    out = api.sweep(kernel, machine, param, values, models=models,
                    predictor=args.cache_predictor,
                    cores=cores_axis if cores_axis is not None
                    else args.cores,
                    sim_kwargs=_sim_kwargs(args), incore=args.incore,
                    service=service, workers=args.workers,
                    compiled=True if args.dense else "auto")
    sess = None if service is not None else api.get_session(machine)
    names = list(axes) + (["cores"] if cores_axis is not None else [])
    dims = [axes[s] for s in axes]
    if cores_axis is not None:
        dims.append(cores_axis)
    points = list(itertools.product(*dims))   # C order: cores innermost
    if args.json:
        payload = {}
        for m, rs in out.items():
            rows = []
            for pt, r in zip(points, rs):
                d = r.to_dict()
                if cores_axis is not None and hasattr(r, "scaling_curve"):
                    # per-point saturation outputs (analyze --cores emits
                    # the same keys); only under a cores axis so 1-D
                    # payloads keep their exact from_dict round-trip
                    d["cores"] = pt[-1]
                    d["performance_at_cores"] = r.performance_flops(pt[-1])
                rows.append(d)
            payload[m] = rows
        if args.stats:
            payload = {"results": payload,
                       "stats": _stats_payload(service, sess)}
        print(json.dumps(payload, indent=2, sort_keys=True))
        return 0
    legend = ("(GFLOP/s at the point's core count)"
              if cores_axis is not None
              else "(cy/CL for ecm, GFLOP/s for roofline)")
    print(" | ".join(f"{n:>6}" for n in names) + " | "
          + " | ".join(f"{m:>18}" for m in models) + "   " + legend)
    for idx, pt in enumerate(points):
        cells = []
        for m in models:
            r = out[m][idx]
            if hasattr(r, "t_ecm"):
                if cores_axis is not None:
                    cells.append(
                        f"{r.performance_flops(pt[-1]) / 1e9:>12.2f} GF/s")
                else:
                    cells.append(f"{r.t_ecm:>15.1f} cy")
            else:
                cells.append(f"{r.performance / 1e9:>12.2f} GF/s")
        print(" | ".join(f"{v:>6}" for v in pt) + " | "
              + " | ".join(f"{c:>18}" for c in cells))
    if args.stats:
        print()
        _print_stats(_stats_payload(service, sess))
    return 0


def cmd_lint(args) -> int:
    """Static diagnostics over (kernel, machine, request) — exit 0 when
    clean (warnings allowed), 3 when any error-severity finding exists.
    Load failures (unparsable C, malformed YAML, trace mismatches) become
    K100/M200 diagnostics instead of tracebacks."""
    from .core import lint as lint_mod
    try:
        machine = api.resolve_machine(args.machine)
    except Exception as e:          # noqa: BLE001 - surfaced as diagnostic
        report = lint_mod.load_failure(args.machine, e, kind="machine")
    else:
        try:
            kernel = api.load_kernel(args.kernel, _constants(args),
                                     frontend=args.frontend,
                                     name=args.name)
        except Exception as e:      # noqa: BLE001 - surfaced as diagnostic
            report = lint_mod.load_failure(args.kernel, e, kind="kernel")
        else:
            models = args.performance_model or (
                ["ecm"] if isinstance(kernel, LoopKernel)
                else ["hlo-roofline"])
            report = lint_mod.lint_request(
                kernel, machine, filename=args.kernel, models=models,
                predictor=args.cache_predictor, incore=args.incore)
    if args.sarif:
        print(json.dumps(report.to_sarif(), indent=2, sort_keys=True))
    elif args.json:
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
    else:
        print(report.render())
    return 3 if report.errors else 0


def cmd_machine(args) -> int:
    """``machine validate``: the machine rule family (M2xx) over explicit
    paths or every bundled description; exit 3 if any file has errors."""
    from .core import lint as lint_mod
    from .core.machine import _MACHINE_DIR
    paths = list(args.paths) or sorted(
        p.name for p in _MACHINE_DIR.glob("*.yaml"))
    rc = 0
    linted = []
    for p in paths:
        try:
            m = api.resolve_machine(p)
        except Exception as e:      # noqa: BLE001 - surfaced as diagnostic
            rep = lint_mod.load_failure(str(p), e, kind="machine")
        else:
            rep = lint_mod.lint_machine(m, filename=str(p))
        if rep.errors:
            rc = 3
        linted.append((str(p), rep))
    if args.json:
        print(json.dumps([{"file": p, **rep.to_dict()}
                          for p, rep in linted], indent=2, sort_keys=True))
        return rc
    for _, rep in linted:
        print(rep.render())
    return rc


def cmd_cache(args) -> int:
    from .service import ResultStore
    store = ResultStore(args.cache_dir)
    if args.action == "clear":
        n = store.clear()
        if args.json:
            print(json.dumps({"cleared": n, "root": str(store.root)}))
        else:
            print(f"cleared {n} cache entr{'y' if n == 1 else 'ies'} "
                  f"under {store.root}")
        return 0
    s = store.summary(detail=True)
    if args.json:
        print(json.dumps(s, indent=2, sort_keys=True))
        return 0
    print(f"result cache at {s['root']} (schema v{s['schema']}):")
    print(f"  {s['entries']} entries, {s['bytes'] / 1024:.1f} kB")
    for kind, n in sorted(s["by_kind"].items()):
        print(f"    {kind:<10} {n}")
    stale = sum(n for v, n in s["by_schema"].items()
                if v != str(s["schema"]))
    if stale:
        print(f"  {stale} entries from other schema versions "
              "(ignored by lookups; 'cache clear' removes them)")
    return 0


def cmd_fleet(args) -> int:
    """Whole-model bottleneck reports (:mod:`repro_torch.fleet`): one
    ranked report per (config, machine), emitted as text/JSON and as the
    per-pair artifact files ``scripts/fleet_gate.py`` diffs against the
    goldens."""
    from . import fleet
    configs_ = args.config if args.config and not args.all else None
    machines = args.machine or list(fleet.DEFAULT_MACHINES)
    analyzer = fleet.FleetAnalyzer(cache_dir=args.cache_dir, top=args.top,
                                   dtype=args.dtype)
    results = analyzer.analyze_all(configs_, machines)
    paths = []
    if args.out and args.out != "-":
        paths = analyzer.write_artifacts(results, machines, args.out)
    if args.json:
        print(json.dumps([r.to_dict() for r in results], indent=2,
                         sort_keys=True))
        return 0
    for i, rep in enumerate(results):
        if i:
            print()
        print(rep.render(top=min(args.top, 5)))
    if paths:
        print(f"\nwrote {len(paths)} artifact(s) under {args.out} "
              f"(compare: python scripts/fleet_gate.py --artifacts "
              f"{args.out})")
    return 0


def _cmd_blocking_grid(args, machine, kernel) -> int:
    from .core import blocking
    start, stop, step = args.grid
    specs = [(args.symbol, range(start, stop + 1, step))]
    if args.grid2 is not None:
        sym2, s2, e2, st2 = args.grid2
        # outer dimension first (C-order flattening in the batched plan)
        specs = [(sym2, range(int(s2), int(e2) + 1, int(st2)))] + specs
    cores = args.cores
    if args.cores_range is not None:
        cs, ce, cstep = args.cores_range
        cores = list(range(cs, ce + 1, cstep))    # STOP inclusive
    gs = blocking.grid_search(kernel, machine, specs,
                              model=args.performance_model,
                              predictor=args.cache_predictor,
                              cores=cores, incore=args.incore)
    if args.json:
        print(json.dumps(gs.to_dict(), indent=2, sort_keys=True))
        return 0
    pts = 1
    for g in gs.grids:
        pts *= len(g)
    grid_desc = " x ".join(f"{s}[{g[0]}..{g[-1]}]"
                           for s, g in zip(gs.symbols, gs.grids))
    if gs.cores_grid:
        pts *= len(gs.cores_grid)
        grid_desc += f" x cores[{gs.cores_grid[0]}..{gs.cores_grid[-1]}]"
    print(f"dense blocking grid search for "
          f"{getattr(kernel, 'name', args.kernel)} "
          f"({gs.model}, {pts} points over {grid_desc}):")
    maximize = gs.metric in ("flops", "flops_at_cores")
    unit = "GFLOP/s" if maximize else "cy/unit"
    scale = 1e-9 if maximize else 1.0
    best = " ".join(f"{s} = {v}" for s, v in gs.best.items())
    if gs.cores_grid:
        best += f" cores = {gs.best_cores}"
    print(f"  best: {best}  ->  {gs.best_score * scale:.1f} {unit}")
    if hasattr(gs.best_result, "notation"):
        print(f"  {gs.best_result.notation()}")
    if gs.cores_grid:
        print("  best block per core count (saturated GFLOP/s, n_sat):")
        for e in gs.best_per_cores:
            blk = " ".join(f"{s} = {v}" for s, v in e["best"].items())
            print(f"    n = {e['cores']:>3}: {blk}  ->  "
                  f"{e['score'] * 1e-9:.1f} GFLOP/s  (n_sat {e['n_sat']})")
        ss = gs.sweet_spot
        print(f"  sweet spot: {ss['cores']} cores saturate the best block "
              f"(n_sat {ss['n_sat']}) at {ss['score'] * 1e-9:.1f} GFLOP/s")
    return 0


def cmd_blocking(args) -> int:
    machine, kernel = _load(args)
    grid_syms = ([args.grid2[0]] if args.grid2 is not None else []) \
        + [args.symbol]
    _preflight(args, machine, kernel, models=[args.performance_model],
               operation="blocking",
               compiled=True if args.grid is not None else None,
               sweep_params=grid_syms if args.grid is not None else None,
               cores_axis=args.cores_range is not None)
    if args.grid2 is not None and args.grid is None:
        raise ValueError("--grid2 needs --grid for the first dimension")
    if args.cores_range is not None and args.grid is None:
        raise ValueError("--cores-range needs --grid (the cores axis "
                         "extends the dense blocking grid)")
    if args.grid is not None:
        return _cmd_blocking_grid(args, machine, kernel)
    from .core import blocking
    rows = []
    for lv in machine.levels:
        bs = blocking.lc_block_size(kernel, lv.size_bytes,
                                    symbol=args.symbol, safety=args.safety)
        rows.append({"level": lv.name, "size_bytes": lv.size_bytes,
                     "block": None if math.isinf(bs) else int(bs)})
    if args.json:
        print(json.dumps({"symbol": args.symbol, "levels": rows}, indent=2))
        return 0
    print(f"LC blocking factors for {getattr(kernel, 'name', args.kernel)} "
          f"(symbol {args.symbol}, safety {args.safety}):")
    for row in rows:
        blk = "unbounded" if row["block"] is None else str(row["block"])
        print(f"  {row['level']:<5} ({row['size_bytes'] / 1024:8.0f} kB): "
              f"{args.symbol} <= {blk}")
    return 0


def cmd_tune(args) -> int:
    from . import tune as tune_mod
    machine = api.resolve_machine(args.machine)
    config = {}
    for name, value in args.shape:
        try:
            config[name] = int(value)
        except ValueError:
            config[name] = value        # dtype=..., causal=... stay strings
    service = _service(args)
    rep = tune_mod.tune(args.family, machine, config=config or None,
                        top_k=args.top_k, measure=args.measure,
                        warmup=args.warmup, reps=args.reps,
                        timeout_s=args.timeout_s, isolate=args.isolate,
                        device=args.device,
                        session=api.get_session(machine), service=service)
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
    from .core.lint import LintError
    try:
        return {"analyze": cmd_analyze, "sweep": cmd_sweep,
                "blocking": cmd_blocking, "lint": cmd_lint,
                "machine": cmd_machine, "fleet": cmd_fleet,
                "tune": cmd_tune, "cache": cmd_cache}[args.command](args)
    except LintError as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    except (ValueError, TypeError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
