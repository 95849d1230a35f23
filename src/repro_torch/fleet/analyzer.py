"""FleetAnalyzer: whole-module bottleneck reports, served and cached (a
copy of ``repro.fleet.analyzer``).

The pipeline for one (config, machine) pair:

1. resolve the HLO module — the bundled per-config dump
   (``repro_torch/configs/hlo/<config>.hlo.gz``, byte copies of the JAX
   package's, which ``scripts/gen_fleet_hlo.py`` lowers from the reduced
   config models on a forced-host-device mesh), an explicit dump path, or
   raw HLO text — through the ``hlo`` frontend; or ``graph:<arch>``, the
   port's own step for the same cell, captured through the ``graph``
   frontend;
2. walk it with ``analyze_hlo_text(per_op=True)`` so every instruction
   gets an :class:`~repro_torch.core.hlo_analysis.OpCost` record
   accumulated at the same points as the module totals (a captured
   program carries such records already);
3. get the module-level roofline: machines with accelerator fields
   (``peak flops``/``hbm bandwidth``: v5e, the H100) route through the
   pooled :class:`~repro_torch.service.AnalysisService` session
   (``"hlo-roofline"``, warm across configs and processes); x86 cache
   machines derive the same result shape from their own rates (the
   registered model's guard stays intact);
4. price each record (:mod:`repro_torch.fleet.pricing`, collective terms
   via the :mod:`repro_torch.dist` ring wire models), verify
   conservation, and roll up the ranked
   :class:`~repro_torch.fleet.report.FleetReport`.

The whole report is itself served through the service's three-tier path
(kind ``"fleet"``, the JAX package's key), so re-running ``python -m
repro_torch fleet --all`` against a warm cache dir — one that either
package filled — reads every report from disk without re-walking a
single module.
"""
from __future__ import annotations

import json
import math
import pathlib
import re

from ..core import api as _api
from ..core import hlo_analysis
from ..core.frontends.graph import GraphFrontend, GraphProgram
from ..core.frontends.hlo import HLOFrontend, HLOProgram
from ..core.model_api import program_analysis
from ..core.machine import ALIASES, Machine
from ..service import AnalysisService

from .pricing import BOUND_CLASSES, MachineRates, price_ops
from .report import SCHEMA, FleetReport

DUMP_DIR = pathlib.Path(__file__).resolve().parent.parent / "configs" / "hlo"
# the port's default is its own card; JAX's defaults (IVY, V5E) load by
# alias too
DEFAULT_MACHINES = ("H100",)
# conservation: per-op sums repeat the exact additions of the module
# totals, so drift beyond float noise means the invariant broke
_CONSERVE_TOL = 1e-9


def dump_configs() -> list[str]:
    """Config names with a checked-in HLO dump, sorted."""
    if not DUMP_DIR.is_dir():
        return []
    return sorted(p.name[:-len(".hlo.gz")]
                  for p in DUMP_DIR.glob("*.hlo.gz"))


def machine_label(spec) -> str:
    """Stable artifact-filename label for a machine spec."""
    if isinstance(spec, Machine):
        return re.sub(r"[^\w.+-]+", "_", spec.name.strip()).strip("_").lower()
    # an alias labels as its file's stem, as a file passed by path does
    # (the goldens' names)
    s = ALIASES.get(str(spec), str(spec))
    name = pathlib.Path(s).name
    for suffix in (".yaml", ".yml"):
        if name.endswith(suffix):
            name = name[:-len(suffix)]
    return name


def load_program(spec) -> tuple[HLOProgram | GraphProgram, str]:
    """Resolve a fleet source: bundled config name, dump path, HLO text,
    compiled executable, or ``graph:<arch>[:<shape>]`` (the port's own
    program, captured by the ``graph`` frontend).  Returns (program,
    source label)."""
    if isinstance(spec, (HLOProgram, GraphProgram)):
        return spec, spec.name
    if GraphFrontend().matches(spec):
        return GraphFrontend().load(spec), spec
    if isinstance(spec, str) and "\n" not in spec:
        dump = DUMP_DIR / f"{spec}.hlo.gz"
        if dump.is_file():
            return HLOFrontend().load(dump, name=spec), dump.name
    front = HLOFrontend()
    if front.matches(spec):
        prog = front.load(spec)
        label = (pathlib.Path(str(spec)).name
                 if isinstance(spec, (str, pathlib.Path))
                 and "\n" not in str(spec) else f"<{prog.name}>")
        return prog, label
    known = ", ".join(dump_configs()) or "(no dumps checked in)"
    raise FileNotFoundError(
        f"fleet source {spec!r} is neither a bundled config with an HLO "
        f"dump nor an HLO dump path/text; bundled: {known}")


class FleetAnalyzer:
    """Ranked bottleneck reports over whole HLO modules."""

    def __init__(self, service: AnalysisService | None = None, *,
                 cache_dir: str | None = None, top: int = 20,
                 dtype: str = "BF16"):
        self.service = service or AnalysisService(cache_dir=cache_dir)
        self.top = int(top)
        self.dtype = dtype

    # -- one report -----------------------------------------------------
    def analyze(self, config, machine) -> FleetReport:
        mach = _api.resolve_machine(machine)
        program, source = load_program(config)
        key = ("fleet", SCHEMA, program.cache_key(), mach.fingerprint,
               self.dtype, self.top)

        def decode(payload):
            try:
                return FleetReport.from_dict(payload)
            except (KeyError, TypeError, ValueError):
                return None                 # foreign/corrupt -> recompute

        def compute():
            rep = self._build(program, source, mach)
            return rep, rep.to_dict()

        return self.service.serve_custom(
            key, compute, decode,
            meta={"kind": "fleet", "config": program.name,
                  "machine": mach.name,
                  "machine_fingerprint": mach.fingerprint})

    def _build(self, program: HLOProgram, source: str,
               mach: Machine) -> FleetReport:
        rates = MachineRates.from_machine(mach, self.dtype)
        ana = program_analysis(program, per_op=True)
        if rates.kind == "tpu":       # peak flops / hbm bandwidth fields
            module = self.service.analyze(program, mach, "hlo-roofline",
                                          dtype=self.dtype)
        else:
            module = hlo_analysis.roofline_result(
                ana, program=program.name, machine_name=mach.name,
                peak_flops=rates.mxu_peak,
                hbm_bandwidth=rates.mem_bandwidth,
                ici_bandwidth=rates.wire_bandwidth,
                vpu_peak_flops=rates.vpu_peak)
        _check_conservation(ana, module, program.name)

        priced = price_ops(ana.ops, rates)
        t_graph = sum(p.t_pred for p in priced)
        t_serial = sum(p.t_serial for p in priced)

        bounds = {k: {"time": 0.0, "ops": 0, "share": 0.0}
                  for k in BOUND_CLASSES}
        for p in priced:
            b = bounds[p.bound]
            b["time"] += p.t_pred
            b["ops"] += 1
        for b in bounds.values():
            b["share"] = b["time"] / t_graph if t_graph else 0.0

        layers: dict[tuple, dict] = {}
        for p in priced:
            lk = (p.op.computation, p.op.multiplier)
            a = layers.setdefault(lk, {
                "computation": p.op.computation,
                "multiplier": p.op.multiplier,
                "ops": 0, "t_pred": 0.0, "t_serial": 0.0})
            a["ops"] += 1
            a["t_pred"] += p.t_pred
            a["t_serial"] += p.t_serial
        layer_list = sorted(layers.values(), key=lambda d: -d["t_pred"])
        for a in layer_list:
            a["share"] = a["t_pred"] / t_graph if t_graph else 0.0

        ranked = sorted(priced, key=lambda p: -p.t_pred)
        return FleetReport(
            config=program.name, machine=mach.name,
            machine_fingerprint=mach.fingerprint, source=source,
            dtype=self.dtype, rates=rates,
            totals={"mxu_flops": ana.mxu_flops, "vpu_flops": ana.vpu_flops,
                    "hbm_bytes": ana.hbm_bytes,
                    "wire_bytes": ana.collective_wire_bytes,
                    "n_ops": len(ana.ops),
                    "n_collectives": len(ana.schedule)},
            module=module.to_dict(), t_graph=t_graph,
            t_graph_serial=t_serial, bounds=bounds, layers=layer_list,
            top_ops=[p.to_dict() for p in ranked[:self.top]])

    # -- many reports + artifacts ---------------------------------------
    def analyze_all(self, configs=None, machines=DEFAULT_MACHINES
                    ) -> list[FleetReport]:
        configs = list(configs) if configs else dump_configs()
        if not configs:
            raise FileNotFoundError(
                f"no HLO dumps under {DUMP_DIR}; they are byte copies of "
                "the JAX package's src/repro/configs/hlo/*.hlo.gz")
        return [self.analyze(c, m) for c in configs for m in machines]

    def write_artifacts(self, reports, machines, out_dir) -> list[pathlib.Path]:
        """One JSON per (config, machine): ``<config>__<machine>.json``.
        ``machines`` must align with how ``reports`` was produced (the
        per-config inner loop of :meth:`analyze_all`)."""
        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        labels = [machine_label(m) for m in machines]
        paths = []
        for i, rep in enumerate(reports):
            label = labels[i % len(labels)] if labels else "machine"
            # a captured program's name, graph:<arch>, as graph-<arch>
            path = out / f"{rep.config.replace(':', '-')}__{label}.json"
            path.write_text(json.dumps(rep.to_dict(), indent=1,
                                       sort_keys=True) + "\n")
            paths.append(path)
        return paths


def _check_conservation(ana: hlo_analysis.HLOAnalysis, module,
                        name: str) -> None:
    """The roll-up invariant: per-op sums == module totals == the totals
    the registered hlo-roofline model reports.  Raises on violation —
    a fleet report is only emitted if it provably conserves."""
    pairs = [
        ("mxu_flops", sum(o.mxu_flops for o in ana.ops), module.mxu_flops),
        ("vpu_flops", sum(o.vpu_flops for o in ana.ops), module.vpu_flops),
        ("hbm_bytes", sum(o.hbm_bytes for o in ana.ops), module.hbm_bytes),
        ("wire_bytes", sum(o.wire_bytes for o in ana.ops),
         module.collective_wire_bytes),
    ]
    for field, per_op, total in pairs:
        if not math.isclose(per_op, total, rel_tol=_CONSERVE_TOL,
                            abs_tol=1e-6):
            raise ValueError(
                f"fleet conservation violated for {name}: per-op "
                f"{field} sum {per_op!r} != module total {total!r}")
