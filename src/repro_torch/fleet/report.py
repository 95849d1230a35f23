"""FleetReport: the ranked whole-module bottleneck report (a copy of
``repro.fleet.report``, schema included).

One report = one (config, machine) pair.  It carries the module totals
(conserved against ``analyze_hlo_text``), both composed graph times
(roofline overlap / ECM serial), the bound-class mix, per-layer
(computation) attribution, and the top-N ops by predicted time.  The
``to_dict``/``from_dict`` round trip is exact, so reports are cacheable
through the AnalysisService store (whose entries either package reads)
and diffable as artifacts: the JAX package's goldens under
``benchmarks/golden/fleet/`` are exactly ``json.dump(report.to_dict())``,
and ``scripts/fleet_gate.py`` holds a report to them.
"""
from __future__ import annotations

import dataclasses

from .pricing import BOUND_CLASSES, MachineRates, PricedOp

SCHEMA = 1


def _eng(x: float, unit: str) -> str:
    """1234567 -> '1.23 M<unit>' (engineering prefixes, 3 significant)."""
    for scale, prefix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(x) >= scale:
            return f"{x / scale:.2f} {prefix}{unit}"
    return f"{x:.0f} {unit}"


@dataclasses.dataclass
class FleetReport:
    config: str
    machine: str
    machine_fingerprint: str
    source: str                    # dump file name, or "<text>"/"<compiled>"
    dtype: str
    rates: MachineRates
    totals: dict                   # module totals: mxu_flops, vpu_flops,
    #                                hbm_bytes, wire_bytes, n_ops,
    #                                n_collectives (conserved vs per-op sums)
    module: dict                   # HLORooflineResult.to_dict()
    t_graph: float                 # sum of per-op roofline times
    t_graph_serial: float          # sum of per-op ECM-serial times
    bounds: dict                   # class -> {time, ops, share}
    layers: list                   # per-computation attribution dicts
    top_ops: list                  # PricedOp.to_dict(), ranked by t_pred
    conserved: bool = True

    @property
    def bottleneck(self) -> str:
        """Graph-level bound class: largest share of predicted time."""
        return max(BOUND_CLASSES,
                   key=lambda k: self.bounds.get(k, {}).get("time", 0.0))

    def to_dict(self) -> dict:
        return {
            "schema": SCHEMA,
            "kind": "fleet-report",
            "config": self.config,
            "machine": self.machine,
            "machine_fingerprint": self.machine_fingerprint,
            "source": self.source,
            "dtype": self.dtype,
            "rates": self.rates.to_dict(),
            "totals": dict(self.totals),
            "module": dict(self.module),
            "t_graph": self.t_graph,
            "t_graph_serial": self.t_graph_serial,
            "bottleneck": self.bottleneck,
            "bounds": {k: dict(v) for k, v in self.bounds.items()},
            "layers": [dict(d) for d in self.layers],
            "top_ops": [dict(d) for d in self.top_ops],
            "conserved": self.conserved,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FleetReport":
        if d.get("kind") != "fleet-report" or d.get("schema") != SCHEMA:
            raise ValueError("not a fleet-report payload")
        return cls(
            config=str(d["config"]), machine=str(d["machine"]),
            machine_fingerprint=str(d["machine_fingerprint"]),
            source=str(d["source"]), dtype=str(d["dtype"]),
            rates=MachineRates(**d["rates"]),
            totals=dict(d["totals"]), module=dict(d["module"]),
            t_graph=float(d["t_graph"]),
            t_graph_serial=float(d["t_graph_serial"]),
            bounds={k: dict(v) for k, v in d["bounds"].items()},
            layers=[dict(x) for x in d["layers"]],
            top_ops=[dict(x) for x in d["top_ops"]],
            conserved=bool(d["conserved"]))

    # -- text rendering -------------------------------------------------
    def render(self, top: int = 10) -> str:
        t = self.totals
        lines = [
            f"Fleet report: {self.config} on {self.machine} "
            f"[{self.rates.kind}]",
            f"  source: {self.source}   dtype: {self.dtype}   "
            f"ops: {t['n_ops']} ({t['n_collectives']} collectives)",
            "  totals: "
            f"{_eng(t['mxu_flops'], 'FLOP')} MXU | "
            f"{_eng(t['vpu_flops'], 'FLOP')} VPU | "
            f"{_eng(t['hbm_bytes'], 'B')} HBM | "
            f"{_eng(t['wire_bytes'], 'B')} wire",
            f"  graph roll-up: {self.t_graph:.3e} s overlapped, "
            f"{self.t_graph_serial:.3e} s serial "
            f"[{'conserved' if self.conserved else 'NOT CONSERVED'}]",
            f"  module bound: {self.module.get('bottleneck', '?')} "
            f"(overlapped {self.module.get('t_total_overlapped', 0.0):.3e} s)"
            f"   graph bound: {self.bottleneck}",
        ]
        mix = sorted(self.bounds.items(),
                     key=lambda kv: -kv[1].get("time", 0.0))
        lines.append("  bound mix: " + " | ".join(
            f"{k} {100.0 * v.get('share', 0.0):.1f}% ({v.get('ops', 0)} ops)"
            for k, v in mix))
        lines.append(f"  top {min(top, len(self.top_ops))} ops by "
                     "predicted time:")
        lines.append("    rank  t_pred        bound  mult    op")
        for i, d in enumerate(self.top_ops[:top], 1):
            share = d["t_pred"] / self.t_graph if self.t_graph else 0.0
            lines.append(
                f"    {i:<4}  {d['t_pred']:.3e} s  {d['bound']:<5} "
                f"x{d['multiplier']:<5} %{d['name']} "
                f"[{d['opcode']}] {d['shape']} in %{d['computation']} "
                f"({100.0 * share:.1f}%)")
        lines.append("  per-layer attribution:")
        lines.append("    t_pred        share   ops   computation")
        for d in self.layers[:top]:
            lines.append(
                f"    {d['t_pred']:.3e} s  {100.0 * d['share']:5.1f}%  "
                f"{d['ops']:<4}  %{d['computation']} (x{d['multiplier']})")
        return "\n".join(lines)
