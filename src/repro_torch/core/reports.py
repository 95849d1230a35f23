"""CLI-style reports mirroring the paper's Listings 4 and 5, plus the
machine-readable JSON round-trip every result supports (a copy of
``repro.core.reports``).

The JAX package's ``hlo-roofline`` results wait for the port's graph
frontend (ROADMAP.md Queue 1, item 6): :func:`hlo_report` and
:func:`result_from_dict` of such a payload raise ``ValueError`` naming
that item."""
from __future__ import annotations

import json

from . import layer_conditions
from .ecm import ECMResult
from .kernel_ir import LoopKernel
from .machine import Machine
from .model_api import NOT_PORTED
from .roofline import RooflineResult

AnyResult = ECMResult | RooflineResult


def _gf(x: float) -> str:
    return f"{x / 1e9:.2f} GFLOP/s"


def _incore_lines(incore: dict) -> list[str]:
    """Port-scheduler breakdown lines (the "ports" in-core model): per-port
    occupation plus which bound binds.  Empty for the "simple" model,
    whose per-kind times already appear in T_OL/T_nOL."""
    occ = (incore or {}).get("port_occupation")
    if not occ:
        return []
    cells = " | ".join(f"{p} {c:.1f}" for p, c in sorted(occ.items()))
    lines = [f"in-core port occupation (cy/unit): {cells}"]
    lines.append(
        f"in-core bound: {incore.get('bound', 'throughput')}"
        + (f" (loop-carried latency {incore['t_latency']:.1f} cy/unit)"
           if incore.get("t_latency") else ""))
    return lines


def ecm_report(res: ECMResult, cores: int = 1) -> str:
    lines = ["-" * 26 + " ECM " + "-" * 26,
             res.notation(),
             res.notation_cumulative(),
             f"saturating at {res.saturation_cores} cores"]
    if cores > 1 and res.flops_per_unit:
        # the multi-core saturation prediction (paper §1.2.3): linear in
        # cores until the memory term is fully occupied
        sat = res.saturation_cores
        state = "saturated" if cores >= sat else "scaling"
        lines.append(f"performance at {cores} cores: "
                     f"{res.performance_flops(cores) / 1e9:.2f} GFLOP/s "
                     f"({state})")
        curve = res.scaling_curve(max(cores, sat))
        lines.append("scaling (GFLOP/s at 1.."
                     f"{len(curve)} cores): "
                     + " ".join(f"{p / 1e9:.2f}" for p in curve))
    lines += _incore_lines(res.incore)
    return "\n".join(lines)


def roofline_report(res: RooflineResult, cores: int = 1) -> str:
    lines = ["-" * 21 + " RooflineIACA " + "-" * 21]
    if res.incore_model:
        lines.append(f"[{res.predictor_tag}] [{res.incore_model}]")
    lines += ["Bottlenecks:",
             "  level | a. intensity |   performance   |  bandwidth  | bw kernel"]
    lines.append(f"  CPU   |              | {_gf(res.core_performance):>15} |"
                 f"             |")
    for l in res.levels:
        ai = ("" if l.arithmetic_intensity == float("inf")
              else f"{l.arithmetic_intensity:.2f} FLOP/B")
        lines.append(f"  {l.level:<5} | {ai:>12} | {_gf(l.performance):>15} |"
                     f" {l.bandwidth / 1e9:>6.2f} GB/s | {l.bench_kernel}")
    bn = res.bottleneck
    lines.append(f"Cache or mem bound with {cores} core(s)" if bn != "CPU"
                 else f"CPU bound with {cores} core(s)")
    lines.append(f"{_gf(res.performance)} due to {bn} bottleneck")
    if res.levels:
        lines.append(f"Arithmetic Intensity: "
                     f"{res.levels[-1].arithmetic_intensity:.2f} FLOP/B")
    lines += _incore_lines(res.incore)
    return "\n".join(lines)


def hlo_report(res) -> str:
    """The JAX package's text report of the ``hlo-roofline`` model, which
    the port does not carry yet."""
    raise ValueError("no hlo-roofline report in repro_torch yet: "
                     + NOT_PORTED["hlo-roofline"].why)


# ----------------------------------------------------------------------
# Machine-readable output: JSON round-trip for every model result
# ----------------------------------------------------------------------

def to_json(res: AnyResult) -> str:
    """Serialize any model result through its ``to_dict()``."""
    return json.dumps(res.to_dict(), indent=2, sort_keys=True)


def result_from_dict(d: dict) -> AnyResult:
    """Rebuild a result object from its ``to_dict()`` form (the ``model``
    field dispatches, matching MODEL_REGISTRY names)."""
    model = d.get("model", "")
    if model == "ecm":
        return ECMResult.from_dict(d)
    if model == "hlo-roofline":
        raise ValueError("cannot rebuild an hlo-roofline result in "
                         "repro_torch yet: " + NOT_PORTED["hlo-roofline"].why)
    if model.startswith("roofline"):
        return RooflineResult.from_dict(d)
    raise ValueError(
        f"cannot rebuild result for model {model!r}; "
        "known: ['ecm', 'hlo-roofline', 'roofline', 'roofline-iaca']")


def from_json(s: str) -> AnyResult:
    return result_from_dict(json.loads(s))


def text_report(res: AnyResult, cores: int = 1) -> str:
    """Dispatch to the right text renderer for any model result."""
    if isinstance(res, ECMResult):
        return ecm_report(res, cores=cores)
    if isinstance(res, RooflineResult):
        return roofline_report(res, cores=cores)
    raise TypeError(f"no text report for {type(res).__name__}")


def json_report(res: AnyResult) -> str:
    """Render the human report from a JSON round-trip of the result — the
    serialized form must carry everything the text reports need."""
    return text_report(from_json(to_json(res)))


def lc_report(kernel: LoopKernel, machine: Machine, symbol: str = "N") -> str:
    """Paper Listing 5: per-level LC transition points."""
    lines = ["-" * 20 + " Layer conditions " + "-" * 20]
    for lv in machine.levels:
        trans = layer_conditions.transition_points(kernel, lv.size_bytes, symbol)
        lines.append(f"{lv.name} ({lv.size_bytes / 1024:.0f} kB):")
        for tr in trans:
            cond = ("streaming (no reuse)" if tr.threshold == 0
                    else f"t <= {tr.threshold}")
            nmax = ("always" if tr.max_value == float("inf")
                    else f"{symbol} <= {tr.max_value:.0f}")
            lines.append(f"    {cond:<28} holds for {nmax:<16} "
                         f"(hits {tr.hits}, misses {tr.misses}, "
                         f"C_req {tr.c_req})")
    return "\n".join(lines)
