"""Machine rules (M2xx): is the machine YAML internally consistent?

(A copy of ``repro.core.lint.rules_machine``.)

A machine description mixes documented constants (port rates, cache
geometry) with measured benchmark curves; a typo in either produces
models that are confidently wrong rather than broken.  These rules check
the physics every hierarchy must satisfy — nearer levels are faster,
capacities grow outward, geometry factors multiply out to the declared
size — plus the coverage contracts the in-core models rely on (every op
kind the kernel emits has a ports entry; FMA decomposes when absent).
"""
from __future__ import annotations

from typing import Iterable

from ..machine import Machine
from .diagnostics import Diagnostic
from .engine import LintContext, LintRule, register_rule


def _level_order(machine: Machine) -> dict[str, int]:
    """Hierarchy position per level name, main memory last."""
    order = {lv.name: i for i, lv in enumerate(machine.levels)}
    order.setdefault("MEM", len(machine.levels))
    return order


@register_rule
class BandwidthMonotonicity(LintRule):
    """M201 — measured bandwidths must respect the hierarchy: a nearer
    level is at least as fast as a farther one at every core count, and
    each level's own scaling curve never *loses* bandwidth as cores are
    added (saturation plateaus are fine).  Documented transfer costs
    (cycles per cacheline) must not shrink going outward.  Inversions
    almost always mean swapped rows or mislabeled levels."""

    code = "M201"
    family = "machine"
    title = "bandwidth/latency monotonicity"
    needs = ("machine",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        m = ctx.machine
        for res in m.results:
            bw = res.bandwidth_bytes
            for i in range(1, len(bw)):
                if bw[i] < bw[i - 1] * 0.999:   # tolerate rounding
                    yield Diagnostic(
                        code=self.code, severity="warning",
                        message=f"benchmark {res.kernel!r} at "
                                f"{res.level}: bandwidth drops from "
                                f"{bw[i-1]/1e9:.1f} to {bw[i]/1e9:.1f} "
                                f"GB/s between {res.cores[i-1]} and "
                                f"{res.cores[i]} cores",
                        suggestion="re-measure or reorder the results "
                                   "row (curves should saturate, not "
                                   "shrink)",
                        subject=res.level)
                    break
        order = _level_order(m)
        by_key: dict[tuple, dict[str, object]] = {}
        for res in m.results:
            by_key.setdefault((res.kernel, res.threads_per_core),
                              {})[res.level] = res
        for (kname, _tpc), levels in by_key.items():
            names = sorted(levels, key=lambda n: order.get(n, 99))
            for near, far in zip(names, names[1:]):
                a, b = levels[near], levels[far]
                n = min(len(a.bandwidth_bytes), len(b.bandwidth_bytes))
                for i in range(n):
                    if a.bandwidth_bytes[i] < b.bandwidth_bytes[i]:
                        yield Diagnostic(
                            code=self.code, severity="error",
                            message=f"benchmark {kname!r}: {near} "
                                    f"({a.bandwidth_bytes[i]/1e9:.1f} "
                                    f"GB/s) is slower than the farther "
                                    f"{far} "
                                    f"({b.bandwidth_bytes[i]/1e9:.1f} "
                                    f"GB/s) at {a.cores[i]} core(s)",
                            suggestion="swap the mislabeled "
                                       "measurement rows",
                            subject=near)
                        break
        cpc = [(lv.name, lv.cycles_per_cacheline) for lv in m.levels
               if lv.cycles_per_cacheline is not None]
        for (n1, c1), (n2, c2) in zip(cpc, cpc[1:]):
            if c2 < c1:
                yield Diagnostic(
                    code=self.code, severity="warning",
                    message=f"cycles per cacheline transfer shrinks "
                            f"going outward: {n1}={c1} but {n2}={c2}",
                    suggestion="farther transfers cost at least as "
                               "many cycles; check the hierarchy order",
                    subject=n2)


@register_rule
class CacheGeometry(LintRule):
    """M202 — declared size must equal sets x ways x cacheline, sizes
    must grow outward, and per-level line sizes should match the
    machine's cacheline (the predictors use one global line size)."""

    code = "M202"
    family = "machine"
    title = "cache geometry consistency"
    needs = ("machine",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        m = ctx.machine
        for lv in m.levels:
            if lv.sets > 0 and lv.ways > 0:
                geom = lv.sets * lv.ways * lv.cl_size
                if lv.size_bytes and abs(geom - lv.size_bytes) > 0.5:
                    yield Diagnostic(
                        code=self.code, severity="error",
                        message=f"{lv.name}: declared size "
                                f"{lv.size_bytes:.0f} B != sets x ways "
                                f"x cl_size = {lv.sets} x {lv.ways} x "
                                f"{lv.cl_size} = {geom} B",
                        suggestion="fix the size or the geometry (the "
                                   "simulator allocates from "
                                   "sets/ways, LC from the size)",
                        subject=lv.name)
            if lv.cl_size != m.cacheline_bytes:
                yield Diagnostic(
                    code=self.code, severity="warning",
                    message=f"{lv.name}: line size {lv.cl_size} B "
                            f"differs from the machine cacheline "
                            f"{m.cacheline_bytes} B",
                    suggestion="the models use one global cacheline; "
                               "align cl_size with 'cacheline size'",
                    subject=lv.name)
        for a, b in zip(m.levels, m.levels[1:]):
            if a.size_bytes and b.size_bytes \
                    and b.size_bytes <= a.size_bytes:
                yield Diagnostic(
                    code=self.code, severity="error",
                    message=f"{b.name} ({b.size_bytes:.0f} B) is not "
                            f"larger than the nearer {a.name} "
                            f"({a.size_bytes:.0f} B)",
                    suggestion="hierarchy levels must grow outward; "
                               "check the 'memory hierarchy' order",
                    subject=b.name)


@register_rule
class PortsCoverage(LintRule):
    """M203 — the ports table must cover the op kinds the analysis will
    schedule: the kernel's lowered op stream when a kernel is in
    context, otherwise every kind the FLOPs-per-cycle table advertises
    (plus LOAD/STORE).  A missing FMA entry is fine when ADD and MUL
    exist (the documented decomposition, checked by M204)."""

    code = "M203"
    family = "machine"
    title = "ports-table coverage"
    needs = ("machine",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        m = ctx.machine
        if m.ports is None:
            yield Diagnostic(
                code=self.code, severity="info",
                message="no ports: table — the 'ports' in-core model "
                        "(--incore ports) is unavailable on this "
                        "machine",
                suggestion="add a ports: section to enable the port "
                           "scheduler",
                subject=m.name)
            return
        kernel = ctx.loop_kernel
        if kernel is not None:
            from ..incore.ir import lower_kernel
            needed = set(lower_kernel(kernel).counts())
        else:
            needed = {"LOAD", "STORE"}
            for rates in m.flops_per_cycle.values():
                needed |= {k for k in rates if k != "total"}
        if "FMA" in needed and "FMA" not in m.ports.entries:
            needed.discard("FMA")             # M204 checks the fallback
            needed |= {"ADD", "MUL"}
        for kind in sorted(needed - set(m.ports.entries)):
            yield Diagnostic(
                code=self.code, severity="error",
                message=f"ports table has no entry for op kind "
                        f"{kind}"
                        + (f", which {kernel.name!r}'s op stream uses"
                           if kernel is not None else
                           ", which the FLOPs-per-cycle table "
                           "advertises"),
                suggestion=f"add a ports entry for {kind}",
                subject=kind)


@register_rule
class FMADecomposition(LintRule):
    """M204 — a machine without an FMA port entry must offer both ADD
    and MUL entries, or FMA-carrying kernels cannot be scheduled at
    all."""

    code = "M204"
    family = "machine"
    title = "FMA decomposition"
    needs = ("machine",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        m = ctx.machine
        if m.ports is None or "FMA" in m.ports.entries:
            return
        missing = sorted({"ADD", "MUL"} - set(m.ports.entries))
        if missing:
            yield Diagnostic(
                code=self.code, severity="error",
                message="ports table has no FMA entry and misses "
                        f"{missing}, so FMA ops can neither issue "
                        "nor decompose",
                suggestion="add an FMA entry, or both ADD and MUL "
                           "entries (FMA then double-pumps them)",
                subject="FMA")


@register_rule
class ComputeCapability(LintRule):
    """M205 — the machine must declare some compute rate, the rates must
    be positive, and an x86 machine should cover both element sizes the
    C front end produces (DP for double, SP for float) — a missing class
    silently falls back to default rates."""

    code = "M205"
    family = "machine"
    title = "dtype / element-size support"
    needs = ("machine",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        m = ctx.machine
        if not m.flops_per_cycle and not m.peak_flops:
            yield Diagnostic(
                code=self.code, severity="error",
                message="machine declares no compute capability "
                        "(neither 'FLOPs per cycle' nor 'peak flops')",
                suggestion="add a FLOPs per cycle table",
                subject=m.name)
            return
        for cls, rates in m.flops_per_cycle.items():
            for kind, rate in rates.items():
                if not float(rate) > 0:
                    yield Diagnostic(
                        code=self.code, severity="error",
                        message=f"FLOPs per cycle {cls}.{kind} is "
                                f"{rate!r} (must be positive)",
                        suggestion="fix the rate; zero rates divide "
                                   "the in-core model by zero",
                        subject=cls)
        if m.arch == "x86" and m.flops_per_cycle:
            for cls, eb in (("DP", 8), ("SP", 4)):
                if cls not in m.flops_per_cycle:
                    yield Diagnostic(
                        code=self.code, severity="warning",
                        message=f"no {cls} FLOPs-per-cycle class: "
                                f"{eb}-byte-element kernels fall back "
                                "to default rates",
                        suggestion=f"add a {cls} row to 'FLOPs per "
                                   "cycle'",
                        subject=cls)
        if m.cacheline_bytes < 8:
            yield Diagnostic(
                code=self.code, severity="error",
                message=f"cacheline size {m.cacheline_bytes} B is "
                        "smaller than one double element",
                suggestion="fix 'cacheline size'",
                subject=m.name)


@register_rule
class HierarchyCompleteness(LintRule):
    """M206 — the hierarchy must exist and terminate in a memory with
    bandwidth; an inner level lacking both a cycles-per-cacheline and a
    bytes-per-cycle transfer rate silently defaults to the main-memory
    bandwidth in the ECM's transfer terms."""

    code = "M206"
    family = "machine"
    title = "hierarchy completeness"
    needs = ("machine",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        m = ctx.machine
        if not m.levels:
            yield Diagnostic(
                code=self.code, severity="error",
                message="machine declares no memory hierarchy levels",
                suggestion="add a 'memory hierarchy' section",
                subject=m.name)
            return
        if m.main_memory_bandwidth <= 0 and m.hbm_bandwidth <= 0:
            yield Diagnostic(
                code=self.code, severity="error",
                message="no main-memory (or HBM) bandwidth: the ECM "
                        "memory term and the Roofline MEM ceiling are "
                        "undefined",
                suggestion="add 'main memory bandwidth' (e.g. "
                           "'47.2 GB/s')",
                subject="MEM")
        for lv in m.levels[:-1]:
            if lv.cycles_per_cacheline is None \
                    and lv.bandwidth_bytes_per_cycle is None:
                yield Diagnostic(
                    code=self.code, severity="warning",
                    message=f"inner level {lv.name} declares neither "
                            "'cycles per cacheline transfer' nor "
                            "'bandwidth bytes per cycle'; its ECM "
                            "transfer term falls back to the main-"
                            "memory bandwidth",
                    suggestion=f"add a transfer rate to {lv.name}",
                    subject=lv.name)
