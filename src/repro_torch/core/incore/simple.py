"""The ``"simple"`` in-core model — the original machine-file heuristic.

A copy of ``repro.core.incore.simple`` without the TPU variant.  Divides
per-kind flop counts by the machine file's per-port rates (``FLOPs per
cycle``) and load/store bytes by the L1 port bandwidths: one ADD and one
MUL FP port of the native width, separate load/store ports with
byte-per-cycle throughputs.  Cycles are reported per *unit of work* (the
iterations spanning one cache line), split into the ECM's overlapping part
``T_OL`` (arithmetic + stores) and non-overlapping part ``T_nOL`` (loads),
exactly like Kerncraft aggregates IACA's per-port throughput into the two
classes listed in the machine file.

``precision`` defaults to ``"DP"`` and the ECM and Roofline models never
pass it, so float32 kernels are costed at the DP rates too — kept for
parity with the JAX package.
"""
from __future__ import annotations

from ..kernel_ir import LoopKernel
from ..machine import Machine
from .registry import InCoreModel, register_incore
from .result import InCoreResult


def analyze_x86(kernel: LoopKernel, machine: Machine,
                precision: str = "DP") -> InCoreResult:
    unit = kernel.iterations_per_cacheline(machine.cacheline_bytes)
    fc = kernel.flops
    rates = machine.flops_per_cycle.get(precision, {"ADD": 4, "MUL": 4})
    add_rate = float(rates.get("ADD", 4)) or 1e-12
    mul_rate = float(rates.get("MUL", 4)) or 1e-12
    div_rate = float(rates.get("DIV", add_rate / 14.0)) or 1e-12

    t_add = fc.add * unit / add_rate
    t_mul = fc.mul * unit / mul_rate
    t_div = fc.div * unit / div_rate
    # FMA counts against both ports on machines without FMA units
    fma_rate = float(rates.get("FMA", 0))
    if fma_rate:
        t_fma = fc.fma * unit / fma_rate
    else:
        t_fma = 0.0
        t_add += fc.fma * unit / add_rate
        t_mul += fc.fma * unit / mul_rate

    load_bytes = sum(a.array.element_bytes for a in kernel.reads()) * unit
    store_bytes = sum(a.array.element_bytes for a in kernel.writes()) * unit
    t_load = load_bytes / machine.load_bytes_per_cycle
    t_store = store_bytes / machine.store_bytes_per_cycle

    t_ol = max(t_add, t_mul, t_div, t_fma, t_store)
    t_nol = t_load
    return InCoreResult(
        unit_iterations=unit, t_ol=t_ol, t_nol=t_nol,
        port_cycles={"ADD": t_add, "MUL": t_mul, "DIV": t_div,
                     "FMA": t_fma, "LOAD": t_load, "STORE": t_store},
        flops_per_unit=fc.total * unit, model="simple")


def peak_performance(machine: Machine, precision: str = "DP") -> float:
    """Absolute peak, flops/cycle."""
    return float(machine.flops_per_cycle.get(precision, {}).get("total", 8))


def applicable_peak(kernel: LoopKernel, machine: Machine,
                    precision: str = "DP") -> float:
    """P_max of paper §1.2.1: peak reduced by the add/mul imbalance of the
    kernel (flops per cycle). With a balanced mix this is the full peak;
    with a pure-add or pure-mul kernel it is half (one port idle).

    A machine declaring an FMA rate issues FMA uops on the FMA port; only
    machines without one (e.g. Ivy Bridge) pay for an FMA on both the ADD
    and MUL ports.
    """
    fc = kernel.flops
    rates = machine.flops_per_cycle.get(precision, {"ADD": 4, "MUL": 4})
    fma_rate = float(rates.get("FMA", 0))
    if fma_rate:
        adds, muls, fmas = fc.add, fc.mul + fc.div, fc.fma
    else:
        adds, muls, fmas = fc.add + fc.fma, fc.mul + fc.fma + fc.div, 0
    total = fc.total
    if total == 0:
        return peak_performance(machine, precision)
    # cycles to issue one iteration's arithmetic, port-limited:
    cyc = max(adds / float(rates.get("ADD", 4)),
              muls / float(rates.get("MUL", 4)),
              fmas / fma_rate if fma_rate else 0.0)
    if cyc == 0:
        return peak_performance(machine, precision)
    return total / cyc


@register_incore
class SimpleInCoreModel(InCoreModel):
    """The machine-file heuristic preserved as the registered default."""

    name = "simple"

    def analyze(self, kernel: LoopKernel, machine: Machine,
                precision: str = "DP") -> InCoreResult:
        return analyze_x86(kernel, machine, precision=precision)
