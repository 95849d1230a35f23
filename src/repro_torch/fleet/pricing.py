"""Per-op pricing: OpCost records x machine rates -> predicted times.

A copy of ``repro.fleet.pricing``.  The fleet analyzer's Stengel-style
decomposition (arXiv:1410.5010 applied per op): each
:class:`~repro_torch.core.hlo_analysis.OpCost` record gets the
four candidate times

    t_mxu        = mxu_flops / mxu_peak
    t_vpu        = vpu_flops / vpu_peak
    t_memory     = hbm_bytes / mem_bandwidth
    t_collective = wire_bytes / wire_bandwidth

its bound class (MXU | VPU | HBM | ICI, the largest term), and two
compositions: ``t_pred`` (roofline — everything overlaps, paper §1.2.1)
and ``t_serial`` (ECM — transfers serialize, §1.2.2).  All four terms are
linear in the record fields, so summing priced ops reproduces pricing the
module totals exactly — the conservation invariant the fleet gate pins.

:class:`MachineRates` adapts both machine dialects: TPU descriptions use
their native fields (``peak flops``, ``hbm bandwidth``, ``ici link
bandwidth``); x86 cache machines derive peak from FLOPs/cycle x clock x
cores and price both memory and collective traffic at the main memory
bandwidth (collectives inside one node move through shared memory) —
without relaxing the registered hlo-roofline model's TPU-only guard.
"""
from __future__ import annotations

import dataclasses

from .. import dist
from ..core.hlo_analysis import (OpCost, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32,
                                 HBM_BW, ICI_LINK_BW)
from ..core.machine import Machine

BOUND_CLASSES = ("MXU", "VPU", "HBM", "ICI")


@dataclasses.dataclass(frozen=True)
class MachineRates:
    """The four drain rates fleet pricing needs, from either dialect."""
    machine: str
    fingerprint: str
    kind: str                 # "tpu" | "x86"
    mxu_peak: float           # flop/s, matmul work
    vpu_peak: float           # flop/s, elementwise/reduce work
    mem_bandwidth: float      # bytes/s
    wire_bandwidth: float     # bytes/s (ICI link / shared memory)

    @classmethod
    def from_machine(cls, mach: Machine, dtype: str = "BF16"
                     ) -> "MachineRates":
        if mach.peak_flops or mach.hbm_bandwidth:
            if mach.peak_flops:
                peak = mach.peak_flops.get(dtype.upper())
                if peak is None:
                    raise ValueError(
                        f"machine {mach.name!r} has no peak flops for dtype "
                        f"{dtype!r}; available: {sorted(mach.peak_flops)}")
            else:
                peak = PEAK_FLOPS_BF16
            vpu = (mach.peak_flops or {}).get("FP32") or PEAK_FLOPS_FP32
            return cls(machine=mach.name, fingerprint=mach.fingerprint,
                       kind="tpu", mxu_peak=float(peak), vpu_peak=float(vpu),
                       mem_bandwidth=float(mach.hbm_bandwidth or HBM_BW),
                       wire_bandwidth=float(
                           dist.collective_bandwidth(mach) or ICI_LINK_BW))
        # x86 cache machine: aggregate socket peak, one rate for both
        # execution classes (there is no MXU/VPU split on the VPU-less CPU)
        fpc = mach.flops_per_cycle.get("DP") \
            or next(iter(mach.flops_per_cycle.values()), {})
        per_cycle = float(fpc.get("total")
                          or fpc.get("ADD", 0) + fpc.get("MUL", 0) or 1.0)
        peak = per_cycle * mach.clock_hz * mach.cores_per_socket
        return cls(machine=mach.name, fingerprint=mach.fingerprint,
                   kind="x86", mxu_peak=peak, vpu_peak=peak,
                   mem_bandwidth=float(mach.main_memory_bandwidth),
                   wire_bandwidth=dist.collective_bandwidth(mach))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PricedOp:
    """One OpCost record with its predicted times against one machine."""
    op: OpCost
    t_mxu: float
    t_vpu: float
    t_memory: float
    t_collective: float

    @property
    def t_compute(self) -> float:
        """MXU and VPU issue concurrently (HLORooflineResult.t_compute)."""
        return max(self.t_mxu, self.t_vpu)

    @property
    def t_pred(self) -> float:
        """Roofline composition: all terms overlap."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_serial(self) -> float:
        """ECM composition: transfers serialize behind compute."""
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def bound(self) -> str:
        terms = {"MXU": self.t_mxu, "VPU": self.t_vpu,
                 "HBM": self.t_memory, "ICI": self.t_collective}
        return max(BOUND_CLASSES, key=lambda k: terms[k])

    def to_dict(self) -> dict:
        d = self.op.to_dict()
        d.update(t_mxu=self.t_mxu, t_vpu=self.t_vpu,
                 t_memory=self.t_memory, t_collective=self.t_collective,
                 t_compute=self.t_compute, t_pred=self.t_pred,
                 t_serial=self.t_serial, bound=self.bound)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PricedOp":
        return cls(op=OpCost.from_dict(d),
                   t_mxu=float(d["t_mxu"]), t_vpu=float(d["t_vpu"]),
                   t_memory=float(d["t_memory"]),
                   t_collective=float(d["t_collective"]))


def price_op(op: OpCost, rates: MachineRates) -> PricedOp:
    return PricedOp(
        op=op,
        t_mxu=op.mxu_flops / rates.mxu_peak if rates.mxu_peak else 0.0,
        t_vpu=op.vpu_flops / rates.vpu_peak if rates.vpu_peak else 0.0,
        t_memory=op.hbm_bytes / rates.mem_bandwidth
        if rates.mem_bandwidth else 0.0,
        t_collective=op.wire_bytes / rates.wire_bandwidth
        if rates.wire_bandwidth else 0.0)


def price_ops(ops: list[OpCost], rates: MachineRates) -> list[PricedOp]:
    return [price_op(op, rates) for op in ops]
