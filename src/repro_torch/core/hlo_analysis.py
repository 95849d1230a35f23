"""Kerncraft-for-XLA: roofline terms from compiled (SPMD-partitioned) HLO
(a copy of ``repro.core.hlo_analysis``: plain text parsing and float64
arithmetic, so both packages give the same numbers bit for bit).

This is the paper's pipeline retargeted at whole XLA programs: where
Kerncraft parses a C loop nest and produces {in-core, per-level transfer}
terms, we parse the *compiled per-device HLO module* and produce the three
TPU roofline terms:

    compute    T_c = MXU_FLOPs / peak_FLOP/s        (per chip)
    memory     T_m = HBM_bytes / HBM_bandwidth      (per chip)
    collective T_x = collective_bytes / link_bw     (per chip, ring model)

``compiled.cost_analysis()`` counts while-loop bodies ONCE (verified on
jax 0.8.2/XLA CPU), so scanned layer stacks would be undercounted by n_layers.
We therefore walk the HLO text ourselves: each ``while`` op carries
``backend_config={"known_trip_count":{"n":...}}``; computations reachable
from ENTRY inherit multiplicative trip counts, exactly like Kerncraft
multiplies per-iteration costs by the loop trip count (paper §2.1).

Byte accounting follows the fusion boundary (a fusion reads its operands
and writes its result once; fusion-internal ops contribute flops only) —
the XLA analog of "caches serve everything inside the loop body".
Collective payloads use ring-algorithm wire models:

    all-reduce          2 (n-1)/n x bytes
    all-gather          (n-1)/n x output bytes
    reduce-scatter      (n-1)   x output bytes   (input = n x output)
    all-to-all          (n-1)/n x bytes
    collective-permute  1       x bytes
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
from collections import defaultdict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "s4": 1, "u4": 1,
}

_ELEMENTWISE = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum",
    "and", "or", "xor", "not", "negate", "abs", "sign", "floor", "ceil",
    "round-nearest-afz", "round-nearest-even", "clamp", "select",
}
_TRANSCENDENTAL = {
    "exponential", "exponential-minus-one", "log", "log-plus-one", "tanh",
    "rsqrt", "sqrt", "cbrt", "power", "sine", "cosine", "atan2", "logistic",
    "erf", "expm1",
}
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_NO_TRAFFIC = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "bitcast-convert", "reshape", "broadcast", "iota", "after-all",
    "partition-id", "replica-id", "rng-get-and-update-state",
    # control flow passes state by reference; the real traffic is the ops
    # inside the called computations (counted with the loop multiplier)
    "while", "conditional", "call",
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
# type strings may contain /*index=N*/ comments, so match the opcode as the
# first bare word directly followed by '(' after the '=' sign
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*?)\s([\w\-]+)\((.*)$")
_CALLED_RE = re.compile(r"(?:calls|to_apply|condition|body|branch_computations)="
                        r"\{?%?([\w.\-]+(?:,\s*%[\w.\-]+)*)\}?")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_TRIP_RE = re.compile(r'known_trip_count[\\"=:{]+n[\\":]+(\d+)')


def _shape_bytes(type_str: str) -> int:
    """Total bytes of an HLO type string (sums tuple elements)."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(type_str: str) -> tuple[list[int], str]:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return [], ""
    dt, dims = m.groups()
    return [int(d) for d in dims.split(",") if d], dt


@dataclasses.dataclass
class Instr:
    name: str
    type_str: str
    opcode: str
    rest: str

    @property
    def result_bytes(self) -> int:
        return _shape_bytes(self.type_str)


@dataclasses.dataclass
class Computation:
    name: str
    instrs: list[Instr]
    shapes: dict[str, str]          # op name -> result type string


def parse_computations(hlo_text: str) -> tuple[dict[str, Computation], str]:
    """Split HLO text into computations; returns ({name: comp}, entry_name)."""
    comps: dict[str, Computation] = {}
    entry = None
    cur: Computation | None = None
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if not line.startswith(" ") and "{" in line and "(" in line:
            is_entry = stripped.startswith("ENTRY")
            m = re.match(r"(?:ENTRY\s+)?%?([\w.\-]+)\s*\(", stripped)
            if m:
                cur = Computation(m.group(1), [], {})
                comps[cur.name] = cur
                if is_entry:
                    entry = cur.name
                # parameters declared in the signature get shapes from lines
                continue
        if stripped == "}":
            cur = None
            continue
        if cur is None:
            continue
        m = _OP_RE.match(line)
        if not m:
            continue
        name, type_str, opcode, rest = m.groups()
        inst = Instr(name, type_str, opcode, rest)
        cur.instrs.append(inst)
        cur.shapes[name] = type_str
    if entry is None:  # fall back: last computation
        entry = list(comps)[-1] if comps else ""
    return comps, entry


def _group_size(rest: str, default: int) -> int:
    m = _GROUPS_IOTA_RE.search(rest)
    if m:
        return max(1, int(m.group(2)))
    m = _GROUPS_LIST_RE.search(rest)
    if m:
        return max(1, len(m.group(1).split(",")))
    return default


def _operands(inst: Instr, upto: str | None = None) -> list[str]:
    """Operand op-names: %refs in the call parens (before attributes)."""
    args = inst.rest.split("),")[0]
    return _OPERAND_RE.findall(args)


def _collective_wire_bytes(kind: str, result_bytes: int, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if kind == "all-gather":
        return (n - 1) / n * result_bytes
    if kind == "reduce-scatter":
        return float(n - 1) * result_bytes
    if kind == "all-to-all":
        return (n - 1) / n * result_bytes
    return float(result_bytes)        # collective-permute


@dataclasses.dataclass
class CollectiveRecord:
    kind: str
    result_bytes: int
    wire_bytes: float
    group_size: int
    multiplier: int
    op_name: str


@dataclasses.dataclass
class OpCost:
    """Per-instruction cost record (``analyze_hlo_text(per_op=True)``).

    Records are accumulated at the *same* points as the module totals, so
    summing any field over ``HLOAnalysis.ops`` reproduces the corresponding
    module total exactly (conservation by construction).  Fusion-internal
    ops fold their flops into the owning ``fusion`` record, mirroring the
    fusion-boundary byte accounting; while/conditional/call bodies get
    their own records with the inherited trip-count multiplier."""
    name: str
    opcode: str
    computation: str
    shape: str
    multiplier: int
    mxu_flops: float = 0.0
    vpu_flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    group_size: int = 0
    collective: str = ""              # wire-model kind, "" if not a collective

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "OpCost":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class HLOAnalysis:
    mxu_flops: float = 0.0            # dot/conv flops, per chip
    vpu_flops: float = 0.0            # elementwise/reduce flops, per chip
    hbm_bytes: float = 0.0            # fusion-boundary traffic, per chip
    collective_wire_bytes: float = 0.0
    collective_by_kind: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    schedule: list[CollectiveRecord] = dataclasses.field(default_factory=list)
    # profiling breakdowns: (opcode, result type) -> accumulated totals
    traffic_by_shape: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    flops_by_shape: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    # per-instruction records (only filled by analyze_hlo_text(per_op=True))
    ops: list[OpCost] = dataclasses.field(default_factory=list)

    @property
    def total_flops(self) -> float:
        return self.mxu_flops + self.vpu_flops

    def top_traffic(self, n: int = 12) -> list[tuple[str, float]]:
        """The dry-run 'profile': largest HBM-traffic contributors."""
        items = sorted(self.traffic_by_shape.items(), key=lambda kv: -kv[1])
        return [(f"{op} {ty}", b) for (op, ty), b in items[:n]]

    def top_flops(self, n: int = 8) -> list[tuple[str, float]]:
        items = sorted(self.flops_by_shape.items(), key=lambda kv: -kv[1])
        return [(f"{op} {ty}", f) for (op, ty), f in items[:n]]


def _dot_flops(inst: Instr, shapes: dict[str, str]) -> float:
    dims, _ = _shape_dims(inst.type_str)
    out_elems = math.prod(dims) if dims else 1
    ops = _operands(inst)
    contraction = 1
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", inst.rest)
    if m and ops:
        lhs_dims, _ = _shape_dims(shapes.get(ops[0], ""))
        for idx in m.group(1).split(","):
            if idx and int(idx) < len(lhs_dims):
                contraction *= lhs_dims[int(idx)]
    return 2.0 * out_elems * contraction


def _fusion_traffic(inst: Instr, called: Computation,
                    parent_shapes: dict[str, str]) -> float:
    """HBM bytes of one fusion execution: result + operands, where an
    operand consumed *only* through dynamic-slice/gather inside the fusion
    counts at slice size (the lax.scan stacked-weights pattern: each
    iteration reads one layer's slice, not the whole stack)."""
    total = float(inst.result_bytes)
    operand_names = _operands(inst)
    # parameter index -> internal name
    params: dict[int, str] = {}
    for i in called.instrs:
        if i.opcode == "parameter":
            try:
                params[int(i.rest.split(")")[0])] = i.name
            except ValueError:
                pass
    for idx, oname in enumerate(operand_names):
        full = _shape_bytes(parent_shapes.get(oname, ""))
        pname = params.get(idx)
        if pname is None:
            total += full
            continue
        consumers = [i for i in called.instrs
                     if pname in _operands(i)]
        if consumers and all(c.opcode in ("dynamic-slice", "gather")
                             for c in consumers):
            total += sum(c.result_bytes for c in consumers)
        else:
            total += full
    return total


def _slice_consumption(inst: Instr, comp: Computation,
                       comps: dict[str, Computation]) -> int | None:
    """If every consumer of ``inst`` only ever slices it (directly, or via
    a fusion whose corresponding parameter feeds only (dynamic-)slices),
    return the largest slice size — the AR+DS pattern. Else None."""
    consumers = [i for i in comp.instrs if inst.name in _operands(i)]
    if not consumers:
        return None
    best = 0
    for c in consumers:
        if c.opcode in ("dynamic-slice", "slice"):
            best = max(best, c.result_bytes)
            continue
        if c.opcode == "fusion":
            cm = re.search(r"calls=%([\w.\-]+)", c.rest)
            called = comps.get(cm.group(1)) if cm else None
            if called is None:
                return None
            try:
                pidx = _operands(c).index(inst.name)
            except ValueError:
                return None
            pname = None
            for i in called.instrs:
                if i.opcode == "parameter" and \
                        i.rest.split(")")[0] == str(pidx):
                    pname = i.name
                    break
            if pname is None:
                return None
            inner = [i for i in called.instrs if pname in _operands(i)]
            if not inner or not all(i.opcode in ("dynamic-slice", "slice")
                                    for i in inner):
                return None
            best = max(best, max(i.result_bytes for i in inner))
            continue
        return None
    return best or None


def analyze_hlo_text(hlo_text: str, default_group: int = 1,
                     assume_rs_rewrite: bool = True,
                     per_op: bool = False) -> HLOAnalysis:
    """``assume_rs_rewrite``: an all-reduce whose only consumers are
    (dynamic-)slices is the AR+DS pattern that XLA's TPU/GPU pipelines
    rewrite to a reduce-scatter (ReduceScatterCreator); the CPU pipeline
    used for this dry-run lacks the pass, so we re-cost such ARs as RS of
    the sliced result — (n-1)/n x slice instead of 2(n-1)/n x full.
    Disable to see the raw CPU-pipeline cost.

    ``per_op``: additionally record an :class:`OpCost` per contributing
    instruction in ``HLOAnalysis.ops``.  Every contribution is added to
    exactly one record via the same expression that feeds the module
    total, so the per-op sums conserve against the totals by construction
    (the fleet analyzer's invariant, pinned in tests)."""
    comps, entry = parse_computations(hlo_text)
    out = HLOAnalysis()
    # NB: no memoization — a computation invoked from two call sites executes
    # twice. HLO computations form a DAG, so recursion terminates.

    def visit(name: str, mult: int, traffic: bool, owner: OpCost | None = None):
        if name not in comps:
            return
        comp = comps[name]
        for inst in comp.instrs:
            op = inst.opcode
            dims, _ = _shape_dims(inst.type_str)
            elems = math.prod(dims) if dims else 1
            # the record this instruction's contributions accrue to: inside
            # a fusion (traffic=False paths) that is the owning fusion's
            # record; otherwise a fresh record for this instruction
            rec = None
            if per_op:
                rec = owner if owner is not None else OpCost(
                    name=inst.name, opcode=op, computation=comp.name,
                    shape=inst.type_str.split("{")[0].strip(),
                    multiplier=mult)
            # ---- flops --------------------------------------------------
            if op == "dot":
                f = mult * _dot_flops(inst, comp.shapes)
                out.mxu_flops += f
                out.flops_by_shape[(op, inst.type_str.split("{")[0])] += f
                if rec is not None:
                    rec.mxu_flops += f
            elif op == "convolution":
                f = mult * 2.0 * elems  # lower bound w/o kernel
                out.mxu_flops += f
                if rec is not None:
                    rec.mxu_flops += f
            elif op in _ELEMENTWISE or op in _TRANSCENDENTAL:
                f = mult * elems
                out.vpu_flops += f
                if rec is not None:
                    rec.vpu_flops += f
            elif op in ("reduce", "reduce-window"):
                ops_ = _operands(inst)
                in_elems = (math.prod(_shape_dims(
                    comp.shapes.get(ops_[0], ""))[0] or [1]) if ops_ else elems)
                f = mult * in_elems
                out.vpu_flops += f
                if rec is not None:
                    rec.vpu_flops += f
            # ---- collectives --------------------------------------------
            base = op[:-len("-start")] if op.endswith("-start") else op
            if base in _COLLECTIVES:
                n = _group_size(inst.rest, default_group)
                rbytes = inst.result_bytes
                if assume_rs_rewrite and base == "all-reduce":
                    sliced = _slice_consumption(inst, comp, comps)
                    if sliced is not None:
                        base = "reduce-scatter(rewritten)"
                        rbytes = sliced
                if base == "reduce-scatter(rewritten)":
                    wire = (n - 1) / n * rbytes      # RS of the slice
                else:
                    wire = _collective_wire_bytes(base, rbytes, n)
                out.collective_wire_bytes += mult * wire
                out.collective_by_kind[base] += mult * wire
                out.schedule.append(CollectiveRecord(
                    base, rbytes, wire, n, mult, inst.name))
                if rec is not None:
                    rec.wire_bytes += mult * wire
                    rec.group_size = n
                    rec.collective = base
            # ---- HBM traffic (fusion boundary) ---------------------------
            if traffic and op not in _NO_TRAFFIC:
                if op in ("dynamic-slice", "gather"):
                    tb = mult * 2 * inst.result_bytes
                elif op in ("dynamic-update-slice", "scatter"):
                    ops_ = _operands(inst)
                    upd = (_shape_bytes(comp.shapes.get(ops_[1], ""))
                           if len(ops_) > 1 else inst.result_bytes)
                    tb = mult * 2 * upd
                elif op == "fusion":
                    cm = re.search(r"calls=%([\w.\-]+)", inst.rest)
                    called = comps.get(cm.group(1)) if cm else None
                    if called is not None:
                        tb = mult * _fusion_traffic(inst, called, comp.shapes)
                    else:
                        tb = mult * inst.result_bytes
                else:
                    opb = sum(_shape_bytes(comp.shapes.get(o, ""))
                              for o in _operands(inst))
                    tb = mult * (opb + inst.result_bytes)
                out.hbm_bytes += tb
                out.traffic_by_shape[(op, inst.type_str.split("{")[0])] += tb
                if rec is not None:
                    rec.hbm_bytes += tb
            # ---- recursion ------------------------------------------------
            # called computations on traffic-carrying paths record their own
            # ops; fusion internals (flops-only paths) accrue to `rec`
            if op == "while":
                trip = 1
                tm = _TRIP_RE.search(inst.rest)
                if tm:
                    trip = int(tm.group(1))
                cm = re.search(r"condition=%([\w.\-]+)", inst.rest)
                bm = re.search(r"body=%([\w.\-]+)", inst.rest)
                if cm:
                    visit(cm.group(1), mult * trip, traffic,
                          None if traffic else rec)
                if bm:
                    visit(bm.group(1), mult * trip, traffic,
                          None if traffic else rec)
            elif op == "fusion":
                cm = re.search(r"calls=%([\w.\-]+)", inst.rest)
                if cm:
                    visit(cm.group(1), mult, False, rec)   # flops only
            elif op == "conditional":
                for branch in re.findall(r"%([\w.\-]+)",
                                         inst.rest.split("branch_computations=")[-1]
                                         .split("}")[0]) \
                        if "branch_computations=" in inst.rest else []:
                    visit(branch, mult, traffic, None if traffic else rec)
            elif op in ("call", "async-start"):
                cm = re.search(r"(?:to_apply|calls)=%([\w.\-]+)", inst.rest)
                if cm:
                    visit(cm.group(1), mult, traffic, None if traffic else rec)
            # NB: reduce/sort to_apply regions are per-element lambdas —
            # intentionally not recursed.
            if rec is not None and rec is not owner and (
                    rec.mxu_flops or rec.vpu_flops or rec.hbm_bytes
                    or rec.wire_bytes):
                out.ops.append(rec)

    visit(entry, 1, True)
    return out


# ----------------------------------------------------------------------
# Roofline report
# ----------------------------------------------------------------------
class TernaryRooflineTerms:
    """Composition over the three TPU terms (``t_compute``, ``t_memory``,
    ``t_collective``), shared by :class:`RooflineReport` and
    :class:`HLORooflineResult`."""

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_total_overlapped(self) -> float:
        """Roofline composition: everything overlaps (paper §1.2.1)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_total_serial(self) -> float:
        """ECM composition: transfers serialize (paper §1.2.2)."""
        return self.t_compute + self.t_memory + self.t_collective


@dataclasses.dataclass
class RooflineReport(TernaryRooflineTerms):
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-chip quantities
    mxu_flops: float
    vpu_flops: float
    hbm_bytes: float
    collective_bytes: float
    collective_by_kind: dict
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    # context
    model_flops: float            # 6·N·D (or 6·N_active·D) per chip
    memory_per_device: float      # from memory_analysis
    argument_bytes: float
    n_collectives: int

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs — catches remat/redundancy waste."""
        return self.model_flops / self.mxu_flops if self.mxu_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at the
        overlapped bound: useful model flops / (peak x bound time)."""
        if self.t_total_overlapped <= 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS_BF16) / self.t_total_overlapped

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["collective_by_kind"] = dict(self.collective_by_kind)
        d.update(dominant=self.dominant,
                 t_total_overlapped=self.t_total_overlapped,
                 t_total_serial=self.t_total_serial,
                 useful_flop_ratio=self.useful_flop_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


# TPU v5e constants, kept for parity with the JAX package: the fallbacks
# where a machine file lacks a field, and the fixed rates of
# roofline_from_compiled / RooflineReport
PEAK_FLOPS_BF16 = 197e12          # per chip
PEAK_FLOPS_FP32 = 8.25e12         # per chip (VPU, non-matmul work)
HBM_BW = 819e9                    # bytes/s per chip
ICI_LINK_BW = 50e9                # bytes/s per link


# ----------------------------------------------------------------------
# Registry-conformant result: the "hlo-roofline" PerformanceModel output
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HLORooflineResult(TernaryRooflineTerms):
    """Roofline terms of one HLO program against one machine — the Result
    shape of the registered ``"hlo-roofline"`` model, with the same
    ``to_dict()``/``from_dict()`` round-trip contract as ECM/Roofline
    results."""
    program: str
    machine: str
    mxu_flops: float
    vpu_flops: float
    hbm_bytes: float
    collective_wire_bytes: float
    collective_by_kind: dict
    n_collectives: int
    peak_flops: float                 # MXU flop/s for the compute term
    hbm_bandwidth: float              # bytes/s
    ici_bandwidth: float              # bytes/s per link
    vpu_peak_flops: float = PEAK_FLOPS_FP32   # non-matmul flop/s

    @property
    def total_flops(self) -> float:
        return self.mxu_flops + self.vpu_flops

    @property
    def t_compute(self) -> float:
        """MXU and VPU issue concurrently, so the compute term is the
        slower unit — a VPU-only program (e.g. a pure stencil) still gets
        a nonzero compute bound."""
        t_mxu = self.mxu_flops / self.peak_flops if self.peak_flops else 0.0
        t_vpu = self.vpu_flops / self.vpu_peak_flops \
            if self.vpu_peak_flops else 0.0
        return max(t_mxu, t_vpu)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bandwidth if self.hbm_bandwidth \
            else 0.0

    @property
    def t_collective(self) -> float:
        return self.collective_wire_bytes / self.ici_bandwidth \
            if self.ici_bandwidth else 0.0

    @property
    def bottleneck(self) -> str:
        return self.dominant

    @property
    def arithmetic_intensity(self) -> float:
        return self.total_flops / self.hbm_bytes if self.hbm_bytes else 0.0

    def to_dict(self) -> dict:
        return {
            "model": "hlo-roofline",
            "program": self.program,
            "machine": self.machine,
            "mxu_flops": self.mxu_flops,
            "vpu_flops": self.vpu_flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_wire_bytes": self.collective_wire_bytes,
            "collective_by_kind": dict(self.collective_by_kind),
            "n_collectives": self.n_collectives,
            "peak_flops": self.peak_flops,
            "hbm_bandwidth": self.hbm_bandwidth,
            "ici_bandwidth": self.ici_bandwidth,
            "vpu_peak_flops": self.vpu_peak_flops,
            # derived, for consumers that only read the dict:
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "t_total_overlapped": self.t_total_overlapped,
            "t_total_serial": self.t_total_serial,
            "bottleneck": self.bottleneck,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HLORooflineResult":
        return cls(program=str(d["program"]), machine=str(d["machine"]),
                   mxu_flops=float(d["mxu_flops"]),
                   vpu_flops=float(d["vpu_flops"]),
                   hbm_bytes=float(d["hbm_bytes"]),
                   collective_wire_bytes=float(d["collective_wire_bytes"]),
                   collective_by_kind=dict(d["collective_by_kind"]),
                   n_collectives=int(d["n_collectives"]),
                   peak_flops=float(d["peak_flops"]),
                   hbm_bandwidth=float(d["hbm_bandwidth"]),
                   ici_bandwidth=float(d["ici_bandwidth"]),
                   vpu_peak_flops=float(
                       d.get("vpu_peak_flops", PEAK_FLOPS_FP32)))


def roofline_result(analysis: HLOAnalysis, *, program: str = "hlo",
                    machine_name: str = "tpu-v5e",
                    peak_flops: float = PEAK_FLOPS_BF16,
                    hbm_bandwidth: float = HBM_BW,
                    ici_bandwidth: float = ICI_LINK_BW,
                    vpu_peak_flops: float = PEAK_FLOPS_FP32,
                    ) -> HLORooflineResult:
    """Package an :class:`HLOAnalysis` as the registry-conformant result."""
    return HLORooflineResult(
        program=program, machine=machine_name,
        mxu_flops=analysis.mxu_flops, vpu_flops=analysis.vpu_flops,
        hbm_bytes=analysis.hbm_bytes,
        collective_wire_bytes=analysis.collective_wire_bytes,
        collective_by_kind=dict(analysis.collective_by_kind),
        n_collectives=len(analysis.schedule),
        peak_flops=peak_flops, hbm_bandwidth=hbm_bandwidth,
        ici_bandwidth=ici_bandwidth, vpu_peak_flops=vpu_peak_flops)


def roofline_from_compiled(compiled, *, arch: str, shape: str, mesh: str,
                           chips: int, model_flops_global: float,
                           hlo_text: str | None = None) -> RooflineReport:
    """Build the report from a compiled executable (per-device module)."""
    txt = hlo_text if hlo_text is not None else compiled.as_text()
    ana = analyze_hlo_text(txt)
    try:
        ma = compiled.memory_analysis()
        mem = float(ma.argument_size_in_bytes + ma.output_size_in_bytes
                    + ma.temp_size_in_bytes)
        arg = float(ma.argument_size_in_bytes)
    except Exception:                 # pragma: no cover
        mem = arg = 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        mxu_flops=ana.mxu_flops, vpu_flops=ana.vpu_flops,
        hbm_bytes=ana.hbm_bytes,
        collective_bytes=ana.collective_wire_bytes,
        collective_by_kind=dict(ana.collective_by_kind),
        t_compute=ana.mxu_flops / PEAK_FLOPS_BF16,
        t_memory=ana.hbm_bytes / HBM_BW,
        t_collective=ana.collective_wire_bytes / ICI_LINK_BW,
        model_flops=model_flops_global / chips,
        memory_per_device=mem, argument_bytes=arg,
        n_collectives=len(ana.schedule))


def save_report(report: RooflineReport, path):
    with open(path, "w") as f:
        json.dump(report.to_dict(), f, indent=1)
