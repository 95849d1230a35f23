"""The ``"ports"`` in-core model — a vectorized port scheduler (a copy of
``repro.core.incore.ports``; the OSACA analog, "Bridging the Architecture
Gap": abstract the performance-relevant port/throughput/latency properties
into the machine description).

The machine file's ``ports:`` table declares scheduler ports, per-port uop
throughputs, and instruction latencies (:mod:`repro_torch.core.machine`).
Scheduling an :class:`~repro_torch.core.incore.ir.OpStream` computes three
things:

* **per-port occupation** — uops distribute equally across their eligible
  ports (the OSACA assignment rule); arithmetic entries charge a
  reciprocal throughput per scalar op, memory entries scale by operand
  width against a per-port byte bandwidth;
* the **throughput bound** — the maximally occupied port per class:
  ``T_OL`` over the overlapping (compute + store) ports, ``T_nOL`` over
  the ports named ``non-overlapping`` (the load ports), exactly the two
  classes Kerncraft aggregates IACA output into (paper §2.5);
* the **latency bound** — the dependence-chain critical path, relaxed
  level-by-level over the stream's edges.  Independent iterations overlap
  in the out-of-order window, so latency only *binds* through a
  loop-carried dependence: ``T_lat = critical_path / distance`` per
  iteration.  ``InCoreResult.bound`` reports which bound binds.

Everything is vectorized over the op arrays (two ``bincount``s for
occupation, one ``np.maximum.at`` per dependence level for the critical
path); :func:`naive_schedule` is the per-op reference the parity tests
compare against.
"""
from __future__ import annotations

import numpy as np

from ..kernel_ir import LoopKernel
from ..machine import Machine, PortTable
from .ir import KIND_CODE, KINDS, OpStream, lower_kernel
from .registry import InCoreModel, register_incore
from .result import InCoreResult

_FMA = KIND_CODE["FMA"]


def _entry_weights(table: PortTable) -> tuple[np.ndarray, np.ndarray,
                                              np.ndarray, list]:
    """Per-kind scheduling constants: cycles per op (count-scaled),
    cycles per byte (width-scaled), latency, and eligible-port lists.

    An FMA op on a machine whose table has no FMA entry decomposes into
    one uop on the ADD entry's ports and one on the MUL entry's ports
    (its latency is the sum) — the same double-counting rule as the
    ``"simple"`` model and the pre-FMA x86 reality.
    """
    n = len(KINDS)
    cpo = np.zeros(n)
    cpb = np.zeros(n)
    lat = np.zeros(n)
    ports: list = [() for _ in range(n)]
    for kind, e in table.entries.items():
        c = KIND_CODE[kind]
        if e.cycles_per_op is not None:
            cpo[c] = e.cycles_per_op
        if e.bytes_per_cycle:
            cpb[c] = 1.0 / e.bytes_per_cycle
        lat[c] = e.latency
        ports[c] = e.ports
    return cpo, cpb, lat, ports


def _require_entries(stream: OpStream, table: PortTable) -> bool:
    """Check every op kind present in ``stream`` has a table entry;
    returns whether the FMA-decomposition fallback is active."""
    present = {KINDS[c] for c in np.unique(stream.kinds)}
    fma_fallback = "FMA" in present and "FMA" not in table.entries
    needed = set(present)
    if fma_fallback:
        needed.discard("FMA")
        needed.update({"ADD", "MUL"})
    missing = sorted(needed - set(table.entries))
    if missing:
        raise ValueError(
            f"ports table has no instruction entry for op kind(s) "
            f"{missing} used by {stream.name!r}; declared: "
            f"{sorted(table.entries)}")
    return fma_fallback


def schedule(stream: OpStream, table: PortTable) -> dict:
    """Vectorized port scheduling of one iteration's op stream.

    Returns ``occupation`` (cycles per scheduler port), ``kind_cycles``
    (effective cycles per op kind, spread over its ports), and
    ``critical_path`` (the dependence-chain latency, cycles) — all for
    ONE iteration; callers scale by the unit of work.
    """
    fma_fallback = _require_entries(stream, table)
    cpo, cpb, lat, ports = _entry_weights(table)

    nk = len(KINDS)
    count = np.bincount(stream.kinds, minlength=nk).astype(np.float64)
    nbytes = np.bincount(stream.kinds, weights=stream.widths.astype(
        np.float64), minlength=nk)
    if fma_fallback:
        # each FMA issues one uop on the ADD ports and one on the MUL ports
        for k in ("ADD", "MUL"):
            count[KIND_CODE[k]] += count[_FMA]
            nbytes[KIND_CODE[k]] += nbytes[_FMA]
        count[_FMA] = nbytes[_FMA] = 0.0

    occupation = dict.fromkeys(table.names, 0.0)
    kind_cycles = {}
    kind_total = count * cpo + nbytes * cpb
    for c in range(nk):
        if kind_total[c] == 0.0:
            continue
        eligible = ports[c] or ()
        t = kind_total[c] / max(1, len(eligible))
        kind_cycles[KINDS[c]] = t
        for p in eligible:
            occupation[p] += t

    # ---- critical path: level-by-level DAG relaxation -----------------
    op_lat = lat[stream.kinds]
    if fma_fallback:
        fma_lat = lat[KIND_CODE["ADD"]] + lat[KIND_CODE["MUL"]]
        op_lat = np.where(stream.kinds == _FMA, fma_lat, op_lat)
    n = len(stream)
    cp = 0.0
    if n:
        dist = np.zeros(n)
        if stream.n_edges:
            order = np.argsort(stream.levels[stream.edge_dst], kind="stable")
            src = stream.edge_src[order]
            dst = stream.edge_dst[order]
            lvl = stream.levels[dst]
            starts = np.flatnonzero(np.r_[True, lvl[1:] != lvl[:-1]])
            for a, b in zip(starts, np.r_[starts[1:], lvl.size]):
                np.maximum.at(dist, dst[a:b], dist[src[a:b]] + op_lat[src[a:b]])
        cp = float((dist + op_lat).max())
    return {"occupation": occupation, "kind_cycles": kind_cycles,
            "critical_path": cp}


def naive_schedule(stream: OpStream, table: PortTable) -> dict:
    """Per-op pure-Python reference scheduler (same contract as
    :func:`schedule`); the parity oracle and the benchmark baseline."""
    fma_fallback = _require_entries(stream, table)
    occupation = dict.fromkeys(table.names, 0.0)
    kind_cycles: dict[str, float] = {}
    lats = []
    for i in range(len(stream)):
        kind = KINDS[stream.kinds[i]]
        width = float(stream.widths[i])
        if kind == "FMA" and fma_fallback:
            uops = [("ADD", table.entries["ADD"]),
                    ("MUL", table.entries["MUL"])]
            lats.append(sum(e.latency for _, e in uops))
        else:
            uops = [(kind, table.entries[kind])]
            lats.append(uops[0][1].latency)
        for kname, e in uops:
            t = (e.cycles_per_op if e.cycles_per_op is not None
                 else width / e.bytes_per_cycle) / max(1, len(e.ports))
            kind_cycles[kname] = kind_cycles.get(kname, 0.0) + t
            for p in e.ports:
                occupation[p] += t
    dist = [0.0] * len(stream)
    edges = sorted(zip(stream.edge_src.tolist(), stream.edge_dst.tolist()),
                   key=lambda e: stream.levels[e[1]])
    for s, d in edges:
        dist[d] = max(dist[d], dist[s] + lats[s])
    cp = max((d + l for d, l in zip(dist, lats)), default=0.0)
    return {"occupation": occupation, "kind_cycles": kind_cycles,
            "critical_path": cp}


@register_incore
class PortSchedulerModel(InCoreModel):
    """Registry name ``"ports"``: lower the kernel to an op stream and
    schedule it against the machine's port table."""

    name = "ports"

    def analyze(self, kernel: LoopKernel, machine: Machine,
                stream: OpStream | None = None) -> InCoreResult:
        table = machine.ports
        if table is None:
            raise ValueError(
                f"machine {machine.name!r} declares no 'ports:' table; "
                "add one or use incore='simple'")
        unit = kernel.iterations_per_cacheline(machine.cacheline_bytes)
        stream = stream if stream is not None else lower_kernel(kernel)
        sched = schedule(stream, table)

        nonov = set(table.non_overlapping)
        occ = {p: float(c) * unit for p, c in sched["occupation"].items()}
        t_ol = max((c for p, c in occ.items() if p not in nonov), default=0.0)
        t_nol = max((c for p, c in occ.items() if p in nonov), default=0.0)

        cp = sched["critical_path"]
        lat_it = max((cp / d.distance for d in stream.carried), default=0.0)
        t_latency = lat_it * unit
        return InCoreResult(
            unit_iterations=unit, t_ol=t_ol, t_nol=t_nol,
            port_cycles={k: float(c) * unit
                         for k, c in sched["kind_cycles"].items()},
            flops_per_unit=kernel.flops.total * unit,
            model="ports", port_occupation=occ,
            t_latency=t_latency, critical_path=cp,
            bound=("latency" if t_latency > max(t_ol, t_nol)
                   else "throughput"))
