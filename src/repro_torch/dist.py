"""Analytic collective wire models (a copy of the JAX package's
``repro.dist`` wire-model section).

Fleet pricing (:mod:`repro_torch.fleet.pricing`) prices each
collective's ring-expanded wire bytes at the rate these functions give;
they read the machine description and the wire factors of
:mod:`repro_torch.core.hlo_analysis`, and nothing else.  The
executable distribution primitives of ``repro.dist`` (``gpipe``,
``compressed_psum_tree``) are a separate slice of the port (ROADMAP.md
Queue 1, item 5).
"""
from __future__ import annotations

from .core.hlo_analysis import _collective_wire_bytes


def collective_bandwidth(machine) -> float:
    """Bytes/s at which collective wire traffic drains on ``machine``.

    A machine with an ``ici link bandwidth`` field prices the ring on one
    link per hop, matching the module-level
    ``HLORooflineResult.t_collective`` term so per-op collective times
    conserve against the whole-module roofline (on ``h100_sxm.yaml`` the
    field holds the NVLink rate of one direction).  A machine without it
    (an x86 cache machine) moves intra-node collectives through shared
    memory, so the main memory bandwidth is the wire rate.
    """
    bw = float(getattr(machine, "ici_link_bandwidth", 0.0) or 0.0)
    if bw:
        return bw
    return float(getattr(machine, "main_memory_bandwidth", 0.0) or 0.0)


def collective_wire_time(wire_bytes: float, machine) -> float:
    """Seconds on the wire for already-ring-expanded ``wire_bytes``."""
    bw = collective_bandwidth(machine)
    return wire_bytes / bw if bw else 0.0


def collective_time(kind: str, payload_bytes: float, group: int,
                    machine) -> float:
    """Ring-model seconds for one collective: expand ``payload_bytes``
    through the per-kind wire factor (all-reduce 2(n-1)/n, all-gather
    (n-1)/n, reduce-scatter (n-1)x, all-to-all (n-1)/n, permute 1x —
    the factors of ``hlo_analysis._collective_wire_bytes``) and divide
    by :func:`collective_bandwidth`."""
    return collective_wire_time(
        _collective_wire_bytes(kind, payload_bytes, group), machine)
