"""Distributed primitives (DESIGN.md §5): int8 gradient compression with
error feedback for the data axis, a GPipe schedule over the pod axis, and
the analytic collective wire models.

Counterpart of ``repro.dist``.  Both primitives keep the math exact at
the API level: ``compressed_psum_tree`` returns the quantization residual
so callers re-inject it next step (error feedback — the residual
telescopes and the accumulated mean converges to the exact mean), and
``gpipe`` reproduces the sequential composition of stages while running
the (M + P - 1)-tick pipeline schedule with one stage's weights a rank.
JAX runs both inside ``shard_map`` from one controller; here every rank
is a process (SPMD) that calls them on its own tensors, and the
collectives go through ``torch.distributed`` (gloo on the CPU, NCCL on
the card).

The wire models at the bottom are a copy of the JAX module's: fleet
pricing (:mod:`repro_torch.fleet.pricing`) prices each collective's
ring-expanded wire bytes at the rate they give; they read the machine
description and the wire factors of :mod:`repro_torch.core.hlo_analysis`,
and nothing else.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .core.hlo_analysis import _collective_wire_bytes
from .models.common import tmap


class CompressionState(NamedTuple):
    """Per-rank error-feedback residual carried across steps."""
    error: torch.Tensor

    @classmethod
    def zeros_like(cls, grad: torch.Tensor) -> "CompressionState":
        return cls(error=torch.zeros_like(grad))


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale) with x ~ q * scale."""
    scale = x.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_tree(grad: torch.Tensor, error: torch.Tensor,
                         group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce ``grad`` over the ranks of ``group`` (a process group,
    e.g. ``mesh.get_group("data")``; None: every rank) with int8 wire
    compression.

    Each rank calls this on its own gradient (JAX: inside ``shard_map``).
    It quantizes ``grad + error`` to int8 (the wire format of the tree
    all-reduce), the dequantized values are summed across the group by
    one ``all_reduce``, and the local quantization residual is returned as
    the next step's ``error`` — so the compression error telescopes
    instead of accumulating.
    """
    x = grad + error
    q, scale = _quantize_int8(x)
    deq = q.to(x.dtype) * scale
    new_error = x - deq
    n = dist.get_world_size(group)
    total = deq.clone()
    dist.all_reduce(total, group=group)
    return total / n, new_error


class _Permute(torch.autograd.Function):
    """``jax.lax.ppermute`` along a ring: every rank of ``group`` sends
    its tensor to the next rank and takes the previous rank's.  The
    backward sends the gradient back along the transposed permutation."""

    @staticmethod
    def forward(ctx, y, group, shift: int):
        ctx.group, ctx.shift = group, shift
        return _ring(y, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring(g.contiguous(), ctx.group, -ctx.shift), None, None


def _ring(y: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    out = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(),
                      dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - shift) % n), group)]
    for r in dist.batch_isend_irecv(ops):
        r.wait()
    return out


class _SumStages(torch.autograd.Function):
    """JAX's closing ``psum``: the sum of every stage's output buffer,
    which only the last stage wrote.  Every rank holds the same result,
    and the loss built on it is one loss, not one a rank: the gradient of
    each rank's buffer is the result's gradient as it is."""

    @staticmethod
    def forward(ctx, outs, group):
        total = outs.clone()
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, g):
        return g, None


def gpipe(stage, mesh, axis: str = "pod", n_microbatches: int = 4):
    """GPipe pipeline over a mesh dim: ``stage(w, x) -> y`` applied by P
    consecutive stages whose weights ``ws[p]`` live one a rank.

    The returned callable ``piped(ws, x)`` — called by every rank with
    the stacked weights (a tensor, or a tree of them as JAX's pytree: each
    leaf a DTensor sharded over ``axis`` on dim 0, or the full stack, of
    which each rank takes its own row) and the same full batch — splits
    the batch into ``n_microbatches``, runs the (M + P - 1)-tick
    schedule — rank p executes microbatch t - p at tick t, activations
    hop to the next rank (a ring send, the counterpart of ``ppermute``)
    — and reassembles the full batch on every rank.
    Differentiable: the backward pipeline is the transposed permutation
    schedule.  At one stage the permutation is the identity.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    p = mesh.get_local_rank(axis)

    def piped(ws, x):
        m = n_microbatches
        if x.shape[0] % m:
            raise ValueError("n_microbatches must divide the batch size")
        mbs = x.reshape(m, x.shape[0] // m, *x.shape[1:])
        w = tmap(lambda a: a.to_local()[0] if isinstance(a, DTensor)
                 else a[p], ws)
        first = torch.tensor(p == 0, device=x.device)
        last = torch.tensor(p == n_stages - 1, device=x.device)
        h = torch.zeros_like(mbs[0])
        outs = [torch.zeros_like(mbs[0]) for _ in range(m)]
        for t in range(m + n_stages - 1):
            # stage 0 ingests microbatch t; everyone else continues the
            # activation handed over at the previous tick
            inp = torch.where(first, mbs[t], h) if t < m else h
            y = stage(w, inp)
            done = t - (n_stages - 1)
            if 0 <= done < m:     # last stage emits microbatch `done`
                outs[done] = outs[done] + torch.where(
                    last, y, torch.zeros_like(y))
            h = _Permute.apply(y, group, 1) if n_stages > 1 else y
        # only the last stage wrote
        total = _SumStages.apply(torch.stack(outs), group)
        return total.reshape(x.shape[0], *x.shape[1:])

    return piped


# ----------------------------------------------------------------------
# Analytic collective wire models (a copy of the JAX module's)
# ----------------------------------------------------------------------
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
