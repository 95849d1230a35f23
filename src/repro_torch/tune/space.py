"""Candidate spaces: enumerate and analytically rank tuning configurations.

The predict half of the predict → measure → calibrate loop; counterpart
of ``repro.tune.space``.  A family registers a :class:`CandidateSpace`
that (1) enumerates configurations, (2) scores all of them analytically
in one call, and (3) builds a runner that times one configuration on a
device.  Thousands of candidates cost milliseconds; only the top-k ever
run (:mod:`repro_torch.tune.measure`).

Each prediction carries its binding ``bound`` ('compute' or a memory
level), which :mod:`repro_torch.tune.calibrate` uses to attribute the
measured/predicted error to machine factors.

Only flash attention is ported.  The stencil families rank through
``blocking.grid_search`` over the compiled sweeps, which the port does
not have yet: :func:`resolve_space` names the ROADMAP item for them.
"""
from __future__ import annotations

import abc
import dataclasses
import math

import numpy as np
import torch

from ..core import api, blocking
from ..core.machine import Machine
from ..kernels import flash_attention as fa
from .measure import Bound


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of a family's configuration space; ``params`` is a sorted
    tuple of pairs so candidates hash and compare by value."""
    family: str
    params: tuple[tuple[str, int], ...]

    @property
    def config(self) -> dict:
        return dict(self.params)

    @staticmethod
    def make(family: str, **params) -> "Candidate":
        return Candidate(family, tuple(sorted(params.items())))


@dataclasses.dataclass(frozen=True)
class Prediction:
    """Analytic score for one candidate: predicted wall seconds per kernel
    invocation, the binding term class ('compute' or a memory level name),
    and feasibility (with the reason when infeasible)."""
    seconds: float
    bound: str = ""
    feasible: bool = True
    reason: str = ""


class CandidateSpace(abc.ABC):
    """One kernel family's tunable configuration space.

    ``config`` holds the *problem shape* (what the caller is stuck with);
    candidates hold the *tunables* (block shapes — what the tuner may
    change).  Subclasses declare ``family``, ``DEFAULTS`` and ``sources``
    (the ``csrc`` kernels their runners launch, built by the tuner before
    any measuring child starts) and implement the four hooks below.
    """

    family: str = ""
    DEFAULTS: dict = {}
    sources: tuple[str, ...] = ()

    def __init__(self, machine: Machine, **config):
        unknown = sorted(set(config) - set(self.DEFAULTS))
        if unknown:
            raise ValueError(
                f"unknown {self.family} config key(s) {unknown}; "
                f"accepted: {sorted(self.DEFAULTS)}")
        self.machine = machine
        self.config = {**self.DEFAULTS, **config}

    @abc.abstractmethod
    def candidates(self) -> list[Candidate]:
        """Every enumerated candidate (feasibility is judged by
        :meth:`predict`); must include :meth:`default`."""

    @abc.abstractmethod
    def default(self) -> Candidate:
        """The shipped configuration the tuner must beat; always
        feasible for the space's problem shape."""

    @abc.abstractmethod
    def predict(self, cands: list[Candidate]) -> list[Prediction]:
        """Analytic predictions for ``cands``, order-aligned."""

    @abc.abstractmethod
    def runner(self, params: dict, device):
        """A zero-argument closure running one kernel invocation for
        ``params`` on ``device`` (inputs prebuilt there); the timer
        synchronises around it."""


SPACE_REGISTRY: dict[str, type] = {}

#: families of the JAX tuner that the port has not ported yet
NOT_PORTED = {
    "stencil3d7pt": "ROADMAP Queue 1, item 4 (the stencil tune spaces wait "
                    "for the compiled sweeps and grid_search)",
    "longrange3d": "ROADMAP Queue 1, item 4 (the stencil tune spaces wait "
                   "for the compiled sweeps and grid_search)",
}


def register_space(cls: type) -> type:
    SPACE_REGISTRY[cls.family] = cls
    return cls


def resolve_space(family: str, machine: Machine | str,
                  **config) -> CandidateSpace:
    if family in NOT_PORTED:
        raise ValueError(f"tune family {family!r} is not ported yet: "
                         f"{NOT_PORTED[family]}")
    try:
        cls = SPACE_REGISTRY[family]
    except KeyError:
        raise ValueError(
            f"unknown tune family {family!r}; registered: "
            f"{sorted(SPACE_REGISTRY)}") from None
    return cls(api.resolve_machine(machine), **config)


# ----------------------------------------------------------------------
# flash attention: (block_q, block_kv)
# ----------------------------------------------------------------------

@register_space
class FlashAttentionSpace(CandidateSpace):
    """``(block_q, block_kv)`` for the CUDA flash-attention kernels
    (:mod:`repro_torch.kernels.flash_attention`), each candidate on the
    route the wrapper would take for it (``fa.route``).

    The closed-form time model follows the kernels' schedule: one CTA per
    (batch·head, q block) walks its kv blocks, skipping those wholly above
    the causal diagonal, so the exact visited-step count enters the
    model.  Per visited step the CTA does the two products (4·rows·bkv·d
    flops, rows = bq, or the 64-row tile a short tensor-core q block is
    padded to, and d the instantiated head dim a tensor-core route pads
    to, ``fa.tc_head_dim``) on the unit its route names
    (``fa.MATMUL_UNIT``), once per pass (``fa.MATMUL_PASSES``: three for
    bf16x3), ~8 fp32 flops per score for the online softmax, and the
    route's fixed ``fa.STEP_OVERHEAD_CY``.  The card's peak is scaled by
    the share of its SMs that the ``b·h·(seq_q/block_q)`` CTAs keep
    busy.  The per-step overhead is latency, hidden across the CTAs
    resident at once: it is spread over ``min(ctas, SMs × CTAs per SM)``,
    CTAs per SM from the route's shared memory and threads
    (``LaunchLimits.ctas_per_sm``).  HBM
    traffic streams q/out once and re-fetches k/v per visited step, at
    the real head dim (TMA fills the padding without reading it), at
    4 bytes per element on bf16x3 (a hi and a lo bf16).  The predicted
    seconds are ``max(compute, hbm)``, plus, on bf16x3, the split pass's
    bytes at the HBM rate (``fa.split_bytes``); HBM-bound candidates are
    attributed to the last cache level (the L2 → memory transfer).  A
    candidate is feasible when its blocks divide the lengths and
    :func:`~repro_torch.kernels.flash_attention.launch_limits` accept them
    — the wrapper's own checks.
    """

    family = "flash_attention"
    DEFAULTS = {"batch": 1, "heads": 4, "seq_q": 512, "seq_kv": 512,
                "head_dim": 128, "causal": True, "dtype": "bfloat16"}
    sources = tuple(fa.SOURCES.values())

    def __init__(self, machine: Machine, **config):
        super().__init__(machine, **config)
        c = self.config
        c["causal"] = c["causal"] not in (False, 0, "0", "false", "False")
        self.dtype = fa.torch_dtype(str(c["dtype"]))
        sq, skv, d = (int(c[k]) for k in ("seq_q", "seq_kv", "head_dim"))
        if min(sq, skv, d) <= 0 or sq % fa.GRANULE or skv % fa.GRANULE \
                or d % fa.GRANULE:
            raise ValueError(
                f"seq_q={sq}, seq_kv={skv} and head_dim={d} must be "
                f"positive multiples of {fa.GRANULE} for the CUDA kernel")
        if c["causal"] and sq > skv:
            raise ValueError(
                f"causal seq_q={sq} > seq_kv={skv} leaves rows that see no "
                "key (ROADMAP Queue 3); the kernel refuses such calls")

    def _elem_bytes(self) -> int:
        return self.dtype.itemsize

    def _lattice(self, n: int, axis: int) -> list[int]:
        """Block sizes enumerated along ``axis`` (0: q, 1: kv) for a length
        ``n``: the granule's powers of two below a warp, then multiples of
        the warp size, up to ``n`` and to the largest block that launches
        with the other block at its smallest (:func:`launch_limits`, on
        the CUDA-core route that a granule-wide block takes); at a
        head_dim the tensor cores take (``fa.tc_head_dim``), also the
        blocks of the dtype's tensor-core set (wgmma in bfloat16, bf16x3
        in float32) at its instantiated head dim, up to ``n``."""
        warp = int(self.machine.extra.get("warp size", 32))
        d = int(self.config["head_dim"])
        small = [fa.GRANULE << k for k in range(8)
                 if (fa.GRANULE << k) < warp]
        out = []
        for b in small + list(range(warp, n + 1, warp)):
            pair = (b, fa.GRANULE) if axis == 0 else (fa.GRANULE, b)
            if b > n or not fa.launch_limits(*pair, d, self.dtype).ok:
                break
            out.append(b)
        dd = fa.tc_head_dim(d)
        tc = {t[axis] for t in fa.tc_set(self.dtype) if t[2] == dd}
        return sorted(set(out) | {b for b in tc if b <= n})

    def candidates(self) -> list[Candidate]:
        sq, skv = int(self.config["seq_q"]), int(self.config["seq_kv"])
        out = [Candidate.make(self.family, block_q=bq, block_kv=bkv)
               for bq in self._lattice(sq, 0)
               for bkv in self._lattice(skv, 1)]
        seen = set(out)
        # seed the advisor's pick and the shipped default so both are
        # always scored even when the lattice above misses them
        for cand in (self._advisor(), self.default()):
            if cand not in seen:
                out.append(cand)
                seen.add(cand)
        return out

    def _advisor(self) -> Candidate:
        sq, skv = int(self.config["seq_q"]), int(self.config["seq_kv"])
        d = int(self.config["head_dim"])
        t = blocking.attention_cta_tiles(sq, skv, d, self.dtype)
        bq, bkv = fa.fit_blocks(sq, skv, t.bq, t.bkv, d, self.dtype)
        return Candidate.make(self.family, block_q=bq, block_kv=bkv)

    def default(self) -> Candidate:
        bq, bkv = fa.default_config(int(self.config["seq_q"]),
                                    int(self.config["seq_kv"]),
                                    int(self.config["head_dim"]), self.dtype)
        return Candidate.make(self.family, block_q=bq, block_kv=bkv)

    def route(self, cand: Candidate) -> str:
        """The kernel the wrapper launches for ``cand``."""
        p = cand.config
        return fa.route(p["block_q"], p["block_kv"],
                        int(self.config["head_dim"]), self.dtype)

    def concurrency(self, bq: int, bkv: int) -> int:
        """CTAs resident on the card at once for ``(bq, bkv)``:
        ``min(ctas, SMs × CTAs per SM)``."""
        c = self.config
        ctas = int(c["batch"]) * int(c["heads"]) * (int(c["seq_q"]) // bq)
        lim = fa.launch_limits(bq, bkv, int(c["head_dim"]), self.dtype)
        return min(ctas, int(self.machine.extra["SM count"])
                   * lim.ctas_per_sm)

    def _steps(self, bq: int, bkv: int) -> int:
        """kv steps per (batch·head) actually visited: causal schedules
        skip kv blocks entirely above the diagonal (the kernel's loop
        bound)."""
        sq, skv = int(self.config["seq_q"]), int(self.config["seq_kv"])
        nq, nk = sq // bq, skv // bkv
        if not self.config["causal"]:
            return nq * nk
        off = skv - sq
        qi = np.arange(nq)
        last = qi * bq + off + bq - 1          # last kv position touched
        return int(np.minimum(nk, last // bkv + 1).clip(min=0).sum())

    def predict(self, cands: list[Candidate]) -> list[Prediction]:
        m = self.machine
        c = self.config
        sq, skv = int(c["seq_q"]), int(c["seq_kv"])
        d = int(c["head_dim"])
        B = int(c["batch"]) * int(c["heads"])
        sms = int(m.extra["SM count"])
        peak_vec = m.peak_flops["FP32"]
        out: list[Prediction] = []
        for cand in cands:
            p = cand.config
            bq, bkv = int(p["block_q"]), int(p["block_kv"])
            if bq <= 0 or bkv <= 0 or sq % bq or skv % bkv:
                out.append(Prediction(math.inf, feasible=False,
                                      reason=f"{bq}x{bkv} does not tile "
                                             f"{sq}x{skv}"))
                continue
            lim = fa.launch_limits(bq, bkv, d, self.dtype)
            if not lim.ok or sq // bq > fa.MAX_Q_BLOCKS:
                out.append(Prediction(
                    math.inf, feasible=False,
                    reason=lim.reason or f"{sq // bq} q blocks exceed "
                                         f"{fa.MAX_Q_BLOCKS}"))
                continue
            steps = self._steps(bq, bkv)
            share = min(B * (sq // bq), sms) / sms
            r = lim.route
            rows, dm = ((bq, d) if r == "simt"
                        else (max(bq, fa.WGMMA_TILE_M), fa.tc_head_dim(d)))
            peak_mm = m.peak_flops[fa.MATMUL_UNIT[r]] / fa.MATMUL_PASSES[r]
            t_mm = 4.0 * B * steps * rows * bkv * dm / (peak_mm * share)
            t_vec = 8.0 * B * steps * rows * bkv / (peak_vec * share)
            t_step = (B * steps * fa.STEP_OVERHEAD_CY[r]
                      / (m.clock_hz * self.concurrency(bq, bkv)))
            t_compute = t_mm + t_vec + t_step
            # bytes per element streamed: the input type's; on bf16x3 a
            # hi and a lo bf16, 4 as in f32
            e = self._elem_bytes()
            bytes_hbm = (2.0 * B * sq * d * e            # q in, out
                         + 2.0 * B * steps * bkv * d * e)  # k, v re-fetch
            t_hbm = bytes_hbm / m.hbm_bandwidth
            t_split = 0.0
            if r == "bf16x3":
                t_split = fa.split_bytes(B * sq * d, B * skv * d) \
                    / m.hbm_bandwidth
            bound = "compute" if t_compute >= t_hbm else m.level_names[-1]
            out.append(Prediction(max(t_compute, t_hbm) + t_split,
                                  bound=bound))
        return out

    def inputs(self, device, seed: int = 0) -> tuple[torch.Tensor, ...]:
        """q, k, v of the space's shape on ``device``, normal from
        ``seed`` (made on the device, in fp32, then rounded)."""
        c = self.config
        dev = torch.device(device)
        b, h, d = int(c["batch"]), int(c["heads"]), int(c["head_dim"])
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tuple(
            torch.randn((b, h, int(c[s]), d), generator=gen, device=dev
                        ).to(self.dtype)
            for s in ("seq_q", "seq_kv", "seq_kv"))

    def runner(self, params: dict, device):
        q, k, v = self.inputs(device)
        bq, bkv = int(params["block_q"]), int(params["block_kv"])
        causal = bool(self.config["causal"])

        def run():
            return fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                      block_kv=bkv)
        return run


#: the arithmetic an attention bound is taken at: the machine file's
#: peak-rate key and the passes each product takes
BOUND_UNITS = {"BF16": ("BF16", 1), "BF16x3": ("BF16", 3),
               "FP32": ("FP32", 1)}


def attention_bound(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                    q_offset: int | None = None,
                    machine: Machine | str = "H100",
                    unit: str | None = None) -> Bound:
    """The least time for one attention call on ``machine``: q, k, v read
    once and the output written once at the HBM rate; ``4·d`` flops per
    visible (query, key) pair at the arithmetic ``unit`` names
    (:data:`BOUND_UNITS`).  By default bfloat16 takes one bf16 pass, and
    float32 three (``"BF16x3"``): the least arithmetic that meets the
    reference's f32 tolerance on this card.  ``unit="FP32"`` gives the
    floor of the fp32 CUDA cores."""
    mach = api.resolve_machine(machine)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if q_offset is None:
        q_offset = skv - sq
    if causal:
        pairs = int(np.clip(np.arange(sq) + q_offset + 1, 0, skv).sum())
    else:
        pairs = sq * skv
    flops = 4.0 * d * pairs * b * h
    if unit is None:
        unit = "BF16" if q.dtype == torch.bfloat16 else "BF16x3"
    key, passes = BOUND_UNITS[unit]
    moved = 2 * q.nbytes + 2 * k.nbytes
    return Bound(bytes=moved, bytes_s=moved / mach.hbm_bandwidth,
                 ops_s=passes * flops / mach.peak_flops[key])
