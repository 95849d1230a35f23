"""Candidate spaces: enumerate and analytically rank tuning configurations.

The predict half of the predict → measure → calibrate loop; counterpart
of ``repro.tune.space``.  A family registers a :class:`CandidateSpace`
that (1) enumerates configurations, (2) scores all of them analytically
in one call, and (3) builds a runner that times one configuration on a
device.  Thousands of candidates cost milliseconds; only the top-k ever
run (:mod:`repro_torch.tune.measure`).  The stencil families rank through
:func:`repro_torch.core.blocking.grid_search` over the compiled sweep
plan, flash attention through a closed-form time model of its CUDA
kernels.

Each prediction carries its binding ``bound`` ('compute' or a memory
level), which :mod:`repro_torch.tune.calibrate` uses to attribute the
measured/predicted error to machine factors.
"""
from __future__ import annotations

import abc
import dataclasses
import math

import numpy as np
import torch

from ..core import api, blocking
from ..core.machine import Machine
from ..core.session import AnalysisSession
from ..kernels import _build
from ..kernels import flash_attention as fa
from ..kernels import longrange3d as _lr
from ..kernels import stencil3d7pt as _s7
from . import stencil as _stencil
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
    def predict(self, cands: list[Candidate],
                session: AnalysisSession | None = None) -> list[Prediction]:
        """Analytic predictions for ``cands``, order-aligned.  One call —
        pass a warm :class:`~repro_torch.core.session.AnalysisSession` to
        share compiled plans across repeated rankings."""

    @abc.abstractmethod
    def runner(self, params: dict, device):
        """A zero-argument closure running one kernel invocation for
        ``params`` on ``device`` (inputs prebuilt there); the timer
        synchronises around it."""


SPACE_REGISTRY: dict[str, type] = {}


def register_space(cls: type) -> type:
    SPACE_REGISTRY[cls.family] = cls
    return cls


def resolve_space(family: str, machine: Machine | str,
                  **config) -> CandidateSpace:
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
    padded to, and d the instantiated head dim a route pads to,
    ``fa.tc_head_dim`` or on simt ``fa.simt_head_dim``) on the unit its
    route names (``fa.MATMUL_UNIT``), once per pass (``fa.MATMUL_PASSES``:
    three for bf16x3; on simt the FFMA issue slots per FMA of the kernel
    the triple takes, ``fa.simt_issue_factor``), ~8 fp32 flops per score
    for the online softmax, and the route's fixed ``fa.STEP_OVERHEAD_CY``
    (``fa.SIMT_GENERAL_STEP_CY`` for the simt route's general kernel).  The card's peak is scaled by
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

    def predict(self, cands: list[Candidate],
                session: AnalysisSession | None = None) -> list[Prediction]:
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
            step_cy = fa.STEP_OVERHEAD_CY[r]
            peak_mm = m.peak_flops[fa.MATMUL_UNIT[r]] / fa.MATMUL_PASSES[r]
            if r == "simt":
                rows, dm = bq, fa.simt_head_dim(bq, bkv, d)
                peak_mm /= fa.simt_issue_factor(bq, bkv, d)
                if (bq, bkv, dm) not in fa.SIMT_TILED_SET:
                    step_cy = fa.SIMT_GENERAL_STEP_CY
            else:
                rows, dm = max(bq, fa.WGMMA_TILE_M), fa.tc_head_dim(d)
            t_mm = 4.0 * B * steps * rows * bkv * dm / (peak_mm * share)
            t_vec = 8.0 * B * steps * rows * bkv / (peak_vec * share)
            t_step = (B * steps * step_cy
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


# ----------------------------------------------------------------------
# stencils: spatial block edge n, ranked through grid_search
# ----------------------------------------------------------------------

#: the top of the block-edge range on a GPU machine file, where JAX's 128
#: stops short of the 132-SM regime change of the 7-point stencil at
#: float32 (between n 144 and 160; PERF.md §6)
GPU_N_MAX = 256


class _StencilSpace(CandidateSpace):
    """Spatial block-edge candidates for the 3D stencil kernels: the
    cutout is ``(m, n, n)`` and candidates vary ``n``.  Ranking runs the
    traced point function through
    :func:`repro_torch.core.blocking.grid_search` (compiled analytic plan,
    ECM) and converts cycles per unit of work into predicted seconds per
    sample; the measured side times the CUDA kernel through its ``ops``
    wrapper on the same cutout.  With ``cores`` > 1 the ranking runs over
    the batched (block x cores) grid and scores each block by its
    chip-level saturated performance at ``cores``.

    Departures from ``repro.tune.space._StencilSpace``, each for the card:

    * the point function is traced at 4-byte elements, the float32 the
      kernels run (the JAX space models 8-byte doubles and times float32;
      ROADMAP.md Queue 3);
    * a candidate is feasible exactly when the ``ops`` wrapper launches
      it: :func:`~repro_torch.core.blocking.stencil_cta_tile` plans the
      cutout and the plan passes ``check_launch`` and the grid check (in
      place of the TPU's VMEM plane count); an infeasible one carries the
      refusal;
    * ``cores`` defaults to the machine's cores per socket (the 132 SMs
      every launch spreads over on ``h100_sxm.yaml``, 1 on a TPU file),
      and on a GPU machine file ``n`` runs to :data:`GPU_N_MAX`;
    * ``bound`` names the term that sets each candidate's predicted time
      (:meth:`_bound`: ``L2`` for the saturating ``L2-MEM`` term at 132
      SMs) where the JAX space names the first level for every candidate
      from its winner alone — so a calibration factor scales the term
      the measurement speaks to.
    """

    MODULE = None                 # kernel module: point, RADIUS, OWN
    RADIUS = 1
    DEFAULTS = {"m": 16, "n_min": 32, "n_max": 128, "n_step": 16,
                "cores": None}

    def __init__(self, machine: Machine, **config):
        super().__init__(machine, **config)
        c = self.config
        if c["cores"] is None:
            c["cores"] = int(machine.cores_per_socket)
        if "n_max" not in config and machine.arch == "gpu":
            c["n_max"] = GPU_N_MAX
        for k in self.DEFAULTS:
            c[k] = int(c[k])
        if c["m"] < 1 or c["cores"] < 1 or c["n_step"] < 1:
            raise ValueError(f"{self.family}: m, cores and n_step must be "
                             f"positive, got {c}")
        if not self._values():
            raise ValueError(f"{self.family}: no block edge in "
                             f"[{c['n_min']}, {c['n_max']}]")

    def _values(self) -> list[int]:
        c = self.config
        lo = max(int(c["n_min"]), 2 * self.RADIUS + 2)
        return list(range(lo, int(c["n_max"]) + 1, int(c["n_step"])))

    def candidates(self) -> list[Candidate]:
        return [Candidate.make(self.family, n=v) for v in self._values()]

    def default(self) -> Candidate:
        vals = self._values()
        return Candidate.make(self.family, n=vals[len(vals) // 2])

    def shape(self, n: int) -> tuple[int, int, int]:
        return int(self.config["m"]), int(n), int(n)

    def _points(self, n: int) -> int:
        r = self.RADIUS
        return max(1, (int(self.config["m"]) - 2 * r) * (n - 2 * r) ** 2)

    def repeats(self, n: int) -> int:
        """Invocations per timed sample so every candidate processes the
        same reference volume (the largest candidate's point count) —
        raw per-cutout seconds would trivially crown the smallest block.
        Predictions scale by the same count, keeping predicted and
        measured walls directly comparable per candidate."""
        ref = self._points(max(self._values()))
        return max(1, round(ref / self._points(n)))

    def plan(self, n: int) -> blocking.StencilPlan:
        """The launch plan the ``ops`` wrapper takes for the cutout at
        ``n``; raises ``ValueError`` naming the limit it breaks."""
        mod = self.MODULE
        plan = blocking.stencil_cta_tile(mod.RADIUS, self.shape(n), mod.OWN)
        _build.check_tile(blocking.check_launch(plan, mod.RADIUS, mod.OWN),
                          self.shape(n)[:2])
        return plan

    @staticmethod
    def _bound(res, cores: int) -> str:
        """The term class that sets ``res``'s time at ``cores``: compute,
        else the source level of the transfer that binds — the last one
        (to memory) where ``cores`` saturate it, else the largest."""
        terms = res.contributions + res.overlapped
        if not terms or (res.t_ol >= res.t_data and all(
                res.t_ol >= c for _, c in res.overlapped)):
            return "compute"
        if cores > 1 and res.saturation_cores <= cores:
            label = terms[-1][0]
        else:
            label = max(terms, key=lambda t: t[1])[0]
        return label.split("-", 1)[0]

    def predict(self, cands: list[Candidate],
                session: AnalysisSession | None = None) -> list[Prediction]:
        m = self.machine
        sess = session if session is not None else AnalysisSession(m)
        kernel = api.load_kernel(f"trace:{self.family}",
                                 {"M": int(self.config["m"])},
                                 element_bytes=4)
        vals = sorted({int(c.config["n"]) for c in cands})
        n_cores = int(self.config["cores"])
        if n_cores > 1:
            # rank over the batched (block x cores) grid: per-candidate
            # score = saturated min(single*n, sat) at the target core
            # count, converted back to effective cycles per unit below
            gs = blocking.grid_search(kernel, m, [("N", vals)],
                                      model="ecm", session=sess,
                                      cores=list(range(1, n_cores + 1)))
            r0 = gs.best_result
            perf = {n: float(gs.scores[i, -1])
                    for i, n in enumerate(vals)}
            score = {n: (r0.flops_per_unit * m.clock_hz / p
                         if p > 0 else math.inf)
                     for n, p in perf.items()}
        else:
            gs = blocking.grid_search(kernel, m, [("N", vals)],
                                      model="ecm", session=sess)
            score = {p["N"]: s for p, s in gs.ranking}
        unit = gs.best_result.unit_iterations
        out: list[Prediction] = []
        for cand in cands:
            n = int(cand.config["n"])
            try:
                self.plan(n)
            except ValueError as e:
                out.append(Prediction(math.inf, feasible=False,
                                      reason=str(e)))
                continue
            res = sess.analyze(kernel.bind(N=n), "ecm", cores=n_cores)
            secs = (score[n] / unit / m.clock_hz * self._points(n)
                    * self.repeats(n))
            out.append(Prediction(secs, bound=self._bound(res, n_cores)))
        return out

    def runner(self, params: dict, device):
        n = int(params["n"])
        args = _stencil.make_inputs(self.family, self.shape(n), device)
        op = _stencil.family(self.family).op
        reps = self.repeats(n)

        def run():
            for _ in range(reps):
                out = op(*args)
            return out
        return run


@register_space
class Stencil7ptSpace(_StencilSpace):
    family = "stencil3d7pt"
    MODULE = _s7
    RADIUS = _s7.RADIUS
    sources = ("stencil3d7pt",)


@register_space
class LongRange3DSpace(_StencilSpace):
    family = "longrange3d"
    MODULE = _lr
    RADIUS = _lr.RADIUS
    sources = ("longrange3d",)


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


def attention_backward_bound(q: torch.Tensor, k: torch.Tensor, *,
                             causal: bool = True,
                             q_offset: int | None = None,
                             machine: Machine | str = "H100",
                             unit: str | None = None) -> Bound:
    """The least time for one attention backward on ``machine``: ``10·d``
    flops per visible (query, key) pair — S recomputed, dP, dV, dQ and dK,
    two and a half forward passes (:func:`attention_bound`'s count), the
    same count the graph analysis prices the backward operator at — at
    the arithmetic ``unit`` names (bfloat16 one bf16 pass by default),
    and q, k, v and dO read once, dq, dk and dv written once and the
    rows' fp32 LSE and D written once at the HBM rate."""
    fwd = attention_bound(q, k, causal=causal, q_offset=q_offset,
                          machine=machine, unit=unit)
    b, h, sq, _ = q.shape
    moved = 3 * q.nbytes + 4 * k.nbytes + 8 * b * h * sq
    return Bound(bytes=moved,
                 bytes_s=moved / api.resolve_machine(machine).hbm_bandwidth,
                 ops_s=2.5 * fwd.ops_s)
