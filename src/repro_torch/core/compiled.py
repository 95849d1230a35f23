"""Compiled analytic sweep plans (a copy of ``repro_torch.core.compiled``).

The paper's headline workflows — layer-condition transition points and
ab-initio blocking-factor prediction (§2.4.2, Listing 5) — evaluate the
model at *many* parameter points, and every cold point used to pay full
sympy cost: ``kernel.bind(N=n)`` plus a fresh symbolic LC evaluation per
point.  A :class:`CompiledSweepPlan` lowers the symbolic pipeline **once**
per kernel structure and sweep-symbol set:

  1. the per-array offset orderings and the reuse-distance list become
     ``sympy.lambdify``'d numpy callables of the sweep symbols (any other
     unbound symbol is fixed at the generic size, mirroring
     ``layer_conditions._numeric``);
  2. ``C_req(t)``, the chosen threshold, hits/misses/write-backs, and the
     per-level traffic β_k are evaluated for an **entire value grid in one
     batched numpy call** (`lc_tables`) — including grids with a ``cores``
     axis, where the per-point effective cache sizes are themselves arrays
     (the vectorized mirror of ``layer_conditions.effective_level_sizes``);
  3. the ECM and Roofline closed forms over those traffic arrays come from
     :func:`repro_torch.core.ecm.data_terms` / :func:`repro_torch.core.roofline
     .terms_arrays` (`ecm_terms`, `roofline_terms`); ``ecm_terms`` also
     lowers the paper's chip-level saturation model (§3.2) —
     ``P(n) = min(n·P(1), P_sat)`` and ``n_sat = ceil(T_ECM/T_mem)`` — so
     ``performance_at_cores`` / ``n_sat`` come out of the same batched call.

A plan accepts either a plain 1-D value array (single-symbol plans, the
original surface) or a mapping ``{symbol: per-point array}`` describing a
flattened N-dimensional grid; :func:`meshgrid_points` builds the flattened
C-order coordinates for a ``{symbol: axis values}`` spec plus an optional
``cores`` axis (always innermost).

Because LC traffic is piecewise-constant in the loop symbols *and* in the
core count (cores only rescale the effective shared-cache sizes), full
model results are too — the grid decomposes into Cartesian *regime cells*
of identical per-level LC outcome.  :meth:`regimes` (1-D) and
:meth:`regimes_grid` (N-D, flat indices) group points by that signature,
and the session evaluates the *symbolic* path once per cell and broadcasts
the identical frozen result object across it.  That keeps compiled sweeps
bit-for-bit ``to_dict``-identical to the per-point symbolic path; two
safety valves guarantee it even off the beaten track:

  * a per-point offset-ordering check (the distance expressions assume the
    template ordering; points whose numeric ordering differs — possible at
    very small sizes — fall back to per-point symbolic evaluation);
  * the symbolic volumes of each regime representative are compared
    against the plan's batched prediction; any mismatch demotes the whole
    regime to per-point evaluation (see ``AnalysisSession._sweep_compiled``).

Plans are cached by kernel *structure* (sweep symbols unbound) on the
:class:`~repro_torch.core.session.AnalysisSession`, alongside the existing
in-core/volume/result tiers.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence

import numpy as np
import sympy

from . import incore as _incore
from . import layer_conditions as _lc
from .identity import kernel_key
from .kernel_ir import LoopKernel
from .machine import Machine


class CompileError(ValueError):
    """The sweep cannot be lowered to a compiled plan (the caller should
    fall back to the per-point symbolic path, or surface this when the
    compiled path was explicitly requested)."""


@dataclasses.dataclass(frozen=True)
class _ArrayPlan:
    """Lowered ordering data for one array's accesses."""
    name: str
    key_fns: tuple          # per access (program order): numeric sort key fn
    write_rank: np.ndarray  # per access: 0 for writes, 1 for reads (tiebreak)
    template_perm: np.ndarray   # ordering used to derive the distance exprs


@dataclasses.dataclass(frozen=True)
class _EntryPlan:
    """One reuse-distance entry under the template ordering."""
    bytes_per_it: float     # element_bytes * inner step (traffic if miss)
    is_write: bool
    dist_fn: object         # numpy callable of the sweep symbols, or None (∞)
    fwd_fn: object          # forward distance, or None (∞)


def _lower(expr, syms: tuple, consts: dict):
    """Lower ``expr`` to a numpy callable of the sweep symbols, mirroring
    ``layer_conditions._numeric``: bound constants substituted, any other
    unbound symbol (loop variables, missing sizes) at the generic size."""
    e = sympy.sympify(expr).subs(consts)
    extra = e.free_symbols - set(syms)
    if extra:
        e = e.subs(_lc.generic_subs(extra))
    return sympy.lambdify(syms, e, modules="numpy")


def meshgrid_points(axes: Mapping[str, Sequence], cores=None):
    """Flattened C-order coordinates for an N-D grid spec.

    ``axes`` maps each sweep symbol to its axis values (insertion order =
    axis order); ``cores``, when a sequence, becomes one more (innermost)
    axis.  Returns ``(coords, cores_arr, shape)``: ``coords[symbol]`` is a
    flat float array per grid point, ``cores_arr`` is a flat int array (or
    ``int(cores)`` when scalar / None → 1), and ``shape`` is the full grid
    shape including the cores axis when present."""
    names = list(axes)
    vecs = [np.asarray(list(axes[n]), dtype=np.float64) for n in names]
    cores_axis = isinstance(cores, (Sequence, np.ndarray)) \
        and not isinstance(cores, (str, bytes))
    if cores_axis:
        vecs.append(np.asarray([int(c) for c in cores], dtype=np.float64))
    grids = np.meshgrid(*vecs, indexing="ij") if vecs else []
    shape = tuple(len(v) for v in vecs)
    coords = {n: g.ravel() for n, g in zip(names, grids)}
    if cores_axis:
        cores_arr = grids[-1].ravel().astype(np.int64)
    else:
        cores_arr = 1 if cores is None else int(cores)
    return coords, cores_arr, shape


class CompiledSweepPlan:
    """The lowered LC/ECM/Roofline pipeline for one kernel structure, one
    machine, and one ordered set of sweep symbols.  ``cores`` is a runtime
    axis: every evaluation method accepts a scalar core count or a
    per-point core array (defaulting to the ``cores`` the plan was built
    with)."""

    def __init__(self, kernel: LoopKernel, machine: Machine, symbol,
                 cores: int = 1, incore_result=None, incore: str = "simple"):
        if not isinstance(kernel, LoopKernel):
            raise CompileError(
                f"compiled sweeps need LoopKernel IR, got "
                f"{type(kernel).__name__}")
        symbols = (symbol,) if isinstance(symbol, str) else tuple(symbol)
        if not symbols:
            raise CompileError("compiled sweeps need at least one symbol")
        for s in symbols:
            if not str(s).isidentifier():
                raise CompileError(f"invalid sweep symbol {s!r}")
        if len(set(symbols)) != len(symbols):
            raise CompileError(f"duplicate sweep symbols in {symbols!r}")
        self.machine = machine
        self.symbols = tuple(str(s) for s in symbols)
        self.symbol = self.symbols[0]     # 1-D compatibility alias
        self.cores = int(cores)
        self.syms = tuple(sympy.Symbol(s) for s in self.symbols)
        self.sym = self.syms[0]
        # template: the swept constants unbound so distances stay symbolic
        # in the sweep symbols; containers are shared with the source kernel
        # so the structural-identity caches keep working.
        consts = {k: v for k, v in kernel.constants.items()
                  if k not in self.symbols}
        self.template = dataclasses.replace(kernel, constants=consts)
        self._consts = {sympy.Symbol(k): v for k, v in consts.items()}
        # in-core is structure-only: one result (precomputed by the
        # session's memoized tier, or derived here) serves the whole grid
        self.incore = incore_result if incore_result is not None else \
            _incore.analyze(self.template, machine, model=incore)
        self.unit = self.template.iterations_per_cacheline(
            machine.cacheline_bytes)
        self.levels = _lc.effective_level_sizes(machine, self.cores)
        self._build()

    # ------------------------------------------------------------------
    @property
    def template_key(self) -> tuple:
        return kernel_key(self.template)

    def _build(self) -> None:
        tmpl, syms = self.template, self.syms
        step = tmpl.inner_loop.step
        tmpl_subs = tmpl.subs()
        by_array: dict[str, list] = {}
        for acc in tmpl.accesses:
            by_array.setdefault(acc.array.name, []).append(acc)

        self.arrays: list[_ArrayPlan] = []
        self.entries: list[_EntryPlan] = []
        # candidate thresholds: 0 plus the distinct finite distances
        # (dedup by srepr, exactly like layer_conditions.thresholds)
        dedup: dict[str, sympy.Expr] = {}
        for name, accs in by_array.items():
            eb = accs[0].array.element_bytes
            offs = [sympy.expand(a.offset()) for a in accs]
            # template ordering: ascending numeric offset at the generic
            # size, writes first among equal offsets, stable — exactly the
            # sort in layer_conditions.sorted_offsets.
            perm = sorted(range(len(accs)),
                          key=lambda i: (_lc._numeric(offs[i], tmpl_subs),
                                         not accs[i].is_write, i))
            self.arrays.append(_ArrayPlan(
                name=name,
                key_fns=tuple(_lower(o, syms, self._consts) for o in offs),
                write_rank=np.array([0 if a.is_write else 1 for a in accs],
                                    dtype=np.int64),
                template_perm=np.array(perm, dtype=np.int64)))
            n = len(perm)
            for rank, i in enumerate(perm):
                acc = accs[i]
                back = (None if rank == n - 1 else
                        sympy.expand((offs[perm[rank + 1]] - offs[i]) * eb))
                fwd = (None if rank == 0 else
                       sympy.expand((offs[i] - offs[perm[rank - 1]]) * eb))
                if back is not None:
                    dedup.setdefault(sympy.srepr(back), back)
                self.entries.append(_EntryPlan(
                    bytes_per_it=float(eb * step), is_write=acc.is_write,
                    dist_fn=None if back is None else _lower(back, syms,
                                                             self._consts),
                    fwd_fn=None if fwd is None else _lower(fwd, syms,
                                                           self._consts)))
        self._threshold_fns = [_lower(sympy.Integer(0), syms, self._consts)]
        self._threshold_fns += [_lower(d, syms, self._consts)
                                for d in dedup.values()]

    # ------------------------------------------------------------------
    def _coords(self, values) -> tuple[np.ndarray, ...]:
        """Canonicalize a grid spec: a plain array (single-symbol plans)
        or a ``{symbol: per-point array}`` mapping → one float coordinate
        array per plan symbol, all the same shape."""
        if isinstance(values, Mapping):
            missing = [s for s in self.symbols if s not in values]
            extra = [s for s in values if s not in self.symbols]
            if missing or extra:
                raise CompileError(
                    f"grid symbols {sorted(values)} do not match plan "
                    f"symbols {list(self.symbols)}")
            coords = tuple(np.asarray(values[s], dtype=np.float64)
                           for s in self.symbols)
            shape = coords[0].shape
            if any(c.shape != shape for c in coords):
                raise CompileError("per-symbol coordinate arrays must "
                                   "share one shape (flattened grid)")
            return coords
        if len(self.symbols) != 1:
            raise CompileError(
                f"plan sweeps {list(self.symbols)}; pass a mapping "
                "{symbol: per-point array}")
        return (np.asarray(values, dtype=np.float64),)

    def _cores_per_point(self, cores, shape):
        """``cores`` as the evaluation sees it: an int (uniform grid) or a
        per-point int array broadcast to ``shape``."""
        if cores is None:
            return self.cores
        if np.ndim(cores) == 0:
            return int(cores)
        arr = np.broadcast_to(np.asarray(cores, dtype=np.int64), shape)
        return arr

    def level_sizes(self, cores=None) -> list[tuple[str, object]]:
        """Per-level effective sizes for a scalar or per-point core count —
        the vectorized mirror of ``layer_conditions.effective_level_sizes``
        (shared caches split evenly across the cores of a group)."""
        if cores is None or np.ndim(cores) == 0:
            c = self.cores if cores is None else int(cores)
            if c == self.cores:
                return self.levels
            return _lc.effective_level_sizes(self.machine, c)
        c = np.asarray(cores, dtype=np.float64)
        out = []
        for lv in self.machine.levels:
            size = float(lv.size_bytes)
            if lv.cores_per_group > 1:
                sizes = np.where(c > 1,
                                 size / np.minimum(c, lv.cores_per_group)
                                 * 1.0,
                                 size)
            else:
                sizes = np.full(c.shape, size)
            out.append((lv.name, sizes))
        return out

    def _eval(self, fn, coords) -> np.ndarray:
        out = np.asarray(fn(*coords), dtype=np.float64)
        return np.broadcast_to(out, coords[0].shape)

    # ------------------------------------------------------------------
    def validity(self, values) -> np.ndarray:
        """Per-point check that the numeric offset ordering matches the
        template ordering the distance expressions were derived under."""
        coords = self._coords(values)
        shape = coords[0].shape
        valid = np.ones(shape, dtype=bool)
        for ap in self.arrays:
            keys = np.stack([self._eval(f, coords) for f in ap.key_fns])
            n = keys.shape[0]
            idx = np.broadcast_to(np.arange(n)[:, None], keys.shape)
            ranks = np.broadcast_to(ap.write_rank[:, None], keys.shape)
            perm = np.lexsort((idx, ranks, keys), axis=0)
            valid &= (perm == ap.template_perm[:, None]).all(axis=0)
        return valid

    def lc_tables(self, values, cores=None) -> tuple[
            dict[str, dict[str, np.ndarray]], np.ndarray]:
        """Batched LC evaluation: for every grid point and machine level,
        the chosen threshold, required cache size, hits/misses/write-backs,
        and load/write-back traffic (bytes per inner iteration).

        ``values`` is a 1-D array (single-symbol plans) or a ``{symbol:
        per-point array}`` mapping; ``cores`` a scalar or per-point array
        (per-point effective cache sizes).  Returns ``(tables, valid)``
        where ``tables[level][field]`` is an array over the points and
        ``valid`` flags points whose offset ordering matches the compiled
        template (others need the symbolic path)."""
        coords = self._coords(values)
        shape = coords[0].shape
        valid = self.validity(values)

        ents = self.entries
        dist = np.stack([np.full(shape, np.inf)
                         if e.dist_fn is None else self._eval(e.dist_fn,
                                                              coords)
                         for e in ents]) if ents else np.zeros((0,) + shape)
        fwd = np.stack([np.full(shape, np.inf)
                        if e.fwd_fn is None else self._eval(e.fwd_fn, coords)
                        for e in ents]) if ents else np.zeros((0,) + shape)
        finite = np.isfinite(dist)
        bpe = np.array([e.bytes_per_it for e in ents])
        is_w = np.array([e.is_write for e in ents], dtype=bool)

        thresh = np.stack([self._eval(f, coords)
                           for f in self._threshold_fns])
        # C_req[j, v] = sum_i ( d_i <= t_j ? d_i : t_j )   (∞ entries add t)
        creq = np.where(dist[None, :, :] <= thresh[:, None, :],
                        dist[None, :, :], thresh[:, None, :]).sum(axis=1)

        tables: dict[str, dict[str, np.ndarray]] = {}
        for name, size in self.level_sizes(cores):
            sat = creq <= (size[None, :] if isinstance(size, np.ndarray)
                           else size)
            # largest satisfying threshold; C_req is monotone in t, so the
            # satisfying set is a prefix and max() matches the symbolic
            # "last in ascending order" choice.
            tn = np.where(sat, thresh, -np.inf).max(axis=0, initial=-np.inf)
            creq_best = np.where(sat, creq, -np.inf).max(axis=0,
                                                         initial=-np.inf)
            hit_mask = finite & (dist <= tn[None, :])
            hits = hit_mask.sum(axis=0)
            misses = len(ents) - hits
            miss_bytes = (bpe[:, None] * ~hit_mask).sum(axis=0)
            wb_mask = is_w[:, None] & ~(np.isfinite(fwd)
                                        & (fwd <= tn[None, :]))
            wb = wb_mask.sum(axis=0)
            evict_bytes = (bpe[:, None] * wb_mask).sum(axis=0)
            tables[name] = {
                "threshold": tn,
                "c_req": np.where(np.isfinite(creq_best), creq_best, np.inf),
                "hits": hits, "misses": misses, "writeback_lines": wb,
                "miss_bytes_per_it": miss_bytes,
                "evict_bytes_per_it": evict_bytes,
                "total_bytes_per_it": miss_bytes + evict_bytes,
            }
        return tables, valid

    def traffic(self, values, cores=None) -> tuple[dict[str, np.ndarray],
                                                   np.ndarray]:
        """Per-level β_k arrays (bytes per inner iteration) and the
        validity mask — the batched analog of
        :func:`~repro_torch.core.layer_conditions.volumes_per_level`."""
        tables, valid = self.lc_tables(values, cores=cores)
        return ({name: t["total_bytes_per_it"]
                 for name, t in tables.items()}, valid)

    # ------------------------------------------------------------------
    def ecm_terms(self, values, cores=None) -> dict:
        """Vectorized closed-form ECM over the grid: scalar ``t_ol`` /
        ``t_nol`` plus per-level contribution arrays, the ``t_ecm`` array
        (cycles per unit of work), and the chip-level saturation closed
        forms (paper §3.2) — ``t_mem``, ``n_sat = max(1, ceil(t_ecm /
        t_mem))``, the single-core / saturated performance arrays, and
        ``performance_at_cores = min(single·cores, sat)`` evaluated at the
        given (scalar or per-point) core counts.  Each array mirrors the
        corresponding :class:`~repro_torch.core.ecm.ECMResult` derivation
        bit-for-bit."""
        from . import ecm as _ecm
        coords = self._coords(values)
        shape = coords[0].shape
        cores_pp = self._cores_per_point(cores, shape)
        traffic, valid = self.traffic(values, cores=cores_pp)
        serial, overl = _ecm.data_terms(self.machine, traffic, self.unit)
        t_data = self.incore.t_nol + sum((c for _, c in serial),
                                         np.zeros(shape, dtype=np.float64))
        cand = [np.full_like(t_data, self.incore.t_ol), t_data,
                np.full_like(t_data, self.incore.t_latency)]
        cand += [np.broadcast_to(np.asarray(c, dtype=np.float64),
                                 t_data.shape) for _, c in overl]
        t_ecm = np.maximum.reduce(cand)
        transfers = list(serial) + list(overl)
        t_mem = (np.broadcast_to(np.asarray(transfers[-1][1],
                                            dtype=np.float64), shape)
                 if transfers else np.zeros(shape, dtype=np.float64))
        flops = float(self.incore.flops_per_unit)
        clock = float(self.machine.clock_hz)
        # ECMResult.saturation_cores: 1 where t_mem <= 0, else
        # max(1, ceil(t_ecm / t_mem)) — identical float ops, elementwise.
        mem_pos = t_mem > 0
        safe_mem = np.where(mem_pos, t_mem, 1.0)
        n_sat = np.where(mem_pos,
                         np.maximum(1.0, np.ceil(t_ecm / safe_mem)),
                         1.0).astype(np.int64)
        # ECMResult.performance_flops(cores): 0 when flops or t_ecm is 0,
        # else min(single·cores, sat) with sat = ∞ when t_mem <= 0.
        ecm_pos = t_ecm != 0
        single = np.where(ecm_pos,
                          flops / np.where(ecm_pos, t_ecm, 1.0) * clock, 0.0)
        sat = np.where(mem_pos, flops / safe_mem * clock, np.inf)
        perf = np.where(ecm_pos & (flops != 0),
                        np.minimum(single * np.asarray(cores_pp,
                                                       dtype=np.float64),
                                   sat),
                        0.0)
        return {"unit_iterations": self.unit, "t_ol": self.incore.t_ol,
                "t_nol": self.incore.t_nol,
                "contributions": serial, "overlapped": overl,
                "t_data": t_data, "t_ecm": t_ecm, "t_mem": t_mem,
                "flops_per_unit": flops, "clock_hz": clock,
                "cores": cores_pp, "n_sat": n_sat,
                "single_core_flops": single, "saturation_flops": sat,
                "performance_at_cores": perf,
                "valid": valid}

    def roofline_terms(self, values, variant: str = "IACA",
                       cores=None) -> dict:
        """Vectorized closed-form Roofline over the grid (see
        :func:`repro_torch.core.roofline.terms_arrays`).  Roofline's measured
        bandwidths are tabulated per core count, so ``cores`` must be a
        scalar here (the batched cores axis is an ECM concept)."""
        from . import roofline as _roofline
        if cores is not None and np.ndim(cores) != 0:
            raise CompileError(
                "roofline closed forms take a scalar core count; "
                "the batched cores axis applies to the ECM saturation "
                "model only")
        c = self.cores if cores is None else int(cores)
        traffic, valid = self.traffic(values, cores=c)
        out = _roofline.terms_arrays(self.template, self.machine, traffic,
                                     cores=c, variant=variant,
                                     incore_result=self.incore)
        out["valid"] = valid
        return out

    # ------------------------------------------------------------------
    def regimes(self, values) -> tuple[dict[tuple, list[int]], list[int]]:
        """Group integer grid values by identical per-level LC outcome.

        Returns ``(groups, fallback)``: ``groups`` maps a per-level
        signature ``((level, miss_bytes, evict_bytes, hits, misses), ...)``
        to the values in that regime (ascending); ``fallback`` lists values
        whose offset ordering diverges from the template and must take the
        per-point symbolic path."""
        vals = sorted({int(v) for v in np.asarray(values).tolist()})
        arr = np.array(vals, dtype=np.float64)
        groups_i, fallback_i = self.regimes_grid(arr)
        groups = {sig: [vals[i] for i in idxs]
                  for sig, idxs in groups_i.items()}
        return groups, [vals[i] for i in fallback_i]

    def regimes_grid(self, values, cores=None) -> tuple[
            dict[tuple, list[int]], list[int]]:
        """Group flattened grid points by identical per-level LC outcome.

        The N-D analog of :meth:`regimes`: ``values`` is a ``{symbol:
        per-point array}`` mapping (or a plain array for single-symbol
        plans) and ``cores`` a scalar or per-point array.  Returns
        ``(groups, fallback)`` over **flat point indices**; the signature
        is purely the LC traffic outcome (callers that evaluate a
        cores-sensitive model subdivide groups by the point's core
        count)."""
        tables, valid = self.lc_tables(values, cores=cores)
        npts = valid.size
        cols = []
        for name, t in tables.items():
            cols.append((name, t["miss_bytes_per_it"],
                         t["evict_bytes_per_it"], t["hits"], t["misses"]))
        groups: dict[tuple, list[int]] = {}
        fallback: list[int] = []
        for i in range(npts):
            if not valid[i]:
                fallback.append(i)
                continue
            sig = tuple((name, float(mb[i]), float(eb[i]),
                         int(h[i]), int(m[i]))
                        for name, mb, eb, h, m in cols)
            groups.setdefault(sig, []).append(i)
        return groups, fallback

    @staticmethod
    def signature_volumes(sig: tuple) -> dict[str, float]:
        """Per-level total traffic implied by a regime signature — compared
        against the symbolic path's volumes as an exactness guard."""
        return {name: miss + evict for name, miss, evict, _, _ in sig}


def compile_plan(kernel: LoopKernel, machine: Machine, symbol,
                 cores: int = 1, incore_result=None,
                 incore: str = "simple") -> CompiledSweepPlan:
    """Lower the LC/ECM/Roofline pipeline for ``kernel``'s structure once;
    ``symbol`` is one sweep symbol or an ordered sequence of them (N-D
    grids); see :class:`CompiledSweepPlan`."""
    return CompiledSweepPlan(kernel, machine, symbol, cores=cores,
                             incore_result=incore_result, incore=incore)
